"""Dataset -> shard conversion (port of
``xpt_mde_tpu.data.shard_maker``; its shards equal the JAX package's byte
for byte, ``tests/test_torch_shard_chain.py``). Host code: it imports
numpy and this package's numpy modules, never torch, and for the
synthetic dataset neither OpenCV nor PIL.

- per (dataset, split): skip if the output dir already exists;
- atomic build under "<name>__tmp", renamed on success, removed on
  failure (``PathManager``);
- per drive: the ``ExampleMaker`` loop with ``RecoverableSkip`` frames and
  the writer's 10-strike schema abort; per-drive dirs merged in drive
  order, lengths summed;
- drives build serially, or over a ``spawn`` process pool
  (``shard_build_workers``): the caller may hold a CUDA context, which a
  forked child must not inherit, and the workers import no torch. Where
  the pool fails the drives build serially again, and ``build_mode`` says
  so;
- validation split: ``validation_frames`` examples sampled from the test
  (preferred) or train shards into "<dataset>_val";
- ``frames_per_drive`` / ``total_frame_limit`` cap the examples per drive
  and in all.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.config import Config
from xpt_mde_tpu_torch.data.example_maker import ExampleMaker
from xpt_mde_tpu_torch.data.shard_io import ShardDataset, ShardWriter, merge_drive_dirs
from xpt_mde_tpu_torch.utils.util_class import PathManager, RecoverableSkip

DEFAULT_DATA_KEYS = {
    "kitti_raw": ["image", "intrinsic", "depth_gt", "pose_gt", "image_R",
                  "intrinsic_R", "stereo_T_LR"],
    "kitti_odom": ["image", "intrinsic", "pose_gt", "image_R", "intrinsic_R",
                   "stereo_T_LR"],
    "cityscapes": ["image", "intrinsic", "depth_gt", "image_R", "intrinsic_R",
                   "stereo_T_LR"],
    "waymo": ["image", "intrinsic", "depth_gt", "pose_gt"],
    "a2d2": ["image", "intrinsic", "depth_gt"],
    "driving_stereo": ["image", "intrinsic", "depth_gt", "image_R",
                       "intrinsic_R", "stereo_T_LR"],
    "synthetic": ["image", "intrinsic", "depth_gt", "pose_gt"],
}

# modules a shard-build worker reports when they are loaded in it
WATCHED_MODULES = ("torch", "cv2", "PIL", "jax")


def _build_one_drive(dataset, split, shwc, data_keys, raw_data_path,
                     frames_per_drive, frames_per_shard, extra_config,
                     drive, drive_dir):
    """Convert ONE drive into its own shard dir; the unit of work for
    both the serial loop and the process pool (shared so the two paths
    cannot drift). Returns (count, error_message_or_None)."""
    maker = ExampleMaker(dataset, split, shwc, data_keys, raw_data_path)
    try:
        maker.init_reader(drive)
    except Exception as e:
        return 0, f"drive init failed {drive}: {e}"
    with ShardWriter(Path(drive_dir), frames_per_shard) as writer:
        for f_idx, frame_idx in enumerate(maker.get_range()):
            if frames_per_drive and f_idx >= frames_per_drive:
                break
            try:
                writer.write(maker.get_example(frame_idx))
            except RecoverableSkip:
                continue
            except StopIteration:
                break
        writer.write_config({"dataset": dataset, "split": split,
                             "imshape": list(shwc), "drive": str(drive),
                             **extra_config})
    return writer.count, None


def _build_one_drive_in_worker(args):
    """The pool's unit: (count, error, the WATCHED_MODULES loaded in this
    worker)."""
    count, error = _build_one_drive(*args)
    return count, error, [m for m in WATCHED_MODULES if m in sys.modules]


class ShardMaker:
    def __init__(self, cfg: Config, dataset: str, split: str,
                 raw_data_path, data_keys=None,
                 frames_per_drive: int = 0, total_frame_limit: int = 0,
                 drives=None, workers: int = None):
        self.cfg = cfg
        self.dataset = dataset
        self.split = split
        self.raw_data_path = raw_data_path
        self.data_keys = data_keys or DEFAULT_DATA_KEYS[dataset]
        self.frames_per_drive = frames_per_drive
        self.total_frame_limit = total_frame_limit
        self.drives = drives  # explicit drive list overrides the reader's
        # drives are independent shard dirs, so they build in parallel;
        # total_frame_limit needs the serial early stop
        self.workers = cfg.shard_build_workers if workers is None else workers
        if total_frame_limit:
            self.workers = 0
        hw = cfg.image_sizes[dataset]
        self.shwc = (cfg.snippet_len, hw[0], hw[1], 3)
        # how make() built: "serial", "pool", "serial: <why not the pool>"
        # or "skipped" (the output existed); and the WATCHED_MODULES loaded
        # in any pool worker
        self.build_mode = None
        self.worker_modules: set = set()

    @property
    def out_dir(self) -> Path:
        return Path(self.cfg.datapath_shd) / f"{self.dataset}_{self.split}"

    def make(self) -> Path:
        if self.out_dir.exists():
            print(f"[ShardMaker] exists, skip: {self.out_dir}")
            self.build_mode = "skipped"
            return self.out_dir
        tmp_dir = self.out_dir.parent / (self.out_dir.name + "__tmp")
        with PathManager(tmp_dir) as pm:
            drives = self.drives if self.drives is not None else \
                self._list_drives()
            results = self._build_drives(tmp_dir, drives)
            total_count = 0
            drive_dirs = []
            for drive_dir, count, error in results:  # d_idx order
                if error is not None:
                    print(f"[ShardMaker] {error}")
                if count > 0:
                    drive_dirs.append(drive_dir)
                    total_count += count
                else:
                    shutil.rmtree(drive_dir, ignore_errors=True)
                if self.total_frame_limit and \
                        total_count >= self.total_frame_limit:
                    break
            if not drive_dirs:
                raise RuntimeError(f"no examples produced for "
                                   f"{self.dataset}_{self.split}")
            merge_drive_dirs(drive_dirs, tmp_dir)
            pm.set_ok()
        tmp_dir.rename(self.out_dir)
        print(f"[ShardMaker] built {self.out_dir}: {total_count} examples "
              f"({self.build_mode})")
        return self.out_dir

    def _build_serially(self, args, mode="serial") -> list:
        self.build_mode = mode
        return [(Path(a[-1]), *_build_one_drive(*a)) for a in args]

    def _build_drives(self, tmp_dir: Path, drives) -> list:
        """[(drive_dir, count, error)] in drive order -- serially, or
        over a spawn process pool (workers > 1): every drive is an
        independent output dir, so the built bytes are identical either
        way."""
        args = [(self.dataset, self.split, self.shwc, self.data_keys,
                 self.raw_data_path, self.frames_per_drive,
                 self.cfg.frames_per_shard, {},
                 drive, str(tmp_dir / f"drive_{d_idx:04d}"))
                for d_idx, drive in enumerate(drives)]
        if self.workers <= 1 or len(args) <= 1:
            if self.total_frame_limit:
                # serial early stop: don't convert drives past the limit
                self.build_mode = "serial"
                results = []
                total = 0
                for a in args:
                    count, error = _build_one_drive(*a)
                    results.append((Path(a[-1]), count, error))
                    total += count
                    if total >= self.total_frame_limit:
                        break
                return results
            return self._build_serially(args)
        import __main__
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        # spawn re-imports __main__; from a REPL or stdin there is no file
        # to re-import, so build serially there (fork is no alternative:
        # the parent may hold a CUDA context, which a child must not
        # inherit)
        main_file = getattr(__main__, "__file__", None)
        if main_file is not None and not Path(main_file).exists():
            print("[ShardMaker] interactive __main__; building serially")
            return self._build_serially(args, "serial: interactive __main__")
        try:
            with ProcessPoolExecutor(
                    max_workers=min(self.workers, len(args)),
                    mp_context=mp.get_context("spawn")) as pool:
                outcomes = list(pool.map(_build_one_drive_in_worker, args))
        except Exception as e:
            print(f"[ShardMaker] process pool failed ({e}); "
                  "rebuilding serially")
            for a in args:  # drop partial worker output
                shutil.rmtree(a[-1], ignore_errors=True)
            return self._build_serially(args, f"serial: the process pool failed ({e})")
        self.build_mode = "pool"
        for _, _, loaded in outcomes:
            self.worker_modules.update(loaded)
        return [(Path(a[-1]), count, error)
                for a, (count, error, _) in zip(args, outcomes)]

    def _list_drives(self):
        from xpt_mde_tpu_torch.data.readers import data_reader_factory
        reader = data_reader_factory(self.dataset, self.split,
                                     self.raw_data_path)
        return reader.list_drive_paths()


def generate_validation_shards(cfg: Config, dataset: str) -> Path:
    """Sample cfg.validation_frames examples from the test (preferred) or
    train shards into <dataset>_val."""
    out_dir = Path(cfg.datapath_shd) / f"{dataset}_val"
    if out_dir.exists():
        print(f"[validation] exists, skip: {out_dir}")
        return out_dir
    src_dir = None
    for split in ("test", "train"):
        cand = Path(cfg.datapath_shd) / f"{dataset}_{split}"
        if cand.exists():
            src_dir = cand
            break
    if src_dir is None:
        raise FileNotFoundError(f"no shards to sample val from for {dataset}")

    src = ShardDataset(src_dir)
    num = min(cfg.validation_frames, len(src))
    rng = np.random.RandomState(0)
    indices = rng.choice(len(src), num, replace=False)
    tmp_dir = out_dir.parent / (out_dir.name + "__tmp")
    with PathManager(tmp_dir) as pm:
        with ShardWriter(tmp_dir, cfg.frames_per_shard) as writer:
            for idx in sorted(indices):
                writer.write(src.read_example(int(idx)))
            writer.write_config({"dataset": dataset, "split": "val",
                                 "sampled_from": src_dir.name})
        pm.set_ok()
    tmp_dir.rename(out_dir)
    print(f"[validation] built {out_dir}: {num} examples")
    return out_dir


def convert_to_shards(cfg: Config, raw_data_paths: dict,
                      datasets_to_prepare: dict | None = None,
                      frames_per_drive: int = 0,
                      total_frame_limit: int = 0) -> dict:
    """The conversion main: each dataset's splits (``["train"]`` where
    ``datasets_to_prepare`` does not say), then its validation split.
    Returns ``{"<dataset>_<split>": build_mode}`` of the splits built."""
    datasets = datasets_to_prepare or {
        name: ["train"] for name in raw_data_paths}
    modes = {}
    for dataset, splits in datasets.items():
        for split in splits:
            maker = ShardMaker(cfg, dataset, split, raw_data_paths[dataset],
                               frames_per_drive=frames_per_drive,
                               total_frame_limit=total_frame_limit)
            maker.make()
            modes[maker.out_dir.name] = maker.build_mode
        generate_validation_shards(cfg, dataset)
    return modes
