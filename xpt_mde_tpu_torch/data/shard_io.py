"""Sharded example storage: fixed-record binary shards + a JSON schema
(port of ``xpt_mde_tpu.data.shard_io``, copied so the port needs no JAX).

The shards the reference's ``ShardMaker`` writes are read here unchanged,
and shards written here read there: the same record layout (keys in
sorted order, each a raw C-order array), the same ``MAGIC`` header, the
same ``shard_config.json``, the same shuffle order per (seed, epoch).

- Every example of a dataset has the same schema and fixed shapes, so a
  shard is a concatenation of fixed-size records: O(1) seek, mmap reads.
- ``shard_config.json`` beside the shards holds the ordered keys -> dtype
  + shape and the example count.
- The writer infers the schema from the first example and enforces it
  on the rest, aborting after 10 mismatches; it rotates to a new shard
  file every ``frames_per_shard`` examples.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Mapping, Sequence

import numpy as np

from xpt_mde_tpu_torch.utils.util_class import WrongInputError

MAGIC = b"VREC1\n"
CONFIG_NAME = "shard_config.json"


class SchemaError(WrongInputError):
    pass


def _schema_from_example(example: Mapping[str, np.ndarray]) -> dict:
    schema = {}
    for key in sorted(example.keys()):
        arr = np.asarray(example[key])
        schema[key] = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
    return schema


def _record_nbytes(schema: Mapping) -> int:
    total = 0
    for spec in schema.values():
        total += int(np.dtype(spec["dtype"]).itemsize * np.prod(spec["shape"], dtype=np.int64))
    return int(total)


class ShardWriter:
    """Writes one drive/split's examples into rotating fixed-record shards.

    Usage:
        with ShardWriter(outdir, frames_per_shard=2000) as w:
            for ex in examples: w.write(ex)
        # w.count, w.schema available after
    """

    def __init__(self, outdir, frames_per_shard: int = 2000,
                 max_schema_errors: int = 10):
        self.outdir = Path(outdir)
        self.frames_per_shard = frames_per_shard
        self.max_schema_errors = max_schema_errors
        self.schema: dict | None = None
        self.count = 0
        self.errors = 0
        self._shard_idx = -1
        self._shard_count = 0
        self._fh = None

    def __enter__(self):
        self.outdir.mkdir(parents=True, exist_ok=True)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False

    def _rotate(self):
        if self._fh:
            self._fh.close()
        self._shard_idx += 1
        self._shard_count = 0
        path = self.outdir / f"shard_{self._shard_idx:05d}.vrec"
        self._fh = open(path, "wb")
        self._fh.write(MAGIC)

    def verify_example(self, example: Mapping[str, np.ndarray]) -> bool:
        """Schema enforcement with strike-out."""
        actual = _schema_from_example(example)
        if self.schema is None:
            self.schema = actual
            return True
        if actual != self.schema:
            self.errors += 1
            print(f"[ShardWriter] schema mismatch #{self.errors}: "
                  f"{actual} != {self.schema}")
            if self.errors > self.max_schema_errors:
                raise SchemaError("too many schema mismatches, aborting")
            return False
        return True

    def write(self, example: Mapping[str, np.ndarray]):
        if not self.verify_example(example):
            return
        if self._fh is None or self._shard_count >= self.frames_per_shard:
            self._rotate()
        for key in sorted(self.schema.keys()):
            arr = np.ascontiguousarray(example[key],
                                       dtype=np.dtype(self.schema[key]["dtype"]))
            self._fh.write(arr.tobytes())
        self._shard_count += 1
        self.count += 1

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def write_config(self, extra: Mapping | None = None):
        config = {"schema": self.schema, "length": self.count}
        if extra:
            config.update(extra)
        with open(self.outdir / CONFIG_NAME, "w") as fh:
            json.dump(config, fh, indent=2)


def merge_drive_dirs(drive_dirs: Sequence[Path], dest: Path):
    """Flatten per-drive shard dirs into ``dest``, renaming shards and
    summing lengths."""
    dest = Path(dest)
    dest.mkdir(parents=True, exist_ok=True)
    total = 0
    schema = None
    out_idx = 0
    merged_cfg = {}
    for d in drive_dirs:
        d = Path(d)
        cfg = json.loads((d / CONFIG_NAME).read_text())
        if schema is None:
            schema = cfg["schema"]
            merged_cfg = dict(cfg)
        elif cfg["schema"] != schema:
            raise SchemaError(f"schema mismatch across drives: {d}")
        total += cfg["length"]
        for shard in sorted(d.glob("shard_*.vrec")):
            shard.rename(dest / f"shard_{out_idx:05d}.vrec")
            out_idx += 1
        (d / CONFIG_NAME).unlink()
        d.rmdir()
    merged_cfg["length"] = total
    merged_cfg["schema"] = schema
    with open(dest / CONFIG_NAME, "w") as fh:
        json.dump(merged_cfg, fh, indent=2)


class ShardDataset:
    """Reads a shard dir: mmap-backed random access + batched iteration.

    Produces the feature dict the training loop expects: uint8 images
    decoded to float [-1, 1] with stacked ``image5d`` views.
    """

    def __init__(self, shard_dir):
        self.shard_dir = Path(shard_dir)
        cfg = json.loads((self.shard_dir / CONFIG_NAME).read_text())
        self.config = cfg
        self.schema = cfg["schema"]
        self.length = cfg["length"]
        self.record_nbytes = _record_nbytes(self.schema)
        self._shards = []
        offset = 0
        for path in sorted(self.shard_dir.glob("shard_*.vrec")):
            mm = np.memmap(path, dtype=np.uint8, mode="r", offset=len(MAGIC))
            n = len(mm) // self.record_nbytes
            self._shards.append((offset, n, mm))
            offset += n
        if offset != self.length:
            raise WrongInputError(
                f"shard records {offset} != config length {self.length}")

    def __len__(self):
        return self.length

    def keys(self):
        return list(self.schema.keys())

    def read_example(self, idx: int) -> dict:
        for offset, n, mm in self._shards:
            if idx < offset + n:
                rec = mm[(idx - offset) * self.record_nbytes:
                         (idx - offset + 1) * self.record_nbytes]
                return self._parse(rec)
        raise IndexError(idx)

    def _parse(self, rec: np.ndarray) -> dict:
        out = {}
        pos = 0
        for key in sorted(self.schema.keys()):
            spec = self.schema[key]
            dt = np.dtype(spec["dtype"])
            nbytes = int(dt.itemsize * np.prod(spec["shape"], dtype=np.int64))
            out[key] = np.frombuffer(rec[pos:pos + nbytes].tobytes(), dtype=dt) \
                .reshape(spec["shape"])
            pos += nbytes
        return out


def _microbatch_share(order: np.ndarray, rank: int, world: int, batch: int,
                      microbatches: int) -> np.ndarray:
    """Process ``rank``'s rows, step after step, of the global batches that
    the ``world`` processes' strided slices of ``order`` make side by side:
    its share of each global microbatch (``parallel.sharding.rank_rows``)."""
    from xpt_mde_tpu_torch.parallel.sharding import rank_rows

    shares = [order[q::world] for q in range(world)]
    steps = min(len(share) for share in shares) // batch
    if steps == 0:
        return order[:0]
    global_batches = np.stack([np.concatenate([share[i * batch: (i + 1) * batch]
                                               for share in shares]) for i in range(steps)])
    return global_batches[:, rank_rows(batch * world, world, rank, microbatches)].reshape(-1)


class DatasetLoader:
    """Batched loader with shuffle/repeat/drop-remainder and host->device
    friendly output (float images in [-1, 1], image5d views).

    The snippet image is stored as [S*H, W, 3] uint8 (a vertical stack,
    target last); this loader reshapes it to the 5D view.
    """

    kind = "numpy"

    def __init__(self, dataset: ShardDataset, batch_size: int,
                 snippet_len: int = 5, shuffle: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 raw_images: bool = False, microbatches: int = 1):
        """``batch_size`` is the per-process batch. With several processes
        set (process_index, process_count) so each reads a disjoint slice
        of the same shuffled order. The global batch is the processes'
        batches side by side; with ``microbatches`` = k > 1 (a step that
        accumulates k microbatches) each process reads instead its share
        of each of that global batch's k contiguous microbatches
        (``parallel.sharding.rank_rows``), so its i-th microbatch is its
        share of the global i-th.

        ``raw_images`` yields ``image5d*`` as uint8 (decode happens on
        device in the train/eval/predict steps -- exact same math, 4x
        less host work and transfer)."""
        self.ds = dataset
        self.batch_size = batch_size
        self.snippet_len = snippet_len
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.raw_images = raw_images
        self.microbatches = microbatches

    @property
    def steps_per_epoch(self) -> int:
        return len(self.ds) // (self.batch_size * self.process_count)

    def _format_batch(self, batch: dict) -> dict:
        """Stacked per-key arrays -> feature views (the ONE place that
        shapes batches; the native loader shares it). Images may arrive
        uint8 (raw mode / storage) or already-decoded float32 (the C++
        reader's decode)."""
        feats = {}
        for key, val in batch.items():
            if key.startswith("image"):
                sfx = key[5:]  # "", "_R"
                # same formula as the native (C++) and on-device decodes:
                # u * (2/255) - 1 -- bit-identical across all three paths
                img = val if (self.raw_images or val.dtype != np.uint8) \
                    else val.astype(np.float32) * (2.0 / 255.0) - 1.0
                b, sh, w, c = img.shape
                s = self.snippet_len
                feats["image5d" + sfx] = img.reshape(b, s, sh // s, w, c)
            elif key.startswith("depth_gt"):
                feats[key] = val[..., None] if val.ndim == 3 else val
            else:
                feats[key] = val
        return feats

    def _to_features(self, examples: list[dict]) -> dict:
        return self._format_batch({k: np.stack([ex[k] for ex in examples])
                                   for k in examples[0].keys()})

    def example_batch(self) -> dict:
        """One deterministic batch (dataset indices 0..B-1) for model
        init / logger recon samples: no epoch is consumed and no shuffle
        order advanced (iterating instead would silently skip the first
        epoch's order and, under PrefetchLoader, leak its producer)."""
        idxs = range(min(self.batch_size, len(self.ds)))
        return self._to_features([self.ds.read_example(i) for i in idxs])

    def _epoch_order(self) -> np.ndarray:
        """Shuffled per-epoch order, sliced to this process's share."""
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        self.epoch += 1
        if self.process_count > 1 and self.microbatches > 1:
            return _microbatch_share(order, self.process_index, self.process_count,
                                     self.batch_size, self.microbatches)
        if self.process_count > 1:
            order = order[self.process_index::self.process_count]
        return order

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def iter_from(self, start_step: int) -> Iterator[dict]:
        """Iterate this epoch from batch ``start_step`` WITHOUT reading
        the skipped examples (mid-epoch preemption resume: the epoch
        order is a pure function of (seed, epoch), so skipping is just
        slicing it)."""
        order = self._epoch_order()
        for start in range(start_step * self.batch_size,
                           self.steps_per_epoch * self.batch_size,
                           self.batch_size):
            idxs = order[start:start + self.batch_size]
            yield self._to_features([self.ds.read_example(i) for i in idxs])
