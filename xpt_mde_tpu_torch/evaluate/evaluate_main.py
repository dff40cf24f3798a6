"""Prediction and evaluation drivers (port of
``xpt_mde_tpu.evaluate.evaluate_main``).

- ``predict_by_plan``: per ``Config.test_plan`` row, build the row's nets,
  load its checkpoint, run the predict step over the test split and save
  {image, depth, intrinsic, depth_gt, pose, pose_gt} under
  ``datapath_prd/{ckpt_name}/{dataset}_{suffix}.npz``, or as a part
  series past the host-memory budget;
- ``evaluate_by_plan``: per row, Eigen depth metrics and snippet pose
  errors of the saved predictions, per-frame csv files and a summary
  under ``datapath_evl``, merged into ``merged_result.csv``.

The npz keys and the chunk/part layout are the JAX package's, so either
package's evaluator reads either package's predictions.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from xpt_mde_tpu_torch.config import Config
from xpt_mde_tpu_torch.evaluate.depth_metrics import (DEPTH_METRIC_NAMES,
                                                      compute_depth_metrics,
                                                      valid_depth_filter)
from xpt_mde_tpu_torch.evaluate.pose_metrics import PoseMetric
from xpt_mde_tpu_torch.utils.util_class import PathManager


def _predict_batches(model, loader, predict_step):
    """Per batch, the arrays that go into the npz (the target image as
    uint8, the finest depth, the pose and their ground truths)."""
    from xpt_mde_tpu_torch.training.train_step import (decode_image_features,
                                                       features_to_device)

    device = next(model.parameters()).device
    for features in loader:
        feats = decode_image_features(features_to_device(features, device))
        preds = predict_step(feats)
        out = {}
        image = feats["image5d"][:, -1].cpu().numpy()
        out["image"] = ((np.clip(image, -1, 1) + 1) / 2 * 255).astype(np.uint8)
        if "depth_ms" in preds:
            out["depth"] = preds["depth_ms"][0].cpu().numpy()
            out["intrinsic"] = feats["intrinsic"].cpu().numpy()
            if "depth_gt" in feats:
                out["depth_gt"] = feats["depth_gt"].cpu().numpy()
        if "pose" in preds:
            out["pose"] = preds["pose"].cpu().numpy()
            if "pose_gt" in feats:
                out["pose_gt"] = feats["pose_gt"].cpu().numpy()
        yield out


def predict_dataset(model, loader, predict_step) -> dict:
    """Predictions over a whole loader, concatenated."""
    outputs: dict[str, list] = {}
    for out in _predict_batches(model, loader, predict_step):
        for key, value in out.items():
            outputs.setdefault(key, []).append(value)
    return {k: np.concatenate(v, axis=0) for k, v in outputs.items() if v}


def save_predictions(results: dict, pred_dir, name: str) -> None:
    """np.savez into a transactional directory."""
    pred_dir = Path(pred_dir)
    with PathManager(pred_dir) as pm:
        np.savez(pred_dir / f"{name}.npz", **results)
        pm.set_ok()
    print(f"[save_predictions] saved {pred_dir / (name + '.npz')}")


def predict_dataset_chunked(model, loader, predict_step, pred_dir, name: str,
                            flush_bytes: int, write: bool = True) -> list:
    """``predict_dataset`` within a host-memory budget: predictions flush
    to ``{name}.part{K}.npz`` whenever they exceed ``flush_bytes``; a split
    that fits one chunk is one ``{name}.npz``. A part series is complete
    only once its ``{name}.parts.json`` marker (the part count) exists,
    written last; without it the series reads as absent.

    ``write=False`` runs the steps and writes nothing: a spatial mesh's
    ranks but the main one.

    :return: the written paths (the marker last for a part series)
    """
    if not write:
        for _ in _predict_batches(model, loader, predict_step):
            pass
        return []
    pred_dir = Path(pred_dir)
    outputs: dict[str, list] = {}
    written: list = []

    def held_bytes():
        return sum(a.nbytes for vals in outputs.values() for a in vals)

    def flush(final: bool):
        if not outputs:
            return
        chunk = {k: np.concatenate(v, axis=0) for k, v in outputs.items()}
        outputs.clear()
        if final and not written:
            save_predictions(chunk, pred_dir, name)
            written.append(pred_dir / f"{name}.npz")
        else:
            part = pred_dir / f"{name}.part{len(written)}.npz"
            with PathManager(pred_dir) as pm:
                np.savez(part, **chunk)
                pm.set_ok()
            written.append(part)
            print(f"[predict_dataset_chunked] flushed {part}")

    for out in _predict_batches(model, loader, predict_step):
        for key, value in out.items():
            outputs.setdefault(key, []).append(value)
        if held_bytes() >= flush_bytes:
            flush(final=False)
    flush(final=True)
    if written and written[0].name.endswith(".part0.npz"):
        marker = _parts_marker(pred_dir / f"{name}.npz")
        tmp = marker.parent / (marker.name + ".tmp")
        tmp.write_text(json.dumps({"parts": len(written)}))
        tmp.replace(marker)  # the marker appears last
        written.append(marker)
    return written


def _parts_marker(npz_path) -> Path:
    """Completion marker of a ``{name}.part{K}.npz`` series."""
    path = Path(npz_path)
    return path.parent / (path.stem + ".parts.json")


def _complete_parts(npz_path) -> list:
    """The part files of a complete series (marker present, count
    matching), else []."""
    path = Path(npz_path)
    marker = _parts_marker(path)
    if not marker.exists():
        return []
    parts = sorted(path.parent.glob(path.stem + ".part*.npz"),
                   key=lambda p: int(p.suffixes[-2][5:]))
    expected = json.loads(marker.read_text())["parts"]
    if len(parts) != expected:
        raise FileNotFoundError(f"corrupt prediction series {path}: marker promises "
                                f"{expected} parts, found {len(parts)}")
    return parts


def prediction_parts(npz_path):
    """Yield the prediction dicts of a saved split, ``name.npz`` or a
    complete ``name.part{K}.npz`` series, one chunk in memory at a time."""
    path = Path(npz_path)
    if path.exists():
        yield dict(np.load(path))
        return
    parts = _complete_parts(path)
    if not parts:
        raise FileNotFoundError(npz_path)
    for part in parts:
        yield dict(np.load(part))


def has_predictions(npz_path) -> bool:
    """True for a plain npz or a complete part series."""
    path = Path(npz_path)
    return path.exists() or bool(_complete_parts(path))


def evaluate_depth_results(results: dict, min_depth=1e-3, max_depth=80.0):
    """Per-frame Eigen metrics -> [N, 7]; frames with fewer than 10 valid
    GT pixels are skipped."""
    depth_pred = results["depth"]
    depth_gt = results["depth_gt"]
    rows = []
    for i in range(depth_pred.shape[0]):
        gt_i = np.squeeze(depth_gt[i])
        if (gt_i > min_depth).sum() < 10:
            continue
        pred, gt = valid_depth_filter(depth_pred[i], gt_i, min_depth, max_depth)
        rows.append(compute_depth_metrics(pred, gt))
    return np.array(rows)


def evaluate_pose_results(results: dict):
    """Snippet pose errors -> [N, 3] (trj_abs, trj_rel, rot)."""
    metric = PoseMetric().compute_pose_errors(results["pose"], results["pose_gt"])
    return np.stack([metric.trj_abs_err.mean(axis=1),
                     metric.trj_rel_err.mean(axis=1),
                     metric.rot_err.mean(axis=1)], axis=1)


def evaluate_npz(npz_path, eval_dir, name: str) -> dict:
    """Evaluate one saved prediction split (plain npz or part series),
    one chunk at a time. :return: the summary {metric: mean}"""
    eval_dir = Path(eval_dir)
    summary = {}
    depth_chunks, pose_chunks = [], []
    for results in prediction_parts(npz_path):
        if "depth" in results and "depth_gt" in results:
            depth_chunks.append(evaluate_depth_results(results))
        if "pose" in results and "pose_gt" in results:
            pose_chunks.append(evaluate_pose_results(results))
    with PathManager(eval_dir) as pm:
        if depth_chunks:
            depth_rows = np.concatenate(depth_chunks, axis=0)
            np.savetxt(eval_dir / f"depth_eval_{name}.csv", depth_rows, delimiter=",",
                       header=",".join(DEPTH_METRIC_NAMES), comments="")
            summary.update(dict(zip(DEPTH_METRIC_NAMES, depth_rows.mean(axis=0))))
        if pose_chunks:
            pose_rows = np.concatenate(pose_chunks, axis=0)
            np.savetxt(eval_dir / f"pose_eval_{name}.csv", pose_rows, delimiter=",",
                       header="trj_abs_err,trj_rel_err,rot_err", comments="")
            summary.update({"trj_abs_err": pose_rows[:, 0].mean(),
                            "trj_rel_err": pose_rows[:, 1].mean(),
                            "rot_err": pose_rows[:, 2].mean()})
        lines = ["metric,value"] + [f"{k},{v}" for k, v in summary.items()]
        (eval_dir / f"summary_{name}.csv").write_text("\n".join(lines) + "\n")
        pm.set_ok()
    return summary


def merge_eval_results(evl_root) -> Path:
    """Collect every summary csv into merged_result.csv."""
    evl_root = Path(evl_root)
    rows = []
    for summary in sorted(evl_root.glob("*/summary_*.csv")):
        name = summary.parent.name + "/" + summary.stem
        for line in summary.read_text().splitlines()[1:]:
            metric, value = line.split(",")
            rows.append(f"{name},{metric},{value}")
    out = evl_root / "merged_result.csv"
    out.write_text("name,metric,value\n" + "\n".join(rows) + "\n")
    return out


def predict_by_plan(cfg: Config, dataset_factory=None,
                    device: torch.device | str = "cuda", mesh=None) -> None:
    """Walk the test plan: build the row's nets, load the checkpoint,
    predict the test split, save the npz. Rows whose predictions exist,
    or whose checkpoint has none of the row's nets, are skipped.

    :param device: the card by default; ``"cpu"`` where the caller asks
    :param mesh: a mesh with a ``spatial`` axis, which every one of its
        ranks passes: each predicts the whole split on its bands of the
        image rows, and the main process writes the gathered predictions
    """
    from xpt_mde_tpu_torch.parallel import is_main_process
    from xpt_mde_tpu_torch.parallel.sharding import make_parallel_predict_step
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager
    from xpt_mde_tpu_torch.training.train_step import make_predict_step
    from xpt_mde_tpu_torch.training.trainer import default_dataset_factory, loader_keys

    dataset_factory = dataset_factory or default_dataset_factory(cfg)
    for stage in cfg.test_plan:
        out_dir = Path(cfg.datapath_prd) / stage.ckpt_name
        out_file = out_dir / f"{stage.dataset}_{stage.weight_suffix}.npz"
        if has_predictions(out_file):
            print(f"[predict_by_plan] exists, skip: {out_file}")
            continue
        loader = dataset_factory(stage.dataset, "test", cfg.batch_size)
        # the factory's default upsampling ("nearest"), whatever
        # Config.depth_upsample_interp says, as the JAX predict_by_plan builds it
        model = ModelFactory(loader_keys(loader), stage.net_names, cfg.depth_activation,
                             stereo=cfg.stereo, high_res=cfg.high_res,
                             compute_dtype=cfg.compute_dtype, device=device).get_model()
        ckpt = CheckpointManager(Path(cfg.datapath_ckp) / stage.ckpt_name)
        if not ckpt.restore_params(model, stage.weight_suffix):
            print(f"[predict_by_plan] no weights for {stage.ckpt_name}, skip")
            continue
        predict_step = make_predict_step(model) if mesh is None \
            else make_parallel_predict_step(model, mesh)
        predict_dataset_chunked(model, loader, predict_step, out_dir,
                                f"{stage.dataset}_{stage.weight_suffix}",
                                flush_bytes=cfg.predict_flush_mb * 1024 * 1024,
                                write=mesh is None or is_main_process())


def evaluate_by_plan(cfg: Config) -> None:
    """Walk the test plan over the saved predictions."""
    for stage in cfg.test_plan:
        npz = (Path(cfg.datapath_prd) / stage.ckpt_name
               / f"{stage.dataset}_{stage.weight_suffix}.npz")
        if not has_predictions(npz):
            print(f"[evaluate_by_plan] no predictions: {npz}")
            continue
        eval_dir = Path(cfg.datapath_evl) / stage.ckpt_name
        if (eval_dir / f"summary_{stage.dataset}_{stage.weight_suffix}.csv").exists():
            print(f"[evaluate_by_plan] exists, skip: {eval_dir}")
            continue
        summary = evaluate_npz(npz, eval_dir, f"{stage.dataset}_{stage.weight_suffix}")
        print(f"[evaluate_by_plan] {stage.ckpt_name}: {summary}")
    merge_eval_results(cfg.datapath_evl)
