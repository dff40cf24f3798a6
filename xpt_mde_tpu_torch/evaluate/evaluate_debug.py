"""Deep-inspection evaluation (port of ``xpt_mde_tpu.evaluate.evaluate_debug``):
per-frame losses, trajectories, worst-frame reconstruction dumps, and a
gt-vs-pred scale inspection mode.

- ``evaluate_for_debug`` (model-driven): the checkpointed model over a
  loader; per target frame the smoothness loss and depth AbsRel (and the
  GT-median depth scale), per source frame the photometric L1 loss of
  the view synthesized at full scale (the warp kernel on a card), the
  trajectory error (the predicted translation rescaled by the depth
  scale), the travel distance and the rotation error; writes
  ``debug_depth.csv``, ``debug_pose.csv`` and ``trajectory.csv``, and
  inspection views (target / synthesized with the GT pose / synthesized
  with the predicted pose / source / depth) of the worst N frames of each
  loss or metric. ``debug_by_plan`` runs it per test-plan row.
- ``inspect_batches``: per batch, the GT and predicted pose twists and the
  pose and depth scale ratios.
- ``evaluate_npz_debug``: the per-frame metric table and worst-frame dumps
  of saved predictions (no model).

The CSV layouts and the worst-frame choice are the JAX package's; cv2 is
imported only where a view is drawn.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from xpt_mde_tpu_torch.evaluate.depth_metrics import (DEPTH_METRIC_NAMES,
                                                      compute_depth_metrics,
                                                      valid_depth_filter)
from xpt_mde_tpu_torch.evaluate.pose_metrics import PoseMetric
from xpt_mde_tpu_torch.training.logger import to_numpy as _np
from xpt_mde_tpu_torch.utils.util_class import PathManager


def _rotation_error(pose_pred: np.ndarray, pose_true: np.ndarray):
    """Geodesic rotation error per source frame [batch, numsrc]."""
    rel = np.einsum("bnij,bnik->bnjk", pose_pred[..., :3, :3], pose_true[..., :3, :3])
    trace = np.trace(rel, axis1=-2, axis2=-1)
    return np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0))


def _per_batch_quantities(feats, preds, smooth_fn):
    """All debug quantities of one batch, as numpy. ``feats`` and ``preds``
    are tensors on one device; ``feats`` hold decoded images.

    :return: dict with smooth[B], abs_rel[B], scale[B], photo[B,N],
        synth[B,N,H,W,3], trj_err[B,N], distance[B,N], rot_err[B,N],
        xyz_true/pred [B,N,3]
    """
    from xpt_mde_tpu_torch.losses.photometric import photometric_loss_l1
    from xpt_mde_tpu_torch.ops.synthesize import synthesize_multi_scale
    from xpt_mde_tpu_torch.utils import se3
    from xpt_mde_tpu_torch.utils.precision import full_f32

    image5d = feats["image5d"]
    source, target = image5d[:, :-1], image5d[:, -1]
    depth0 = preds["depth_ms"][0].float()
    disp0 = preds["disp_ms"][0].float()
    batch = int(target.shape[0])

    with full_f32(), torch.no_grad():
        out = {"smooth": _np(smooth_fn(disp0, target))}

        # depth AbsRel and the GT-median scale per frame
        abs_rel = np.full(batch, np.nan)
        scale = np.ones(batch)
        if "depth_gt" in feats:
            depth_np = _np(depth0)
            for b in range(batch):
                gt = np.squeeze(_np(feats["depth_gt"][b]))
                if (gt > 1e-3).sum() < 10:
                    continue
                pred, gt_v, scaler = valid_depth_filter(depth_np[b], gt, return_scale=True)
                abs_rel[b] = compute_depth_metrics(pred, gt_v)[0]
                scale[b] = scaler
        out["abs_rel"], out["scale"] = abs_rel, scale

        # photometric loss per source at full scale
        synth = synthesize_multi_scale(source, feats["intrinsic"], [depth0],
                                       preds["pose"].float())[0]
        err = photometric_loss_l1(synth, target, reduce=False)
        out["photo"] = _np(torch.mean(err, dim=(2, 3, 4)))
        out["synth"] = _np(synth)

        if "pose_gt" in feats:
            pose_pred_mat = _np(se3.twist_to_matrix(preds["pose"].float()))
            pose_true_mat = _np(feats["pose_gt"])
            xyz_pred = pose_pred_mat[:, :, :3, 3]
            xyz_true = pose_true_mat[:, :, :3, 3]
            # the trajectory error with the depth-derived scale
            diff = xyz_true - xyz_pred * scale[:, None, None]
            out["trj_err"] = np.sqrt((diff ** 2).sum(axis=2))
            out["distance"] = np.sqrt((xyz_true ** 2).sum(axis=2))
            out["rot_err"] = _rotation_error(pose_pred_mat, pose_true_mat)
            out["xyz_true"] = xyz_true
            out["xyz_pred"] = xyz_pred * scale[:, None, None]
    return out


def evaluate_for_debug(model, loader, predict_step, debug_dir, worst_n: int = 5,
                       image_gradient_factor: float = 4.0):
    """Model-driven debug evaluation of ``model`` over ``loader``.

    :param model: the restored model (its device runs everything)
    :param loader: test/val loader yielding feature dicts
    :param predict_step: ``training.make_predict_step(model)``
    :return: {"depth_rows", "pose_rows", "worst"} tables
    """
    from xpt_mde_tpu_torch.losses.total import SmoothenessLossMultiScale
    from xpt_mde_tpu_torch.training.train_step import (decode_image_features,
                                                       features_to_device)

    smooth_fn = SmoothenessLossMultiScale(
        [1.0], image_gradient_factor=image_gradient_factor).smootheness_loss
    device = next(model.parameters()).device

    depth_rows, pose_rows, traj_rows = [], [], []
    frames_cache = []  # per frame: images, synthesis, depth, features, pose
    frame = 0
    for batch in loader:
        # uint8 loader images decoded once; everything below takes [-1, 1]
        feats = decode_image_features(features_to_device(batch, device))
        preds = predict_step(feats)
        q = _per_batch_quantities(feats, preds, smooth_fn)
        feats_np = {k: _np(v) for k, v in feats.items()}
        depth_np = _np(preds["depth_ms"][0])
        pose_np = _np(preds["pose"])
        batch_n, numsrc = q["photo"].shape
        zeros = np.zeros_like(q["photo"])
        for b in range(batch_n):
            depth_rows.append([frame, float(q["smooth"][b]), float(q["abs_rel"][b])])
            for s in range(numsrc):
                pose_rows.append([frame, s, float(q["photo"][b, s]),
                                  float(q.get("trj_err", zeros)[b, s]),
                                  float(q.get("distance", zeros)[b, s]),
                                  float(q.get("rot_err", zeros)[b, s])])
                if "xyz_true" in q:
                    traj_rows.append([frame, s, *q["xyz_true"][b, s], *q["xyz_pred"][b, s]])
            frames_cache.append({
                "target": feats_np["image5d"][b, -1],
                "source": feats_np["image5d"][b, 0],
                "synth": q["synth"][b, 0],
                "depth": depth_np[b],
                "feats": {k: v[b:b + 1] for k, v in feats_np.items()},
                "pose": pose_np[b:b + 1],
            })
            frame += 1

    debug_dir = Path(debug_dir)
    with PathManager(debug_dir) as pm:
        _write_csv(debug_dir / "debug_depth.csv", "frame,smooth_loss,depth_err", depth_rows)
        _write_csv(debug_dir / "debug_pose.csv",
                   "frame,srcidx,photo_loss,trj_err,distance,rot_err", pose_rows)
        _write_csv(debug_dir / "trajectory.csv",
                   "frame,srcidx,tx_gt,ty_gt,tz_gt,tx_pr,ty_pr,tz_pr", traj_rows)
        worst = _find_worst(depth_rows, pose_rows, worst_n)
        for key, frames in worst.items():
            _dump_inspection_views(frames_cache, frames, debug_dir / f"worst_{key}", device)
        pm.set_ok()
    return {"depth_rows": depth_rows, "pose_rows": pose_rows, "worst": worst}


def debug_by_plan(cfg, dataset_factory=None, device: torch.device | str = "cuda") -> None:
    """Per test-plan row: build the row's nets, load its checkpoint, run
    :func:`evaluate_for_debug` over the test split into
    ``datapath_evl/{ckpt_name}/debug_{dataset}_{suffix}``. Rows whose
    directory exists, or whose checkpoint has none of the row's nets, are
    skipped.

    :param device: the card by default; ``"cpu"`` where the caller asks
    """
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager
    from xpt_mde_tpu_torch.training.train_step import make_predict_step
    from xpt_mde_tpu_torch.training.trainer import default_dataset_factory, loader_keys

    dataset_factory = dataset_factory or default_dataset_factory(cfg)
    for stage in cfg.test_plan:
        debug_dir = (Path(cfg.datapath_evl) / stage.ckpt_name
                     / f"debug_{stage.dataset}_{stage.weight_suffix}")
        if debug_dir.exists():
            print(f"[debug_by_plan] exists, skip: {debug_dir}")
            continue
        loader = dataset_factory(stage.dataset, "test", cfg.batch_size)
        model = ModelFactory(loader_keys(loader), stage.net_names, cfg.depth_activation,
                             stereo=cfg.stereo, high_res=cfg.high_res,
                             compute_dtype=cfg.compute_dtype, device=device).get_model()
        ckpt = CheckpointManager(Path(cfg.datapath_ckp) / stage.ckpt_name)
        if not ckpt.restore_params(model, stage.weight_suffix):
            print(f"[debug_by_plan] no weights for {stage.ckpt_name}, skip")
            continue
        out = evaluate_for_debug(model, loader, make_predict_step(model), debug_dir)
        print(f"[debug_by_plan] {stage.ckpt_name}: {len(out['depth_rows'])} frames, worst "
              f"dumped for {list(out['worst'])}")


def _write_csv(path: Path, header: str, rows) -> None:
    int_cols = 2 if "srcidx" in header else 1
    lines = [header]
    for r in rows:
        lines.append(",".join(str(int(v)) if i < int_cols else f"{v:.6f}"
                              for i, v in enumerate(r)))
    path.write_text("\n".join(lines) + "\n")


def _find_worst(depth_rows, pose_rows, worst_n: int) -> dict:
    """The worst frames of each loss or metric, distinct, worst first."""
    worst = {}
    tables = {"smooth_loss": [(r[1], r[0]) for r in depth_rows],
              "depth_err": [(r[2], r[0]) for r in depth_rows],
              "photo_loss": [(r[2], r[0]) for r in pose_rows],
              "trj_err": [(r[3], r[0]) for r in pose_rows],
              "rot_err": [(r[5], r[0]) for r in pose_rows]}
    for key, scored in tables.items():
        scored = [(v, f) for v, f in scored if np.isfinite(v)]
        if not scored:
            continue
        scored.sort(reverse=True)
        seen, frames = set(), []
        for _, f in scored:
            if f not in seen:
                seen.add(f)
                frames.append(f)
            if len(frames) >= worst_n:
                break
        worst[key] = frames
    return worst


def _to_u8(img) -> np.ndarray:
    return ((np.clip(img, -1, 1) + 1) / 2 * 255).astype(np.uint8)


def _dump_inspection_views(frames_cache, frames, out_dir: Path,
                           device: torch.device | str = "cpu") -> None:
    """One 5-panel view per frame, stacked vertically: target /
    synthesized with the GT pose (where there is one) / synthesized with
    the predicted pose / source / depth."""
    try:
        import cv2
    except ImportError:
        return
    from xpt_mde_tpu_torch.ops.synthesize import synthesize_multi_scale
    from xpt_mde_tpu_torch.utils import se3
    from xpt_mde_tpu_torch.utils.precision import full_f32

    out_dir.mkdir(parents=True, exist_ok=True)
    for f in frames:
        entry = frames_cache[f]
        panels = [_to_u8(entry["target"])]
        feats = entry["feats"]
        if "pose_gt" in feats:
            def tensor(value):
                return torch.as_tensor(value).to(device, torch.float32)

            with full_f32(), torch.no_grad():
                gt_twist = se3.matrix_to_twist(tensor(feats["pose_gt"]))
                synth_gt = synthesize_multi_scale(tensor(feats["image5d"][:, :-1]),
                                                  tensor(feats["intrinsic"]),
                                                  [tensor(entry["depth"][None])], gt_twist)[0]
            panels.append(_to_u8(_np(synth_gt[0, 0])))
        panels.append(_to_u8(entry["synth"]))
        panels.append(_to_u8(entry["source"]))
        d8 = (np.clip(np.squeeze(entry["depth"]) / 80.0, 0, 1) * 255).astype(np.uint8)
        panels.append(cv2.applyColorMap(d8, cv2.COLORMAP_VIRIDIS))
        cv2.imwrite(str(out_dir / f"frame_{f:05d}.png"), np.concatenate(panels, axis=0))


def inspect_batches(model, loader, predict_step, max_batches: int = 3):
    """Per batch, print the GT and predicted pose twists and the pose and
    depth scale ratios of the first sample. :return: the printed rows"""
    from xpt_mde_tpu_torch.training.train_step import features_to_device
    from xpt_mde_tpu_torch.utils import se3
    from xpt_mde_tpu_torch.utils.precision import full_f32

    device = next(model.parameters()).device
    rows = []
    for i, batch in enumerate(loader):
        if i >= max_batches:
            break
        feats = features_to_device(batch, device)
        preds = predict_step(feats)
        row = {}
        if "pose_gt" in feats:
            with full_f32():
                gt_vec = _np(se3.matrix_to_twist(feats["pose_gt"].float()))
            pr_vec = _np(preds["pose"])
            xyz_t, xyz_p = gt_vec[:, :, :3], pr_vec[:, :, :3]
            scale = (xyz_t * xyz_p).sum(2) / np.maximum((xyz_p ** 2).sum(2), 1e-12)
            row["pose_gt"] = gt_vec[0, 0]
            row["pose_pr"] = pr_vec[0, 0]
            row["pose_scale"] = float(scale[0, 0])
            print(f"  pose gt: {gt_vec[0, 0]}")
            print(f"  pose pr: {pr_vec[0, 0]}")
            print(f"  pose scale: {row['pose_scale']:1.4f}")
        if "depth_gt" in feats:
            gt = _np(feats["depth_gt"])
            pr = _np(preds["depth_ms"][0])
            gt_mean = gt[gt > 1e-3].mean() if (gt > 1e-3).any() else np.nan
            pr_mean = pr.mean()
            row["depth_scale"] = float(gt_mean / pr_mean)
            print(f"  depth scale (gt/pred): {row['depth_scale']:1.4f} "
                  f"gt={gt_mean:1.3f} pred={pr_mean:1.3f}")
        rows.append(row)
    return rows


def evaluate_npz_debug(npz_path, debug_dir, worst_n: int = 10) -> dict:
    """The per-frame metric table (``debug_metrics.csv``) and the worst
    frames' dumps of saved predictions."""
    results = dict(np.load(npz_path))
    rows = per_frame_metrics(results)
    debug_dir = Path(debug_dir)
    with PathManager(debug_dir) as pm:
        keys = sorted({k for r in rows for k in r if k != "frame"})
        lines = ["frame," + ",".join(keys)]
        for r in rows:
            lines.append(str(r["frame"]) + "," +
                         ",".join(f"{r.get(k, float('nan')):.6f}" for k in keys))
        (debug_dir / "debug_metrics.csv").write_text("\n".join(lines) + "\n")

        worst = {}
        for key in ("abs_rel", "rmse", "trj_abs_err", "rot_err"):
            scored = [(r.get(key), r["frame"]) for r in rows
                      if key in r and np.isfinite(r.get(key, np.nan))]
            if not scored:
                continue
            scored.sort(reverse=True)
            worst[key] = [f for _, f in scored[:worst_n]]
            if "image" in results:
                _dump_frames(results, worst[key], debug_dir / f"worst_{key}")
        pm.set_ok()
    return {"rows": rows, "worst": worst}


def per_frame_metrics(results: dict, min_depth=1e-3, max_depth=80.0):
    """[N, ...] prediction arrays -> the per-frame metric table."""
    num = results["depth"].shape[0] if "depth" in results else results["pose"].shape[0]
    rows = []
    for i in range(num):
        row = {"frame": i}
        if "depth" in results and "depth_gt" in results:
            gt_i = np.squeeze(results["depth_gt"][i])
            if (gt_i > min_depth).sum() >= 10:
                pred, gt = valid_depth_filter(results["depth"][i], gt_i, min_depth, max_depth)
                row.update(dict(zip(DEPTH_METRIC_NAMES, compute_depth_metrics(pred, gt))))
        if "pose" in results and "pose_gt" in results:
            pm = PoseMetric().compute_pose_errors(results["pose"][i:i + 1],
                                                  results["pose_gt"][i:i + 1])
            row["trj_abs_err"] = float(pm.trj_abs_err.mean())
            row["trj_rel_err"] = float(pm.trj_rel_err.mean())
            row["rot_err"] = float(pm.rot_err.mean())
        rows.append(row)
    return rows


def _dump_frames(results: dict, frames, out_dir: Path) -> None:
    """Per frame: the image, the predicted and the GT depth, stacked."""
    try:
        import cv2
    except ImportError:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in frames:
        panels = [results["image"][f]]
        for key in ("depth", "depth_gt"):
            if key in results:
                d = np.squeeze(results[key][f])
                d8 = (np.clip(d / 80.0, 0, 1) * 255).astype(np.uint8)
                panels.append(cv2.applyColorMap(d8, cv2.COLORMAP_VIRIDIS))
        cv2.imwrite(str(out_dir / f"frame_{f:05d}.png"), np.concatenate(panels, axis=0))
