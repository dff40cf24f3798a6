"""The miniature TRAINING_PLAN_28 (port of ``xpt_mde_tpu.training.mini_plan``):
the proof that the multi-stage plan learns.

The published plan pre-trains the rigid nets, then the flownet, then
fine-tunes all three with the flownet restored from the flow row's
checkpoint and frozen. This module shrinks that mechanic onto the
GT-bearing synthetic worlds (``data/synthetic.py``, ``varying_depth``): a
3-row plan whose net groups change across rows, driven by the real
``train_by_plan``, with held-out depth and pose metrics from the real
prediction and evaluation stack (``predict_dataset``, the Eigen depth
metrics, the snippet pose errors).

The depth activation is ``"Exponential"``: it starts near 10 m, inside
the worlds' 5-20 m, where InverseSigmoid starts near 2 m and rails to its
extremes on this tiny world before structure emerges.

Every helper that builds a model takes a ``device`` (the card by
default; ``"cpu"`` where the caller asks). ``tools/check_learns.py``
runs the plan on the card.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from xpt_mde_tpu_torch.config import LOSS_FLOW, SCALE_WEIGHT_T1, Config, TrainStage

RIGID_NETS = {"depth": "DepthNetBasic", "camera": "PoseNetBasic"}
FLOW_NETS = {"flow": "PWCNet"}
JOINT_NETS = {**RIGID_NETS, **FLOW_NETS}

RECIPE_RIGID = {"L1": 0.5, "SSIM": 0.5, "smoothe": 0.5}
RECIPE_FLOW = {"flowL2": LOSS_FLOW["flowL2"], "flow_reg": LOSS_FLOW["flow_reg"]}
RECIPE_JOINT = {"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 0.5}
# the published MS recipe's stereo weighting (stereoL1 = 1 - SSIM_RATIO)
RECIPE_STEREO = {"L1": 0.5, "SSIM": 0.5, "smoothe": 0.5,
                 "L1_R": 0.5, "SSIM_R": 0.5, "smoothe_R": 0.5,
                 "stereoL1": 0.5, "stereoSSIM": 0.5, "stereoPose": 1.0}

# the rigid rows train at 32x64; flow and joint need PWC-Net's minimum
# 64x128 (6 stride-2 pyramid levels)
RIGID_SIZE = (32, 64)
FLOW_SIZE = (64, 128)

# the Garg crop, as fractions of (H, H, W, W)
_GARG_CROP = (0.40810811, 0.99189189, 0.03594771, 0.96405229)


def miniature_plan(rigid_epochs: int, flow_epochs: int, joint_epochs: int,
                   lr: float = 3e-4) -> list[TrainStage]:
    """Rigid rows, a flow row, then joint rows whose flownet comes from the
    flow row's checkpoint and stays frozen; the later rows step the
    learning rate down as the published plan does."""
    sw = SCALE_WEIGHT_T1
    return [
        TrainStage(RIGID_NETS, "synthetic_small", rigid_epochs, lr, RECIPE_RIGID, sw, True),
        TrainStage(FLOW_NETS, "synthetic", flow_epochs, lr * 0.3, RECIPE_FLOW, sw, True),
        TrainStage(JOINT_NETS, "synthetic", joint_epochs, lr * 0.1, RECIPE_JOINT, sw, True),
    ]


def make_config(datapath, plan, batch: int = 4, **overrides) -> Config:
    """The plan's Config: monocular, float32, no augmentation, the
    Exponential activation; ``overrides`` reach the Config directly
    (``compute_dtype="bfloat16"``, ``stereo=True``, ...)."""
    kwargs = dict(stereo=False, per_replica_batch=batch, compute_dtype="float32",
                  augment_probs={}, depth_activation="Exponential",
                  datapath=str(datapath), ckpt_name="mini_plan", training_plan=plan)
    kwargs.update(overrides)
    return Config(**kwargs)


def synthetic_factory(train_batches: int = 6, val_batches: int = 2, stereo: bool = False,
                      **world):
    """``dataset_factory`` for ``train_by_plan`` over the GT-bearing world
    (``varying_depth``, ``vary_motion``); the val split renders other
    textures and motions (seed 99). ``world`` reaches SyntheticDataset."""
    from xpt_mde_tpu_torch.data import SyntheticDataset

    def factory(dataset_name: str, split: str, batch_size: int):
        train = split == "train"
        h, w = RIGID_SIZE if dataset_name == "synthetic_small" else FLOW_SIZE
        return SyntheticDataset(batch_size=batch_size, height=h, width=w,
                                num_batches=train_batches if train else val_batches,
                                varying_depth=True, vary_motion=True, stereo=stereo,
                                seed=0 if train else 99, **world)
    return factory


def planar_factory(train_batches: int = 6, val_batches: int = 2, yaw_deg: float = 1.0,
                   depth_min: float = 5.0, depth_max: float = 20.0, step_m: float = 0.4):
    """``dataset_factory`` over the tilted-plane SE(3) world: the camera's
    yaw puts rotation into ``pose_gt``, and the depth range is set."""
    from xpt_mde_tpu_torch.data import PlanarSceneDataset

    def factory(dataset_name: str, split: str, batch_size: int):
        train = split == "train"
        h, w = RIGID_SIZE if dataset_name == "synthetic_small" else FLOW_SIZE
        return PlanarSceneDataset(batch_size=batch_size, height=h, width=w,
                                  num_batches=train_batches if train else val_batches,
                                  depth_min=depth_min, depth_max=depth_max, step_m=step_m,
                                  yaw_deg=yaw_deg, vary_motion=True, seed=0 if train else 99)
    return factory


def _model(cfg: Config, nets, val_data, stereo: bool, restore: bool, device):
    """The nets built on ``device`` (seed 0), with the plan's "latest"
    weights where ``restore``; raises if there are none."""
    from xpt_mde_tpu_torch.models import ModelFactory
    from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager

    model = ModelFactory(val_data.config_keys(), nets, cfg.depth_activation, stereo=stereo,
                         compute_dtype=cfg.compute_dtype, device=device).get_model()
    if restore:
        ckpt_dir = Path(cfg.datapath_ckp) / cfg.ckpt_name
        if not CheckpointManager(ckpt_dir).restore_params(model):
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return model


def evaluate_checkpoint(cfg: Config, nets, val_data, restore: bool = True,
                        return_results: bool = False, device="cuda") -> dict:
    """Held-out depth (AbsRel, RMSE, a1) and pose (trajectory absolute and
    relative error, rotation error) metrics of the plan's "latest"
    checkpoint, or of the untrained init where ``restore`` is False."""
    from xpt_mde_tpu_torch.evaluate.evaluate_main import (evaluate_depth_results,
                                                          evaluate_pose_results,
                                                          predict_dataset)
    from xpt_mde_tpu_torch.training.train_step import make_predict_step

    model = _model(cfg, nets, val_data, cfg.stereo, restore, device)
    results = predict_dataset(model, val_data, make_predict_step(model))
    depth = evaluate_depth_results(results).mean(axis=0)
    out = {"abs_rel": float(depth[0]), "rmse": float(depth[2]), "a1": float(depth[4])}
    if "pose" in results:
        pose = evaluate_pose_results(results).mean(axis=0)
        out.update({"trj_abs_err": float(pose[0]), "trj_rel_err": float(pose[1]),
                    "rot_err": float(pose[2])})
    if return_results:
        out["_results"] = results  # the raw predictions, for other analyses
    return out


def evaluate_flow_epe(cfg: Config, val_data, restore: bool = True, device="cuda") -> float:
    """Mean end-point error of the finest predicted flow against the
    world's analytic flow. A diagnostic, not a criterion: photometric flow
    training on this low-texture world is ill-posed with respect to the
    true flow (the net also fits interpolation and border artifacts).

    Target pixel (u, v) finds its match in source i at u - fx o_i / d(v)
    (pure x motion over the row-banded relief) and the losses sample at
    grid - flow, so the true flow is (fx o_i / d(v), 0), with o_i from
    ``pose_gt`` and d from ``depth_gt``; ``flow_ms[0]`` is at 1/4
    resolution, so coordinates and flow scale by 1/4."""
    from xpt_mde_tpu_torch.training.train_step import features_to_device, make_predict_step

    model = _model(cfg, FLOW_NETS, val_data, False, restore, device)
    predict = make_predict_step(model)
    device = next(model.parameters()).device
    epes = []
    for batch in val_data:
        flow = predict(features_to_device(batch, device))["flow_ms"][0].cpu().numpy()
        fx = float(batch["intrinsic"][0, 0, 0]) / 4.0
        offsets = -batch["pose_gt"][:, :, 0, 3]                             # [B, N]
        depth_rows = batch["depth_gt"][:, ::4, 0, 0]                        # [B, h]
        gt_u = fx * offsets[:, :, None] / depth_rows[:, None, :]           # [B, N, h]
        err_u = flow[..., 0] - gt_u[..., None]
        epes.append(np.mean(np.sqrt(err_u ** 2 + flow[..., 1] ** 2)))
    return float(np.mean(epes))


def _garg_crop(height: int, width: int):
    crop = np.array([_GARG_CROP[0] * height, _GARG_CROP[1] * height,
                     _GARG_CROP[2] * width, _GARG_CROP[3] * width], np.int32)
    return np.s_[crop[0]:crop[1], crop[2]:crop[3]]


def band_abs_rel(results: dict, r0: int, r1: int) -> dict:
    """Moving-band against static-rest depth error inside the Garg crop,
    with the GT-median scaler anchored on the static rows (monocular depth
    is scale-free, so a full-image scaler would anchor inside a biased
    band and blame the intact rest).

    Keys: ``band`` and ``rest`` (AbsRel, rest-anchored) and ``ratio``, the
    scale-free median(pred/gt) of the band over that of the rest: the
    rigid trap's analytic value is 1 / (1 - r), an intact net reads ~1."""
    band_vals, rest_vals, ratios = [], [], []
    for i in range(results["depth"].shape[0]):
        pred = np.squeeze(np.array(results["depth"][i], np.float64))
        gt = np.squeeze(np.array(results["depth_gt"][i], np.float64))
        in_crop = np.zeros_like(gt, bool)
        in_crop[_garg_crop(*gt.shape)] = True
        in_band = np.zeros_like(gt, bool)
        in_band[r0:r1] = True
        band_m, rest_m = in_crop & in_band, in_crop & ~in_band
        rel_band = np.median(pred[band_m] / gt[band_m])
        rel_rest = np.median(pred[rest_m] / gt[rest_m])
        ratios.append(rel_band / rel_rest)
        scaler = 1.0 / rel_rest  # the static-anchored GT-median scale
        scaled = np.clip(pred * scaler, 1e-3, 80.0)
        abs_rel = np.abs(gt - scaled) / gt
        band_vals.append(abs_rel[band_m].mean())
        rest_vals.append(abs_rel[rest_m].mean())
    return {"band": float(np.mean(band_vals)), "rest": float(np.mean(rest_vals)),
            "ratio": float(np.mean(ratios))}


def unscaled_abs_rel(results: dict) -> float:
    """AbsRel inside the Garg crop WITHOUT GT-median scaling: small only
    when the predicted depth is metric, as stereo supervision makes it."""
    vals = []
    for i in range(results["depth"].shape[0]):
        pred = np.squeeze(np.array(results["depth"][i], np.float64))
        gt = np.squeeze(np.array(results["depth_gt"][i], np.float64))
        sl = _garg_crop(*gt.shape)
        vals.append(np.mean(np.abs(gt[sl] - pred[sl]) / gt[sl]))
    return float(np.mean(vals))


def evaluate_stereo_extrinsic(cfg: Config, nets, val_data, restore: bool = True,
                              device="cuda") -> dict:
    """Mean error of the predicted left->right twist (``pose_LR``) against
    the extrinsic's: ``trans_err`` in metres, ``rot_err`` in radians."""
    from xpt_mde_tpu_torch.training.train_step import features_to_device, make_predict_step
    from xpt_mde_tpu_torch.utils import se3
    from xpt_mde_tpu_torch.utils.precision import full_f32

    model = _model(cfg, nets, val_data, True, restore, device)
    predict = make_predict_step(model)
    device = next(model.parameters()).device
    trans, rot = [], []
    for batch in val_data:
        pose_lr = predict(features_to_device(batch, device))["pose_LR"].cpu().numpy()
        with full_f32():
            gt = se3.matrix_to_twist(torch.from_numpy(batch["stereo_T_LR"][:, None])).numpy()
        trans.append(np.abs(pose_lr[..., :3] - gt[..., :3]).mean())
        rot.append(np.abs(pose_lr[..., 3:] - gt[..., 3:]).mean())
    return {"trans_err": float(np.mean(trans)), "rot_err": float(np.mean(rot))}


def net_checkpoint_weights(cfg: Config, net: str, suffix: str) -> dict:
    """One per-net checkpoint file's tensors ({net}_{suffix}.pt), on the
    CPU: weights and BatchNorm buffers alike. Compare two with
    :func:`same_weights`, tensor by tensor (the JAX package compares the
    msgpack files' bytes; a torch file's bytes are no such proof)."""
    path = Path(cfg.datapath_ckp) / cfg.ckpt_name / f"{net}_{suffix}.pt"
    return torch.load(path, map_location="cpu", weights_only=True)


def same_weights(a: dict, b: dict) -> bool:
    """Exact equality of two state dicts: the same keys, and every tensor
    the same dtype, shape and bits."""
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)
