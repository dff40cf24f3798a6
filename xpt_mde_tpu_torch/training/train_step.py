"""Predict and eval steps (port of the inference part of
``xpt_mde_tpu.training.train_step``).

The port has no TrainState: the module carries its weights and BatchNorm
statistics, so ``make_*_step`` takes the module and the step takes the
features (a dict of tensors on the module's device). Both steps run the
module in eval mode (BN running statistics) under ``inference_mode`` and
in full float32 (TF32 off), and restore the module's mode afterwards.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping

import torch

from xpt_mde_tpu_torch.training import metrics as tm
from xpt_mde_tpu_torch.utils.precision import full_f32

# the loaders' host decode, u * 2/255 - 1
_IMG_DECODE_SCALE = 2.0 / 255.0


def decode_image_features(features: Mapping[str, torch.Tensor]) -> dict:
    """uint8 ``image5d*`` entries -> float32 [-1, 1]; floats pass through."""
    out = dict(features)
    for key, value in features.items():
        if key.startswith("image5d") and value.dtype == torch.uint8:
            out[key] = value.to(torch.float32) * _IMG_DECODE_SCALE - 1.0
    return out


def _compute_metrics(preds, features, loss, loss_by_type) -> dict:
    metrics = {"loss": loss}
    metrics.update({f"loss/{k}": v for k, v in loss_by_type.items()})
    if "depth_ms" in preds and "depth_gt" in features:
        d = preds["depth_ms"][0]
        metrics["depth_abs_rel"] = torch.mean(tm.depth_abs_rel(d, features["depth_gt"]))
        # centre-region mean depth magnitude
        h, w = d.shape[1:3]
        metrics["depth_center_mean"] = torch.mean(
            d[:, h // 4: h * 3 // 4, w // 4: w * 3 // 4])
    if "pose" in preds and "pose_gt" in features:
        metrics.update(tm.pose_metrics(preds["pose"], features["pose_gt"]))
    return metrics


@contextlib.contextmanager
def _inference(model: torch.nn.Module):
    was_training = model.training
    model.eval()
    try:
        with full_f32(), torch.inference_mode():
            yield
    finally:
        model.train(was_training)


def make_eval_step(model: torch.nn.Module, total_loss) -> Callable:
    """Validation step: forward + loss + metrics, no update."""

    def eval_step(features: Mapping[str, torch.Tensor]) -> dict:
        with _inference(model):
            features = decode_image_features(features)
            preds = model(features)
            loss, loss_by_type = total_loss(preds, features)
            return _compute_metrics(preds, features, loss, loss_by_type)

    return eval_step


def make_predict_step(model: torch.nn.Module) -> Callable:
    """Inference step returning the full prediction dict."""

    def predict_step(features: Mapping[str, torch.Tensor]) -> dict:
        with _inference(model):
            return model(decode_image_features(features))

    return predict_step
