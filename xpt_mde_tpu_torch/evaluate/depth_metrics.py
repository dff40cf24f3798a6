"""Eigen-split depth evaluation (port of
``xpt_mde_tpu.evaluate.depth_metrics``, copied so the port needs no JAX).

Valid-range mask (1e-3, 80), the Garg/Eigen crop
[0.40810811H..0.99189189H, 0.03594771W..0.96405229W], GT-median scaling,
clipping, and the 7 standard metrics (AbsRel, SqRel, RMSE, RMSE log,
delta < 1.25^{1,2,3}). Host-side numpy on saved predictions.
"""

from __future__ import annotations

import numpy as np

DEPTH_METRIC_NAMES = ["abs_rel", "sq_rel", "rmse", "rmse_log",
                      "a1", "a2", "a3"]


def valid_depth_filter(depth_pred: np.ndarray, depth_true: np.ndarray,
                       min_depth: float = 1e-3, max_depth: float = 80.0,
                       return_scale: bool = False):
    """Filter one frame's depths to the valid Garg-cropped pixels, with
    GT-median scaling applied to the prediction.

    :param depth_pred: [height, width] (any singleton dims are squeezed)
    :param depth_true: [height, width]
    :param return_scale: also return the GT-median scaler
    :return: (depth_pred[N], depth_true[N][, scaler])
    """
    depth_pred = np.squeeze(np.array(depth_pred, dtype=np.float64))
    depth_true = np.squeeze(np.array(depth_true, dtype=np.float64))
    mask = np.logical_and(depth_true > min_depth, depth_true < max_depth)
    # crop used by Garg ECCV16 to reproduce Eigen NIPS14 results
    gt_height, gt_width = depth_true.shape
    crop = np.array([0.40810811 * gt_height, 0.99189189 * gt_height,
                     0.03594771 * gt_width, 0.96405229 * gt_width]).astype(np.int32)
    crop_mask = np.zeros(mask.shape)
    crop_mask[crop[0]:crop[1], crop[2]:crop[3]] = 1
    mask = np.logical_and(mask, crop_mask)
    scaler = np.median(depth_true[mask]) / np.median(depth_pred[mask])
    # np.array(...) above already copied: the in-place scale below can't
    # touch the caller's array
    depth_pred[mask] *= scaler
    depth_pred = np.clip(depth_pred, min_depth, max_depth)
    if return_scale:
        return depth_pred[mask], depth_true[mask], scaler
    return depth_pred[mask], depth_true[mask]


def compute_depth_metrics(pred: np.ndarray, gt: np.ndarray) -> list[float]:
    """The 7 Eigen metrics over flat valid-pixel arrays."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25 ** 2).mean()
    a3 = (thresh < 1.25 ** 3).mean()

    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = np.mean(np.abs(gt - pred) / gt)
    sq_rel = np.mean(((gt - pred) ** 2) / gt)
    return [abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3]
