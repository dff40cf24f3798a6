"""In-step metrics: depth AbsRel and snippet pose errors (port of
``xpt_mde_tpu.training.metrics``). They stay on the device; the caller
decides when to read them."""

from __future__ import annotations

import torch

from xpt_mde_tpu_torch.utils import se3


def snippet_pose_from_first(poses: torch.Tensor) -> torch.Tensor:
    """Insert the identity target pose at snippet index 2 and rebase every
    pose to the first frame: [B, N, 4, 4] -> [B, N+1, 4, 4]."""
    batch = poses.shape[0]
    eye = torch.eye(4, dtype=poses.dtype, device=poses.device).expand(batch, 1, 4, 4)
    poses_mat = torch.cat([poses[:, :2], eye, poses[:, 2:]], dim=1)
    origin_inv = se3.invert_matrix(poses_mat[:, 0:1])
    return torch.matmul(origin_inv, poses_mat)


def trajectory_error(pose_pred_mat, pose_true_mat, abs_scale: bool) -> torch.Tensor:
    """Snippet trajectory error in metres [B, snippet - 1]."""
    xyz_pred = pose_pred_mat[:, :, :3, 3]
    xyz_true = pose_true_mat[:, :, :3, 3]
    if abs_scale:
        err = xyz_true - xyz_pred
    else:
        denom = torch.clamp(torch.sum(xyz_pred ** 2, dim=2), min=1e-12)
        scale = torch.sum(xyz_true * xyz_pred, dim=2) / denom
        err = xyz_true - xyz_pred * scale[..., None]
    err = torch.sqrt(torch.sum(err ** 2, dim=2))
    return err[:, 1:]


def rotational_error(pose_pred_mat, pose_true_mat) -> torch.Tensor:
    """Geodesic rotation error in rad [B, snippet - 1]."""
    rot_pred = pose_pred_mat[:, :, :3, :3]
    rot_true = pose_true_mat[:, :, :3, :3]
    rel = torch.matmul(rot_pred.transpose(-1, -2), rot_true)
    trace = torch.diagonal(rel, dim1=-2, dim2=-1).sum(-1)
    angle = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    return angle[:, 1:]


def pose_metrics(pose_pred_twist: torch.Tensor,
                 pose_true_mat: torch.Tensor) -> dict:
    """Mean snippet trajectory / rotation errors."""
    pred_mat = snippet_pose_from_first(se3.twist_to_matrix(pose_pred_twist))
    true_mat = snippet_pose_from_first(pose_true_mat)
    return {
        "trj_err": torch.mean(trajectory_error(pred_mat, true_mat, True)),
        "trj_rel_err": torch.mean(trajectory_error(pred_mat, true_mat, False)),
        "rot_err": torch.mean(rotational_error(pred_mat, true_mat)),
    }


def depth_abs_rel(depth_pred: torch.Tensor, depth_gt: torch.Tensor,
                  min_depth: float = 1e-3, max_depth: float = 80.0) -> torch.Tensor:
    """Per-example AbsRel over valid GT pixels, scaled by the mean GT/pred
    ratio (exact median scaling is the offline evaluator's)."""
    pred = depth_pred.squeeze(-1)
    gt = depth_gt.squeeze(-1)
    vf = ((gt > min_depth) & (gt < max_depth)).to(pred.dtype)
    n = torch.clamp(torch.sum(vf, dim=(1, 2)), min=1.0)
    scale = (torch.sum(gt * vf, dim=(1, 2)) / n) / \
        torch.clamp(torch.sum(pred * vf, dim=(1, 2)) / n, min=1e-6)
    pred = torch.clamp(pred * scale[:, None, None], min_depth, max_depth)
    rel = torch.abs(gt - pred) / torch.clamp(gt, min=min_depth)
    return torch.sum(rel * vf, dim=(1, 2)) / n
