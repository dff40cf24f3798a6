"""Snippet pose / odometry evaluation (port of
``xpt_mde_tpu.evaluate.pose_metrics``, copied so the port needs no JAX).

Rebase the 5-frame snippet to its first frame (identity target inserted
at index 2), then absolute and scale-aligned trajectory errors and the
geodesic rotation error. ``twist_to_matrix_np`` is a copy of
``xpt_mde_tpu.utils.se3.twist_to_matrix_np``.
"""

from __future__ import annotations

import numpy as np

_SMALL_ANGLE = 1e-8


def twist_to_matrix_np(twist: np.ndarray) -> np.ndarray:
    """[..., 6] twists (tx, ty, tz, axis-angle) -> [..., 4, 4] matrices,
    in numpy (float64-capable); the same convention as
    ``utils.se3.twist_to_matrix``."""
    twist = np.asarray(twist)
    dtype = twist.dtype if twist.dtype.kind == "f" else np.float64
    trans = twist[..., :3].astype(dtype)
    uvec = twist[..., 3:].astype(dtype)
    theta = np.linalg.norm(uvec, axis=-1, keepdims=True)
    safe = np.where(theta < _SMALL_ANGLE, 1.0, theta)
    w1, w2, w3 = np.moveaxis(uvec / safe, -1, 0)
    z = np.zeros_like(w1)
    k = np.stack([np.stack([z, w3, -w2], -1),
                  np.stack([-w3, z, w1], -1),
                  np.stack([w2, -w1, z], -1)], -2)
    th = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=dtype), k.shape)
    rot = eye + k * np.sin(th) + (k @ k) * (1.0 - np.cos(th))
    rot = np.where(th < _SMALL_ANGLE, eye, rot)
    out = np.zeros(twist.shape[:-1] + (4, 4), dtype)
    out[..., :3, :3] = rot
    out[..., :3, 3] = trans
    out[..., 3, 3] = 1.0
    return out


class PoseMetric:
    """Computes per-snippet trajectory/rotation errors over a batch."""

    def __init__(self):
        self.trj_abs_err = np.array([])
        self.trj_rel_err = np.array([])
        self.rot_err = np.array([])

    def compute_pose_errors(self, pose_pred, pose_true_mat):
        """
        :param pose_pred: predicted twists [batch, numsrc, 6]
        :param pose_true_mat: GT matrices [batch, numsrc, 4, 4]
        """
        pose_pred = np.asarray(pose_pred, dtype=np.float32)
        pose_true_mat = np.asarray(pose_true_mat, dtype=np.float32)
        pred_mat = twist_to_matrix_np(pose_pred)
        pred_mat = self.snippet_pose_from_first(pred_mat)
        true_mat = self.snippet_pose_from_first(pose_true_mat)
        self.trj_abs_err = self.calc_trajectory_error(pred_mat, true_mat, True)
        self.trj_rel_err = self.calc_trajectory_error(pred_mat, true_mat, False)
        self.rot_err = self.calc_rotational_error(pred_mat, true_mat)
        return self

    @staticmethod
    def snippet_pose_from_first(poses: np.ndarray) -> np.ndarray:
        """[batch, numsrc, 4, 4] -> [batch, snippet, 4, 4] rebased to the
        first frame; identity target inserted at index 2."""
        batch = poses.shape[0]
        eye = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1, 1))
        poses_mat = np.concatenate([poses[:, :2], eye, poses[:, 2:]], axis=1)
        origin = poses_mat[:, 0:1]
        return np.matmul(np.linalg.inv(origin), poses_mat)

    @staticmethod
    def calc_trajectory_error(pred_mat, true_mat, abs_scale: bool) -> np.ndarray:
        """[batch, snippet-1] trajectory error in meters."""
        xyz_pred = pred_mat[:, :, :3, 3]
        xyz_true = true_mat[:, :, :3, 3]
        if abs_scale:
            err = xyz_true - xyz_pred
        else:
            denom = np.sum(xyz_pred ** 2, axis=2)
            denom = np.where(denom < 1e-12, 1e-12, denom)
            scale = np.sum(xyz_true * xyz_pred, axis=2) / denom
            err = xyz_true - xyz_pred * scale[..., np.newaxis]
        err = np.sqrt(np.sum(err ** 2, axis=2))
        return err[:, 1:]

    @staticmethod
    def calc_rotational_error(pred_mat, true_mat) -> np.ndarray:
        """[batch, snippet-1] geodesic rotation error in rad."""
        rot_pred = pred_mat[:, :, :3, :3]
        rot_true = true_mat[:, :, :3, :3]
        rel = np.matmul(np.linalg.inv(rot_pred), rot_true)
        trace = np.trace(rel, axis1=2, axis2=3)
        angle = np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0))
        return angle[:, 1:]

    def get_mean_pose_error(self):
        return (np.mean(self.trj_abs_err), np.mean(self.trj_rel_err),
                np.mean(self.rot_err))
