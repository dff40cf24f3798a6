"""SE(3) twist <-> matrix conversions (port of ``xpt_mde_tpu.utils.se3``).

Same conventions as the reference: a twist is ``(tx, ty, tz, u1, u2, u3)``
with an axis-angle rotation vector, the rotation uses the
*transposed-skew* Rodrigues formula ``R = I + K^T sin(th) +
(K^T)^2 (1 - cos(th))``, and poses map target-frame points to a source
frame. Batched over any leading dims; callers keep TF32 off
(:func:`~xpt_mde_tpu_torch.utils.precision.full_f32`).
"""

from __future__ import annotations

import torch


_SMALL_ANGLE = 1e-8
_SMALL_THETA = 1e-5


def _last_row(top: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return row.expand(top.shape[:-2] + (1, 4))


def twist_to_matrix(twist: torch.Tensor) -> torch.Tensor:
    """:param twist: [..., 6] -> [..., 4, 4] transforms."""
    trans = twist[..., :3]
    uvec = twist[..., 3:]
    # guarded square root: finite at exactly-zero rotation
    sq = torch.sum(uvec * uvec, dim=-1, keepdim=True)
    is_small = sq < _SMALL_ANGLE ** 2
    theta = torch.sqrt(torch.where(is_small, torch.ones_like(sq), sq))
    w1, w2, w3 = (uvec / theta).unbind(-1)
    z = torch.zeros_like(w1)
    # transposed skew matrix (reference sign convention)
    k = torch.stack([torch.stack([z, w3, -w2], dim=-1),
                     torch.stack([-w3, z, w1], dim=-1),
                     torch.stack([w2, -w1, z], dim=-1)], dim=-2)
    th = theta[..., None]
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(k.shape)
    rot = eye + k * torch.sin(th) + torch.matmul(k, k) * (1.0 - torch.cos(th))
    rot = torch.where(is_small[..., None], eye, rot)
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    return torch.cat([top, _last_row(top)], dim=-2)


def matrix_to_twist(matrix: torch.Tensor) -> torch.Tensor:
    """:param matrix: [..., 4, 4] -> [..., 6] twists (inverse of
    :func:`twist_to_matrix`)."""
    rot = matrix[..., :3, :3]
    trace = torch.diagonal(rot, dim1=-2, dim2=-1).sum(-1)
    # strictly inside (-1, 1): arccos' derivative is infinite at +-1
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_theta)[..., None]
    axis = torch.stack([rot[..., 1, 2] - rot[..., 2, 1],
                        rot[..., 2, 0] - rot[..., 0, 2],
                        rot[..., 0, 1] - rot[..., 1, 0]], dim=-1)
    small = torch.abs(theta) < _SMALL_THETA
    sin_theta = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    rvec = torch.where(small, axis / 2.0, axis / (2.0 * sin_theta) * theta)
    return torch.cat([matrix[..., :3, 3], rvec], dim=-1)


def invert_matrix(matrix: torch.Tensor) -> torch.Tensor:
    """Rigid inverse: inv([R t]) = [R^T, -R^T t]."""
    rot_t = matrix[..., :3, :3].transpose(-1, -2)
    top = torch.cat([rot_t, -torch.matmul(rot_t, matrix[..., :3, 3:])], dim=-1)
    return torch.cat([top, _last_row(top)], dim=-2)
