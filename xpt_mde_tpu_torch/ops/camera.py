"""Pinhole camera geometry (port of ``xpt_mde_tpu.ops.camera``).

Pixel coordinates are (u, v, 1) rows, ``[.., 3, H*W]``; depth is the
target-frame z; poses map target -> source. The contractions are plain
float32 matmuls and must not run in TF32, which shifts reprojected pixels
by a visible fraction of a pixel: the steps run inside
:func:`~xpt_mde_tpu_torch.utils.precision.full_f32`, and other callers
enter it themselves. The projection guard ``z + 1e-10`` is the
reference's.
"""

from __future__ import annotations

import torch


_Z_EPS = 1e-10


def pixel_grid(height: int, width: int, dtype=torch.float32,
               device=None, first_row: int = 0) -> torch.Tensor:
    """Homogeneous pixel grid (u, v, 1), shape [3, height*width]; v runs
    from ``first_row`` (a band's first global row on a spatial mesh)."""
    v, u = torch.meshgrid(torch.arange(first_row, first_row + height, dtype=dtype,
                                       device=device),
                          torch.arange(width, dtype=dtype, device=device),
                          indexing="ij")
    ones = torch.ones(height * width, dtype=dtype, device=device)
    return torch.stack([u.reshape(-1), v.reshape(-1), ones], dim=0)


def scale_intrinsics(intrinsic: torch.Tensor, scale: float) -> torch.Tensor:
    """Divide the first two rows of K [..., 3, 3] by ``scale``."""
    scaler = torch.tensor([[1.0 / scale], [1.0 / scale], [1.0]],
                          dtype=intrinsic.dtype, device=intrinsic.device)
    return intrinsic * scaler


def invert_intrinsics(intrinsic: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of K = [[fx,s,cx],[0,fy,cy],[0,0,1]]."""
    fx = intrinsic[..., 0, 0]
    sk = intrinsic[..., 0, 1]
    cx = intrinsic[..., 0, 2]
    fy = intrinsic[..., 1, 1]
    cy = intrinsic[..., 1, 2]
    one = torch.ones_like(fx)
    zero = torch.zeros_like(fx)
    row0 = torch.stack([1.0 / fx, -sk / (fx * fy),
                        (sk * cy - cx * fy) / (fx * fy)], dim=-1)
    row1 = torch.stack([zero, 1.0 / fy, -cy / fy], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def pixel2cam(pixel_coords: torch.Tensor, depth: torch.Tensor,
              intrinsic: torch.Tensor) -> torch.Tensor:
    """(u,v,1) [3, HW], depth [B,H,W,1], K [B,3,3] -> (x,y,z,1) [B,4,HW]."""
    batch = depth.shape[0]
    cam = torch.matmul(invert_intrinsics(intrinsic), pixel_coords)
    cam = cam * depth.reshape(batch, 1, -1)
    ones = torch.ones_like(cam[:, :1])
    return torch.cat([cam, ones], dim=1)


def transform_to_source(tgt_coords: torch.Tensor,
                        t2s_pose: torch.Tensor) -> torch.Tensor:
    """[B,4,HW] points, [B,N,4,4] poses -> [B,N,4,HW]."""
    return torch.matmul(t2s_pose, tgt_coords[:, None])


def cam2pixel(cam_coords: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """[B,N,4,HW] source-frame points -> (u,v,1) [B,N,3,HW]."""
    pixels = torch.matmul(intrinsic[:, None], cam_coords[:, :, :3])
    return pixels / (pixels[:, :, 2:3] + _Z_EPS)


def reproject_pixel_coords(depth: torch.Tensor, t2s_pose: torch.Tensor,
                           intrinsic: torch.Tensor,
                           grid: torch.Tensor | None = None) -> torch.Tensor:
    """Fused pixel2cam -> transform_to_source -> cam2pixel:
    uv_src ~ (K R K^-1)(uv1 * d) + K t.

    :param depth: [B, H, W, 1]; :param t2s_pose: [B, N, 4, 4];
    :param intrinsic: [B, 3, 3]; :param grid: optional [3, H*W]
    :return: source pixel coords (u, v) [B, N, 2, H*W]
    """
    batch, height, width, _ = depth.shape
    if grid is None:
        grid = pixel_grid(height, width, depth.dtype, depth.device)
    kinv = invert_intrinsics(intrinsic)
    rot = t2s_pose[:, :, :3, :3]
    tr = t2s_pose[:, :, :3, 3:]
    a_mat = torch.matmul(torch.matmul(intrinsic[:, None], rot), kinv[:, None])
    b_vec = torch.matmul(intrinsic[:, None], tr)
    xyd = grid * depth.reshape(batch, 1, 1, -1)
    pixels = torch.matmul(a_mat, xyd) + b_vec
    pixels = pixels / (pixels[:, :, 2:3] + _Z_EPS)
    return pixels[:, :, :2]
