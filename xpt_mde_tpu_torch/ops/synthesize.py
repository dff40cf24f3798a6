"""Multi-scale view synthesis (port of ``xpt_mde_tpu.ops.synthesize``):
twist -> SE(3) once, then per depth scale scale the intrinsics, resize the
sources, reproject and sample. Zero-depth and out-of-view pixels come out
black, and the photometric losses mask them.

On a spatial mesh (``parallel.spatial``) the depth is this rank's band of
rows: its pixels reproject from their global rows, and the sources are the
whole frames, resized whole to the scale's global size."""

from __future__ import annotations

from typing import Sequence

import torch

from xpt_mde_tpu_torch.ops.camera import pixel_grid, reproject_pixel_coords, scale_intrinsics
from xpt_mde_tpu_torch.ops.warp import bilinear_sample
from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.utils import se3
from xpt_mde_tpu_torch.utils.image import resize_image


def synthesize_single_scale(source_image: torch.Tensor, intrinsic: torch.Tensor,
                            depth: torch.Tensor, pose_matr: torch.Tensor) -> torch.Tensor:
    """Reconstruct the target view at one scale.

    :param source_image: [B, N, h, w, 3], already at the depth's scale
    :param intrinsic: [B, 3, 3], already scaled
    :param depth: target depth [B, h, w, 1] (or a band of its rows)
    :param pose_matr: target->source transforms [B, N, 4, 4]
    :return: [B, N, h, w, 3] (the depth's rows)
    """
    first = spatial.first_row(depth, 1)
    grid = pixel_grid(depth.shape[1], depth.shape[2], depth.dtype, depth.device,
                      first) if first else None
    coords = reproject_pixel_coords(depth, pose_matr, intrinsic, grid)
    # source frames are training data, never differentiated: kernel K1
    return bilinear_sample(source_image, coords, valid_mask=depth,
                           const_src=True)


def synthesize_multi_scale(source_image: torch.Tensor, intrinsic: torch.Tensor,
                           depth_ms: Sequence[torch.Tensor],
                           pose: torch.Tensor) -> list[torch.Tensor]:
    """Reconstruct the target view at every predicted depth scale.

    :param source_image: [B, N, H, W, 3]
    :param intrinsic: [B, 3, 3] at full resolution
    :param depth_ms: list of [B, H/s, W/s, 1]
    :param pose: target->source twists [B, N, 6] or matrices [B, N, 4, 4]
    :return: list of [B, N, H/s, W/s, 3]
    """
    if pose.dim() == 3 and pose.shape[-1] == 6:
        pose_matr = se3.twist_to_matrix(pose)
    else:
        pose_matr = pose
    batch, numsrc, height, width, chans = source_image.shape
    flat_src = source_image.reshape(batch * numsrc, height, width, chans)
    synth = []
    for depth_sc in depth_ms:
        height_sc, width_sc = spatial.global_rows(depth_sc, 1), depth_sc.shape[2]
        scale = height // height_sc
        intrinsic_sc = scale_intrinsics(intrinsic, float(scale))
        with spatial.suspended():  # the whole sources
            src_sc = resize_image(flat_src, height_sc, width_sc, "bilinear")
        src_sc = src_sc.reshape(batch, numsrc, height_sc, width_sc, chans)
        synth.append(synthesize_single_scale(src_sc, intrinsic_sc, depth_sc,
                                             pose_matr))
    return synth
