"""Optical-flow warping (port of ``xpt_mde_tpu.ops.flow_warp``).

Target pixel (u, v) samples the source at (u, v) - flow, through the
shared bilinear sampler of ``ops/warp.py``: the loss-side warps of data
frames are const-source (kernels K1 and K1-bwd on the card), PWC-Net's
feature warps are image-differentiable (``sample_patch_gather``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from xpt_mde_tpu_torch.ops.warp import bilinear_sample
from xpt_mde_tpu_torch.utils.image import resize_image


def flow_to_pixel_coords(flow: torch.Tensor) -> torch.Tensor:
    """Flow maps -> absolute source pixel coordinates ``grid - flow``.

    :param flow: [batch, numsrc, height, width, 2 (u, v)]
    :return: [batch, numsrc, 2, height*width]
    """
    batch, numsrc, height, width, _ = flow.shape
    v, u = torch.meshgrid(torch.arange(height, dtype=flow.dtype, device=flow.device),
                          torch.arange(width, dtype=flow.dtype, device=flow.device),
                          indexing="ij")
    uvgrid = torch.stack([u, v], dim=0).reshape(1, 1, 2, -1)
    uvflow = flow.reshape(batch, numsrc, -1, 2).transpose(2, 3)
    return uvgrid - uvflow


def flow_bilinear_sample(image: torch.Tensor, flow: torch.Tensor,
                         const_src: bool = False) -> torch.Tensor:
    """Warp ``image`` by a dense flow field.

    :param image: [batch*numsrc, height, width, C]
    :param flow: [batch*numsrc, height, width, 2 (u, v)]
    :param const_src: the image is never differentiated (loss-side warps
        of data frames; not PWC-Net's feature warps)
    :return: [batch*numsrc, height, width, C]
    """
    coords = flow_to_pixel_coords(flow[:, None])
    return bilinear_sample(image[:, None], coords, const_src=const_src)[:, 0]


def flow_warp_multi_scale(source_image: torch.Tensor,
                          flow_ms: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Warp the sources into the target view by each scale's flow.

    :param source_image: [batch, numsrc, height, width, 3]
    :param flow_ms: [batch, numsrc, height/s, width/s, 2] per scale
    :return: [batch, numsrc, height/s, width/s, 3] per scale
    """
    batch, numsrc, height, width, chans = source_image.shape
    flat_src = source_image.reshape(batch * numsrc, height, width, chans)
    warped_ms = []
    for flow in flow_ms:
        height_sc, width_sc = flow.shape[2:4]
        src_sc = resize_image(flat_src, height_sc, width_sc, "bilinear")
        flow_flat = flow.reshape(batch * numsrc, height_sc, width_sc, 2)
        warped = flow_bilinear_sample(src_sc, flow_flat, const_src=True)
        warped_ms.append(warped.reshape(batch, numsrc, height_sc, width_sc, chans))
    return warped_ms
