"""Optical-flow warping (port of ``xpt_mde_tpu.ops.flow_warp``).

Target pixel (u, v) samples the source at (u, v) - flow, through the
shared bilinear sampler of ``ops/warp.py``: the loss-side warps of data
frames are const-source (kernels K1 and K1-bwd on the card), PWC-Net's
feature warps are image-differentiable (``sample_patch_gather``).

On a spatial mesh (``parallel.spatial``) a flow is this rank's band of
target rows: its pixels take their global rows, a feature warp samples the
whole feature map (its bands gathered), and the loss-side warp the whole
source frames resized to the flow's global size.
"""

from __future__ import annotations

from typing import Sequence

import torch

from xpt_mde_tpu_torch.ops.warp import bilinear_sample
from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.utils.image import resize_image


def flow_to_pixel_coords(flow: torch.Tensor) -> torch.Tensor:
    """Flow maps -> absolute source pixel coordinates ``grid - flow``.

    :param flow: [batch, numsrc, height, width, 2 (u, v)] (on a spatial
        mesh a band of rows, whose pixels take their global rows)
    :return: [batch, numsrc, 2, height*width]
    """
    batch, numsrc, height, width, _ = flow.shape
    first = spatial.first_row(flow, 2)
    v, u = torch.meshgrid(torch.arange(first, first + height, dtype=flow.dtype,
                                       device=flow.device),
                          torch.arange(width, dtype=flow.dtype, device=flow.device),
                          indexing="ij")
    uvgrid = torch.stack([u, v], dim=0).reshape(1, 1, 2, -1)
    uvflow = flow.reshape(batch, numsrc, -1, 2).transpose(2, 3)
    return uvgrid - uvflow


def flow_bilinear_sample(image: torch.Tensor, flow: torch.Tensor,
                         const_src: bool = False) -> torch.Tensor:
    """Warp ``image`` by a dense flow field.

    :param image: [batch*numsrc, height, width, C] (a feature map may be a
        band, which is gathered)
    :param flow: [batch*numsrc, h, width, 2 (u, v)], h = height but on a
        band of target rows
    :param const_src: the image is never differentiated (loss-side warps
        of data frames, whole; not PWC-Net's feature warps)
    :return: [batch*numsrc, h, width, C]
    """
    coords = flow_to_pixel_coords(flow[:, None])
    image = image[:, None] if const_src else spatial.whole(image[:, None], 2)
    return bilinear_sample(image, coords, const_src=const_src)[:, 0]


def flow_warp_multi_scale(source_image: torch.Tensor,
                          flow_ms: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Warp the sources into the target view by each scale's flow.

    :param source_image: [batch, numsrc, height, width, 3]
    :param flow_ms: [batch, numsrc, height/s, width/s, 2] per scale (or a
        band of its rows)
    :return: [batch, numsrc, height/s, width/s, 3] per scale (the flow's
        rows)
    """
    batch, numsrc, height, width, chans = source_image.shape
    flat_src = source_image.reshape(batch * numsrc, height, width, chans)
    warped_ms = []
    for flow in flow_ms:
        rows, width_sc = flow.shape[2:4]
        height_sc = spatial.global_rows(flow, 2)
        with spatial.suspended():  # the whole sources, at the flow's global size
            src_sc = resize_image(flat_src, height_sc, width_sc, "bilinear")
        flow_flat = flow.reshape(batch * numsrc, rows, width_sc, 2)
        warped = flow_bilinear_sample(src_sc, flow_flat, const_src=True)
        warped_ms.append(warped.reshape(batch, numsrc, rows, width_sc, chans))
    return warped_ms
