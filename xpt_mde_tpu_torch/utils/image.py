"""Image helpers (port of ``xpt_mde_tpu.utils.image``).

Resizes follow ``tf.image.resize``: half-pixel centres and no
antialiasing. Bilinear is ``F.interpolate(align_corners=False,
antialias=False)``; nearest is ``"nearest-exact"`` (half-pixel, as
``jax.image.resize`` does it), not torch's ``"nearest"``.

Inside a spatial mesh's step (``parallel.spatial.banded``) the target
height of a resize is the map's global height, and a band is resized by
``parallel.spatial.resize``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.utils.precision import at_least_f32


def resize_nchw(x: torch.Tensor, height: int, width: int,
                method: str = "bilinear") -> torch.Tensor:
    """Resize [N, C, H, W] to [N, C, height, width] (the conv modules'
    layout). Bilinear interpolates in float32 (or float64) whatever the
    input dtype."""
    if spatial.current() is not None:
        return spatial.resize(x, height, width, method, _resize_nchw)
    return _resize_nchw(x, height, width, method)


def _resize_nchw(x: torch.Tensor, height: int, width: int, method: str) -> torch.Tensor:
    if x.shape[-2:] == (height, width):
        return x
    if method == "nearest":
        return F.interpolate(x, size=(height, width), mode="nearest-exact")
    if method != "bilinear":
        raise ValueError(f"unknown resize method: {method!r}")
    out = F.interpolate(at_least_f32(x), size=(height, width), mode="bilinear",
                        align_corners=False, antialias=False)
    return out.to(x.dtype) if x.is_floating_point() else out


def resize_image(image: torch.Tensor, height: int, width: int,
                 method: str = "bilinear") -> torch.Tensor:
    """Resize [..., H, W, C] to [..., height, width, C]."""
    src_h, src_w, chans = image.shape[-3:]
    if (spatial.global_rows(image, -3), src_w) == (height, width):
        return image
    lead = image.shape[:-3]
    flat = image.reshape(-1, src_h, src_w, chans).permute(0, 3, 1, 2)
    out = resize_nchw(flat, height, width, method).permute(0, 2, 3, 1)
    return out.reshape(lead + out.shape[-3:])


def multi_scale_like(image: torch.Tensor, pyramid: Sequence[torch.Tensor],
                     method: str = "bilinear") -> list[torch.Tensor]:
    """Resize ``image`` to the (H, W) of every tensor in ``pyramid`` (and
    to its band, where it is one)."""
    return [spatial.like(resize_image(image, spatial.global_rows(p, -3), p.shape[-2], method),
                         p, -3)
            for p in pyramid]


def safe_reciprocal(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Masked 1/x: values <= eps map to 0 (depth <-> disparity)."""
    keep = x > eps
    return keep.to(x.dtype) / torch.where(keep, x, torch.ones_like(x))


def safe_reciprocal_ms(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [safe_reciprocal(x) for x in xs]
