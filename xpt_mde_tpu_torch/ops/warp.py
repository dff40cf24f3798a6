"""Bilinear sampling with validity masking (port of ``xpt_mde_tpu.ops.warp``).

Semantics, shared with kernel K1 (``ops/kernels/warp.py``):

- the floor/ceil neighbours are clipped into the image; a pair whose
  clipped ceil != floor + 1 (outside, or exactly on the far border) is
  INVALID;
- an optional per-target-pixel ``valid_mask`` (zero depth) also
  invalidates, shared by all sources;
- invalid pixels come out black (all four weights 0).

:func:`bilinear_sample_plain` is the plain PyTorch version: the CPU path
and the oracle K1 is held against on the card. It gathers the four
neighbours directly; the TPU one-hot / patch-gather formulations were
workarounds for slow TPU gathers and are not ported.
"""

from __future__ import annotations

import torch

from xpt_mde_tpu_torch.ops.kernels.warp import K1


def _neighbor_weights(image, pixel_coords, valid_mask):
    """(uf, vf, uc, vc as int64 [B,N,HW]) and the four bilinear weights
    (ff, fc, cf, cc), each [B,N,HW] and zero where invalid."""
    batch, _, height, width, _ = image.shape
    u = pixel_coords[:, :, 0]
    v = pixel_coords[:, :, 1]

    uf = torch.floor(u)
    uc = torch.clamp(uf + 1.0, 0.0, width - 1)
    uf = torch.clamp(uf, 0.0, width - 1)
    vf = torch.floor(v)
    vc = torch.clamp(vf + 1.0, 0.0, height - 1)
    vf = torch.clamp(vf, 0.0, height - 1)

    valid = (uf + 1.0 == uc) & (vf + 1.0 == vc)
    if valid_mask is not None:
        valid = valid & (valid_mask.reshape(batch, 1, -1) != 0)
    valid = valid.to(image.dtype)

    w_uf, w_uc = uc - u, u - uf
    w_vf, w_vc = vc - v, v - vf
    weights = (w_uf * w_vf * valid, w_uf * w_vc * valid,
               w_uc * w_vf * valid, w_uc * w_vc * valid)
    ints = (uf.long(), vf.long(), uc.long(), vc.long())
    return ints, weights


def bilinear_sample_plain(image: torch.Tensor, pixel_coords: torch.Tensor,
                          valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch bilinear sample on any device (K1's oracle).

    :param image: [B, N, H, W, C]
    :param pixel_coords: (u, v[, 1]) [B, N, 2 or 3, H*W]
    :param valid_mask: optional [B, H, W, 1]; zero entries are invalid
    :return: [B, N, H, W, C]
    """
    batch, numsrc, height, width, channels = image.shape
    (uf, vf, uc, vc), weights = _neighbor_weights(image, pixel_coords,
                                                  valid_mask)
    flat = image.reshape(batch, numsrc, height * width, channels)
    out = None
    for idx, w in zip((vf * width + uf, vc * width + uf,
                       vf * width + uc, vc * width + uc), weights):
        index = idx[..., None].expand(-1, -1, -1, channels)
        term = torch.gather(flat, 2, index) * w[..., None]
        out = term if out is None else out + term
    return out.reshape(batch, numsrc, height, width, channels)


def bilinear_sample(image: torch.Tensor, pixel_coords: torch.Tensor,
                    valid_mask: torch.Tensor | None = None,
                    const_src: bool = False) -> torch.Tensor:
    """Sample ``image`` at floating-point ``pixel_coords``.

    ``const_src`` promises that ``image`` is never differentiated (the
    synthesis losses warp training data). On a CUDA tensor that warp is
    kernel K1; on a CPU tensor it is :func:`bilinear_sample_plain`.

    :param image: source images [B, N, H, W, C]
    :param pixel_coords: (u, v[, 1]) [B, N, 2 or 3, H*W]
    :param valid_mask: optional [B, H, W, 1]; zero entries are invalid
    :return: reconstructed target views [B, N, H, W, C]
    """
    if image.device.type == "cpu":
        return bilinear_sample_plain(image, pixel_coords, valid_mask)
    if not const_src:
        raise NotImplementedError(
            "the image-differentiable warp has no kernel on the card yet; "
            "view synthesis uses const_src=True (kernel K1)")
    mask = None if valid_mask is None else valid_mask.contiguous()
    return K1(image.contiguous(), pixel_coords.contiguous(), mask)
