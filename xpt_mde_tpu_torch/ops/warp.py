"""Bilinear sampling with validity masking (port of ``xpt_mde_tpu.ops.warp``).

Semantics, shared with kernels K1 and K1-bwd (``ops/kernels/warp.py``):

- the floor/ceil neighbours are clipped into the image; a pair whose
  clipped ceil != floor + 1 (outside, or exactly on the far border) is
  INVALID;
- an optional per-target-pixel ``valid_mask`` (zero depth) also
  invalidates, shared by all sources;
- invalid pixels come out black (all four weights 0);
- the target may be a band of rows (a spatial mesh's): coords and mask
  cover h_t rows of the source's width, in the source's global pixel
  coordinates, and the output has h_t rows.

:func:`bilinear_sample_plain` and :func:`warp_coord_grad_plain` are the
plain PyTorch versions of K1 and K1-bwd: the CPU path and the oracles the
kernels are held against on the card. They gather the four neighbours
directly; the TPU one-hot formulation was a workaround for slow TPU
gathers and is not ported.

The image-differentiable warp (``const_src=False``, PWC-Net's feature
warp) is :func:`sample_patch_gather` on either device, plain PyTorch with
autograd: in JAX it is XLA code (``_sample_patch_gather``), not a Pallas
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xpt_mde_tpu_torch.ops.kernels.warp import WarpConstSrc


def _clipped_neighbors(image, pixel_coords, valid_mask):
    """u, v [B,N,HW], their clipped floor/ceil neighbours uf, uc, vf, vc
    (float) and ``valid`` (image dtype, 0 or 1)."""
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
    return u, v, uf, uc, vf, vc, valid.to(image.dtype)


def _gather(image, index):
    """image [B,N,H,W,C] at flat pixel indices [B,N,HW] -> [B,N,HW,C]."""
    batch, numsrc, height, width, channels = image.shape
    flat = image.reshape(batch, numsrc, height * width, channels)
    return torch.gather(flat, 2, index[..., None].expand(-1, -1, -1, channels))


def bilinear_sample_plain(image: torch.Tensor, pixel_coords: torch.Tensor,
                          valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch bilinear sample on any device (K1's oracle).

    Its autograd gives the coordinates the gradient of
    :func:`warp_coord_grad_plain` (and, unlike K1, the image one too).

    :param image: [B, N, H, W, C]
    :param pixel_coords: (u, v[, 1]) [B, N, 2 or 3, h_t*W], h_t = H but on
        a band of target rows
    :param valid_mask: optional [B, h_t, W, 1]; zero entries are invalid
    :return: [B, N, h_t, W, C]
    """
    batch, numsrc, height, width, channels = image.shape
    rows = pixel_coords.shape[-1] // width
    u, v, uf, uc, vf, vc, valid = _clipped_neighbors(image, pixel_coords, valid_mask)
    w_uf, w_uc = uc - u, u - uf
    w_vf, w_vc = vc - v, v - vf
    weights = (w_uf * w_vf * valid, w_uf * w_vc * valid,
               w_uc * w_vf * valid, w_uc * w_vc * valid)
    uf, vf, uc, vc = uf.long(), vf.long(), uc.long(), vc.long()
    out = None
    for idx, w in zip((vf * width + uf, vc * width + uf,
                       vf * width + uc, vc * width + uc), weights):
        term = _gather(image, idx) * w[..., None]
        out = term if out is None else out + term
    return out.reshape(batch, numsrc, rows, width, channels)


def warp_coord_grad_plain(image: torch.Tensor, pixel_coords: torch.Tensor,
                          valid_mask: torch.Tensor | None,
                          grad_out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch coordinate gradient of the const-source warp (K1-bwd's
    oracle), as ``_warp_const_bwd`` of the JAX kernel forms it:

        du = valid * sum_c g * (w_v * D_f + (1 - w_v) * D_c)
        dv = valid * sum_c g * (J_c - J_f)

    with w_u = uc - u, w_v = vc - v, P_f / P_c the image columns uf and
    uf + 1, J = w_u * P_f + (1 - w_u) * P_c and D = P_c - P_f, each at row
    vf (J_f, D_f) and vf + 1 (J_c, D_c).

    :param image: [B, N, H, W, C]; :param pixel_coords: [B, N, 2 or 3, h_t*W]
    :param valid_mask: optional [B, h_t, W, 1]
    :param grad_out: [B, N, h_t, W, C], the cotangent of the sample
    :return: dcoords [B, N, 2 or 3, h_t*W]; a homogeneous third row gets 0
    """
    batch, numsrc, height, width, channels = image.shape
    target_hw = pixel_coords.shape[-1]
    u, v, uf, uc, vf, vc, valid = _clipped_neighbors(image, pixel_coords, valid_mask)
    w_u = (uc - u)[..., None]
    w_v = (vc - v)[..., None]
    # valid => uc == uf + 1 and vc == vf + 1; invalid pixels are zeroed below
    uf, vf, uc, vc = uf.long(), vf.long(), uc.long(), vc.long()
    p_ff = _gather(image, vf * width + uf)
    p_cf = _gather(image, vf * width + uc)
    p_fc = _gather(image, vc * width + uf)
    p_cc = _gather(image, vc * width + uc)
    j_f = w_u * p_ff + (1.0 - w_u) * p_cf
    j_c = w_u * p_fc + (1.0 - w_u) * p_cc
    d_f = p_cf - p_ff
    d_c = p_cc - p_fc
    g = grad_out.reshape(batch, numsrc, target_hw, channels)
    du = torch.sum(g * (w_v * d_f + (1.0 - w_v) * d_c), dim=-1) * valid
    dv = torch.sum(g * (j_c - j_f), dim=-1) * valid
    rows = [du, dv] + [torch.zeros_like(du)] * (pixel_coords.shape[2] - 2)
    return torch.stack(rows, dim=2)


def sample_patch_gather(image: torch.Tensor, pixel_coords: torch.Tensor,
                        valid_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Image-differentiable bilinear sample, as JAX's XLA path
    ``_sample_patch_gather`` forms it: every 2x2 neighbourhood packed into
    the channels of a zero-padded copy, one gather at the floor neighbour,
    then the four weighted corners. Its autograd gives both the image and
    the coordinates their gradients (the image's through the gather's
    scatter-add, whose summation order on the card varies from run to
    run).

    :param image: [B, N, H, W, C], the whole map (on a spatial mesh
        gathered from its bands, ``parallel.spatial.whole``, whose backward
        sums the ranks' shares of the image's gradient to the owners)
    :param pixel_coords: (u, v[, 1]) [B, N, 2 or 3, h_t*W] in the image's
        global pixel coordinates, h_t = H but on a band of target rows
    :param valid_mask: optional [B, h_t, W, 1]; zero entries are invalid
    :return: [B, N, h_t, W, C]
    """
    batch, numsrc, height, width, channels = image.shape
    rows = pixel_coords.shape[-1] // width
    u, v, uf, uc, vf, vc, valid = _clipped_neighbors(image, pixel_coords, valid_mask)
    w_uf, w_uc = uc - u, u - uf
    w_vf, w_vc = vc - v, v - vf
    padded = F.pad(image, (0, 0, 0, 1, 0, 1))
    patches = torch.cat([padded[:, :, :height, :width],          # (v, u)
                         padded[:, :, 1:height + 1, :width],     # (v + 1, u)
                         padded[:, :, :height, 1:width + 1],     # (v, u + 1)
                         padded[:, :, 1:height + 1, 1:width + 1]], dim=-1)
    index = (vf.long() * width + uf.long())[..., None].expand(-1, -1, -1, 4 * channels)
    picked = torch.gather(patches.reshape(batch, numsrc, height * width, 4 * channels),
                          2, index).reshape(batch, numsrc, rows * width, 4, channels)
    # wherever a weight is non-zero, validity guarantees uc == uf + 1 and
    # vc == vf + 1, so the packed corners are the four neighbours
    out = (picked[:, :, :, 0] * (w_uf * w_vf * valid)[..., None]
           + picked[:, :, :, 1] * (w_uf * w_vc * valid)[..., None]
           + picked[:, :, :, 2] * (w_uc * w_vf * valid)[..., None]
           + picked[:, :, :, 3] * (w_uc * w_vc * valid)[..., None])
    return out.reshape(batch, numsrc, rows, width, channels)


def bilinear_sample(image: torch.Tensor, pixel_coords: torch.Tensor,
                    valid_mask: torch.Tensor | None = None,
                    const_src: bool = False) -> torch.Tensor:
    """Sample ``image`` at floating-point ``pixel_coords``.

    ``const_src`` promises that ``image`` is never differentiated (the
    synthesis losses warp training data). On a CUDA tensor that warp is
    :class:`~xpt_mde_tpu_torch.ops.kernels.warp.WarpConstSrc`: kernel K1
    forward, kernel K1-bwd for the coordinate gradient, no gradient for
    the image or the mask. On a CPU tensor it is
    :func:`bilinear_sample_plain` and its autograd. Without
    ``const_src`` the warp is :func:`sample_patch_gather` on either
    device.

    :param image: source images [B, N, H, W, C]
    :param pixel_coords: (u, v[, 1]) [B, N, 2 or 3, H*W]
    :param valid_mask: optional [B, H, W, 1]; zero entries are invalid
    :return: reconstructed target views [B, N, H, W, C]
    """
    if not const_src:
        return sample_patch_gather(image, pixel_coords, valid_mask)
    if image.device.type == "cpu":
        return bilinear_sample_plain(image, pixel_coords, valid_mask)
    mask = None if valid_mask is None else valid_mask.contiguous()
    return WarpConstSrc.apply(image.contiguous(), pixel_coords.contiguous(), mask)
