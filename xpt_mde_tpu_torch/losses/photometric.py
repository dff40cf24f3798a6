"""Photometric losses with black-pixel masking (port of
``xpt_mde_tpu.losses.photometric``).

- a synthesized pixel whose channel mean is exactly 0 is an invalid warp
  and contributes zero error;
- SSIM uses 3x3 mean windows with SAME padding that EXCLUDES the padded
  positions from the average (TF pooling), c1 = 0.01^2, c2 = 0.03^2, and
  scores clip((1 - ssim) / 2, 0, 1).

Inputs: synth_target [B, N, H, W, C], orig_target [B, H, W, C]; outputs
[B] when ``reduce`` else [B, N, H, W, C]. On a spatial mesh
(``parallel.spatial``) the inputs are this rank's band of rows, SSIM's
windows read one row of each neighbouring band, and a reduced loss is the
band's share of the sample's mean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from xpt_mde_tpu_torch.parallel import spatial


def _error_mask(synth_target: torch.Tensor) -> torch.Tensor:
    """True where the synthesized pixel is black (invalid warp)."""
    return torch.mean(synth_target, dim=-1, keepdim=True) == 0


def photometric_loss_l1(synth_target: torch.Tensor, orig_target: torch.Tensor,
                        reduce: bool = True) -> torch.Tensor:
    err = torch.abs(synth_target - orig_target[:, None])
    err = torch.where(_error_mask(synth_target), torch.zeros_like(err), err)
    if reduce:
        return spatial.band_mean(err, (1, 2, 3, 4), 2)
    return err


def photometric_loss_l2(synth_target: torch.Tensor, orig_target: torch.Tensor,
                        reduce: bool = True) -> torch.Tensor:
    err = torch.square(synth_target - orig_target[:, None])
    err = torch.where(_error_mask(synth_target), torch.zeros_like(err), err)
    if reduce:
        return spatial.band_mean(err, (1, 2, 3, 4), 2)
    return err


def avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean over the (H, W) axes of [..., H, W, C], SAME padding,
    padded positions excluded (interior pixels average 9, corners 4)."""
    h, w, c = x.shape[-3:]
    # contiguous NCHW: on a CUDA tensor in the channels-last layout that
    # the permute gives, avg_pool2d's backward is wrong (torch 2.11 with
    # CUDA 12.8: it disagrees with the CPU's while the forward agrees)
    flat = x.reshape(-1, h, w, c).permute(0, 3, 1, 2).contiguous()
    if spatial.current() is not None:
        from xpt_mde_tpu_torch.models.layers import window_sums_and_counts
        sums, counts = window_sums_and_counts(flat, 3)
        pooled = sums / counts
    else:
        pooled = F.avg_pool2d(flat, 3, stride=1, padding=1, count_include_pad=False)
    return pooled.permute(0, 2, 3, 1).reshape(x.shape)


def photometric_loss_ssim(synth_target: torch.Tensor, orig_target: torch.Tensor,
                          reduce: bool = True) -> torch.Tensor:
    x = orig_target[:, None]
    y = synth_target
    c1 = 0.01 ** 2
    c2 = 0.03 ** 2
    # target-only pools run once on [B,H,W,C] and broadcast over sources
    mu_x = avg_pool_3x3_same(orig_target)[:, None]
    sigma_x = avg_pool_3x3_same(orig_target ** 2)[:, None] - mu_x ** 2
    mu_y = avg_pool_3x3_same(y)
    sigma_y = avg_pool_3x3_same(y ** 2) - mu_y ** 2
    sigma_xy = avg_pool_3x3_same(x * y) - mu_x * mu_y

    ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    ssim = torch.clamp((1.0 - ssim_n / ssim_d) / 2.0, 0.0, 1.0)
    ssim = torch.where(_error_mask(synth_target), torch.zeros_like(ssim), ssim)
    if reduce:
        return spatial.band_mean(ssim, (1, 2, 3, 4), 2)
    return ssim


PHOTOMETRIC_FNS = {
    "L1": photometric_loss_l1,
    "L2": photometric_loss_l2,
    "SSIM": photometric_loss_ssim,
}
