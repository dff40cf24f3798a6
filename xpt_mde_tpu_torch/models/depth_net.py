"""DepthNet over a multi-scale backbone (port of the pretrained-backbone
part of ``xpt_mde_tpu.models.depth_net``).

- input is the snippet [B, S, H, W, 3]; only the target (last) frame is
  used;
- outputs ``depth_ms = [d0 (1/1), d1 (1/2), d2 (1/4), d3 (1/8)]``, each
  [B, h, w, 1], and ``debug_out``, NHWC like the JAX package;
- each scale's pre-activation conv is bilinearly upsampled into the next
  finer decoder level (depth chaining).

Only the plain decoder is ported; the JAX package's space-to-depth tail
is a TPU lane-padding fix and computes the same function.

With a bfloat16 compute ``dtype`` the backbone and the decoder convs run
in bfloat16, each head's conv goes to float32 before its activation (so
depth is float32), and the chained heads re-enter the decoder cast back
to bfloat16, where the JAX package casts them.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from xpt_mde_tpu_torch.models.layers import (Conv, cast_parameters, to_compute,
                                             upsample_2x_nchw)
from xpt_mde_tpu_torch.utils.image import resize_nchw
from xpt_mde_tpu_torch.utils.precision import at_least_f32


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class UpconvBlock(nn.Module):
    """2x upsample -> conv -> concat(skip[, chained depth]) -> conv."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int,
                 upsample_interp: str = "nearest", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upsample_interp = upsample_interp
        self.Conv_0 = Conv(in_ch, out_ch, 3, dtype=dtype)
        self.Conv_1 = Conv(out_ch + skip_ch, out_ch, 3, dtype=dtype)

    def forward(self, x, skip, bef_pred=None):
        x = self.Conv_0(upsample_2x_nchw(x, self.upsample_interp))
        parts = [x, skip] if bef_pred is None else [x, skip, bef_pred.to(x.dtype)]
        return self.Conv_1(torch.cat(parts, dim=1))


class ScaledDepthHead(nn.Module):
    """conv(1, 3, linear) -> activation; returns (depth, the conv resized
    to (dst_h, dst_w) for chaining, the conv), all float32 NCHW."""

    def __init__(self, in_ch: int, pred_activation: Callable,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pred_activation = pred_activation
        self.Conv_0 = Conv(in_ch, 1, 3, use_activation=False, dtype=dtype)

    def forward(self, src, dst_h: int, dst_w: int):
        conv = at_least_f32(self.Conv_0(src))  # depth math stays f32
        depth = self.pred_activation(conv)
        return depth, resize_nchw(conv, dst_h, dst_w, "bilinear"), conv


class DepthDecoder(nn.Module):
    """Skip-connected decoder over 5 encoder features (strides 2..32)
    with 4 chained depth heads. Module names follow flax's numbering."""

    def __init__(self, enc_channels, pred_activation: Callable,
                 upsample_interp: str = "nearest", dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, c2, c3, c4, c5 = enc_channels
        interp, act = upsample_interp, pred_activation
        self.compute_dtype = dtype
        self.UpconvBlock_0 = UpconvBlock(c5, c4, 256, interp, dtype)      # 1/16
        self.UpconvBlock_1 = UpconvBlock(256, c3, 128, interp, dtype)     # 1/8
        self.ScaledDepthHead_0 = ScaledDepthHead(128, act, dtype)
        self.UpconvBlock_2 = UpconvBlock(128, c2 + 1, 64, interp, dtype)  # 1/4
        self.ScaledDepthHead_1 = ScaledDepthHead(64, act, dtype)
        self.UpconvBlock_3 = UpconvBlock(64, c1 + 1, 32, interp, dtype)   # 1/2
        self.ScaledDepthHead_2 = ScaledDepthHead(32, act, dtype)
        self.UpconvBlock_4 = UpconvBlock(32, 1, 16, interp, dtype)        # 1/1
        self.ScaledDepthHead_3 = ScaledDepthHead(16, act, dtype)

    def forward(self, features_ms, height: int, width: int):
        conv1, conv2, conv3, conv4, conv5 = features_ms
        upconv4 = self.UpconvBlock_0(conv5, conv4)
        upconv3 = self.UpconvBlock_1(upconv4, conv3)
        depth3, dp2_up, dp3 = self.ScaledDepthHead_0(upconv3, height // 4,
                                                     width // 4)
        upconv2 = self.UpconvBlock_2(upconv3, conv2, dp2_up)
        depth2, dp1_up, dp2 = self.ScaledDepthHead_1(upconv2, height // 2,
                                                     width // 2)
        upconv1 = self.UpconvBlock_3(upconv2, conv1, dp1_up)
        depth1, dp0_up, dp1 = self.ScaledDepthHead_2(upconv1, height, width)
        upconv0 = self.UpconvBlock_4(upconv1, to_compute(self.compute_dtype, dp0_up))
        depth0, _, dp0 = self.ScaledDepthHead_3(upconv0, height, width)
        return {"depth_ms": [_nhwc(d) for d in (depth0, depth1, depth2, depth3)],
                "debug_out": [_nhwc(d) for d in (dp0, upconv0, dp3, upconv3)]}


class DepthNetPretrained(nn.Module):
    """U-Net over a multi-scale backbone encoder."""

    def __init__(self, backbone: nn.Module, pred_activation: Callable,
                 upsample_interp: str = "nearest", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = backbone
        self.compute_dtype = dtype
        self.DepthDecoder_0 = DepthDecoder(backbone.out_channels,
                                           pred_activation, upsample_interp, dtype)

    def forward(self, image5d: torch.Tensor):
        target = to_compute(self.compute_dtype, image5d[:, -1].permute(0, 3, 1, 2))
        height, width = target.shape[-2:]
        with cast_parameters(self):
            features_ms = self.backbone(target)
            return self.DepthDecoder_0(features_ms, height, width)
