"""Depth nets (port of ``xpt_mde_tpu.models.depth_net``): U-Nets with
4-scale heads and depth chaining.

- input is the snippet [B, S, H, W, 3]; only the target (last) frame is
  used;
- outputs ``depth_ms = [d0 (1/1), d1 (1/2), d2 (1/4), d3 (1/8)]``, each
  [B, h, w, 1], and ``debug_out``, NHWC like the JAX package;
- each scale's pre-activation conv is bilinearly upsampled into the next
  finer decoder level (depth chaining).

``DepthNetPretrained`` decodes a backbone's 5 feature maps (strides
2..32), and may recompute the backbone in the backward (``remat_backbone``). ``DepthNetBasic`` is the SfMLearner-style net: a 7-level conv
encoder (strides 2..128), two 512-wide up-blocks, then the same decoder;
its up-blocks resize each upsampled map to its skip's size
(``resize_to_skip``), so any input size works. ``DepthNetNoResize`` is
the same without that resize (input divisible by 128).

Only the plain decoder is ported; the JAX package's space-to-depth tail
is a TPU lane-padding fix and computes the same function.

With a bfloat16 compute ``dtype`` the encoder and the decoder convs run
in bfloat16, each head's conv goes to float32 before its activation (so
depth is float32), and the chained heads re-enter the decoder cast back
to bfloat16, where the JAX package casts them.

On a spatial mesh (``parallel.spatial``) the nets cut the target frame to
this rank's band of rows, and every size below is the global one.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from xpt_mde_tpu_torch.models.layers import (Conv, cast_parameters, frozen_statistics,
                                             to_compute, upsample_2x_nchw)
from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.utils.image import resize_nchw
from xpt_mde_tpu_torch.utils.precision import at_least_f32


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class UpconvBlock(nn.Module):
    """2x upsample -> conv [-> bilinear resize to the skip's size] ->
    concat(skip[, chained depth]) -> conv."""

    def __init__(self, in_ch: int, skip_ch: int, out_ch: int,
                 upsample_interp: str = "nearest", resize_to_skip: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upsample_interp = upsample_interp
        self.resize_to_skip = resize_to_skip
        self.Conv_0 = Conv(in_ch, out_ch, 3, dtype=dtype)
        self.Conv_1 = Conv(out_ch + skip_ch, out_ch, 3, dtype=dtype)

    def forward(self, x, skip, bef_pred=None):
        x = self.Conv_0(upsample_2x_nchw(x, self.upsample_interp))
        if self.resize_to_skip:
            x = resize_nchw(x, spatial.global_rows(skip), skip.shape[-1], "bilinear")
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
                 upsample_interp: str = "nearest", resize_to_skip: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c1, c2, c3, c4, c5 = enc_channels
        act = pred_activation
        self.compute_dtype = dtype

        def up(in_ch, skip_ch, out_ch):
            return UpconvBlock(in_ch, skip_ch, out_ch, upsample_interp, resize_to_skip, dtype)

        self.UpconvBlock_0 = up(c5, c4, 256)      # 1/16
        self.UpconvBlock_1 = up(256, c3, 128)     # 1/8
        self.ScaledDepthHead_0 = ScaledDepthHead(128, act, dtype)
        self.UpconvBlock_2 = up(128, c2 + 1, 64)  # 1/4
        self.ScaledDepthHead_1 = ScaledDepthHead(64, act, dtype)
        self.UpconvBlock_3 = up(64, c1 + 1, 32)   # 1/2
        self.ScaledDepthHead_2 = ScaledDepthHead(32, act, dtype)
        self.UpconvBlock_4 = up(32, 1, 16)        # 1/1
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
    """U-Net over a multi-scale backbone encoder.

    With ``remat_backbone`` the backbone runs under ``torch.utils.checkpoint``
    (non-reentrant) whenever autograd records: its activations are freed
    after the forward and recomputed in the backward. The recompute runs
    inside ``frozen_statistics``, so the BatchNorm running statistics take
    the forward's batch statistics once, as flax's functional ``nn.remat``
    does. The backbone draws no random numbers, so the recompute is the
    forward's computation."""

    def __init__(self, backbone: nn.Module, pred_activation: Callable,
                 upsample_interp: str = "nearest", dtype: torch.dtype = torch.float32,
                 remat_backbone: bool = False):
        super().__init__()
        self.backbone = backbone
        self.compute_dtype = dtype
        self.remat_backbone = remat_backbone
        self.DepthDecoder_0 = DepthDecoder(backbone.out_channels, pred_activation,
                                           upsample_interp, dtype=dtype)

    def _encode(self, target: torch.Tensor) -> list[torch.Tensor]:
        if not (self.remat_backbone and torch.is_grad_enabled()):
            return self.backbone(target)
        calls = []

        def run(x):
            calls.append(None)
            if len(calls) == 1:
                return self.backbone(x)
            with frozen_statistics(self.backbone):  # the backward's recompute
                return self.backbone(x)

        return checkpoint(run, target, use_reentrant=False)

    def forward(self, image5d: torch.Tensor):
        target = spatial.to_band(
            to_compute(self.compute_dtype, image5d[:, -1].permute(0, 3, 1, 2)))
        height, width = spatial.global_rows(target), target.shape[-1]
        with cast_parameters(self):
            features_ms = self._encode(target)
            return self.DepthDecoder_0(features_ms, height, width)


# (features, kernel, stride) of BasicEncoder's convs in flax's Conv_i order,
# and the indices of the ones whose outputs are the 7 feature maps
_BASIC_ENCODER = [(32, 7, 1), (32, 7, 2), (64, 5, 1), (64, 5, 2), (128, 3, 1), (128, 3, 2),
                  (256, 3, 1), (256, 3, 2), (512, 3, 1), (512, 3, 2), (512, 3, 1), (512, 3, 2),
                  (512, 3, 1), (512, 3, 2)]
_BASIC_FEATURES = (2, 4, 6, 8, 10, 12, 13)


class BasicEncoder(nn.Module):
    """SfMLearner-style 7-level conv encoder: features at strides (2, 4,
    8, 16, 32, 64, 128), NCHW."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        in_ch = 3
        for i, (features, kernel, stride) in enumerate(_BASIC_ENCODER):
            self.add_module(f"Conv_{i}", Conv(in_ch, features, kernel, stride, dtype=dtype))
            in_ch = features
        self.out_channels = [_BASIC_ENCODER[i][0] for i in _BASIC_FEATURES]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for i, conv in enumerate(self.children()):
            x = conv(x)
            if i in _BASIC_FEATURES:
                feats.append(x)
        return feats


class DepthNetBasic(nn.Module):
    """BasicEncoder, two 512-wide up-blocks (1/64, 1/32), then the shared
    decoder over [conv1, conv2, conv3, conv4, upconv5]."""

    resize_to_skip = True

    def __init__(self, pred_activation: Callable, upsample_interp: str = "nearest",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.BasicEncoder_0 = BasicEncoder(dtype)
        c1, c2, c3, c4, c5, c6, c7 = self.BasicEncoder_0.out_channels
        up = dict(upsample_interp=upsample_interp, resize_to_skip=self.resize_to_skip,
                  dtype=dtype)
        self.UpconvBlock_0 = UpconvBlock(c7, c6, 512, **up)   # 1/64
        self.UpconvBlock_1 = UpconvBlock(512, c5, 512, **up)  # 1/32
        self.DepthDecoder_0 = DepthDecoder([c1, c2, c3, c4, 512], pred_activation, **up)

    def forward(self, image5d: torch.Tensor):
        target = spatial.to_band(
            to_compute(self.compute_dtype, image5d[:, -1].permute(0, 3, 1, 2)))
        height, width = spatial.global_rows(target), target.shape[-1]
        with cast_parameters(self):
            conv1, conv2, conv3, conv4, conv5, conv6, conv7 = self.BasicEncoder_0(target)
            upconv6 = self.UpconvBlock_0(conv7, conv6)
            upconv5 = self.UpconvBlock_1(upconv6, conv5)
            return self.DepthDecoder_0([conv1, conv2, conv3, conv4, upconv5], height, width)


class DepthNetNoResize(DepthNetBasic):
    """DepthNetBasic without the up-blocks' resize: the input must be
    divisible by 128."""

    resize_to_skip = False
