"""PWC-Net optical flow (port of ``xpt_mde_tpu.models.flow_net``).

- untied 6-level encoders for the target (``encoder_l``) and the
  batch-flattened sources (``encoder_r``); the target features are
  repeated per source, each target's copies next to each other
  (``jnp.repeat`` = ``repeat_interleave``, not ``Tensor.repeat``);
- coarse to fine from level 6: the correlation cost volume at
  md = 128 / 2^p with displacement stride max(md // 4, 1), the right
  features warped by the upsampled flow scaled by (0.625, 1.25, 2.5, 5.0)
  at levels 5..2, a DenseNet-style flow predictor with 4x4 stride-2
  transpose-conv upsampling, dilated context refinement at level 2.

The modules run NCHW inside and carry flax's submodule names, so
``convert.py`` maps a flax PWC-Net by path. Only the plain encoder is
ported: the JAX ``packed_encoder`` is a TPU lane-padding fix with the same
parameters.

Output: ``{"flow_ms": [f2, f3, f4, f5]}``, each [B, N, H/2^p, W/2^p, 2]
channel-last, (u, v) flow in the loss-side warp's convention
(grid - flow).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from xpt_mde_tpu_torch.config import MAX_DISPLACEMENT
from xpt_mde_tpu_torch.models.layers import Conv, ConvTranspose
from xpt_mde_tpu_torch.ops.correlation import correlation_channels, correlation_cost
from xpt_mde_tpu_torch.ops.flow_warp import flow_bilinear_sample

ENCODER_CHANNELS = (16, 32, 64, 96, 128, 196)
PREDICTOR_CHANNELS = (128, 128, 96, 64)
CONTEXT_LAYERS = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
# the scale of the upsampled flow that warps the right features, levels 5..2
WARP_SCALES = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}


def level_displacement(level: int) -> tuple[int, int]:
    """(md, stride) of the cost volume at pyramid level ``level``."""
    md = MAX_DISPLACEMENT // 2 ** level
    return md, max(md // 4, 1)


class PWCEncoder(nn.Module):
    """6-level pyramid, three convs per level (the first of stride 2):
    ``Conv_0`` ... ``Conv_17``. Returns the features at strides 2..64."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        chans_in = in_channels
        index = 0
        for chans in ENCODER_CHANNELS:
            for stride in (2, 1, 1):
                setattr(self, f"Conv_{index}", Conv(chans_in, chans, 3, stride))
                chans_in = chans
                index += 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for level in range(len(ENCODER_CHANNELS)):
            for i in range(3):
                x = getattr(self, f"Conv_{3 * level + i}")(x)
            feats.append(x)
        return feats


class FlowPredictor(nn.Module):
    """Dense convs (each output concatenated after its input), a 32-channel
    conv ``c`` and the flow conv; with ``up``, 2x transpose-conv
    upsamplings of the flow and of ``c`` (``ConvTranspose_0/1``)."""

    def __init__(self, in_channels: int, up: bool = True):
        super().__init__()
        chans_in = in_channels
        for i, chans in enumerate(PREDICTOR_CHANNELS):
            setattr(self, f"Conv_{i}", Conv(chans_in, chans))
            chans_in += chans
        self.Conv_4 = Conv(chans_in, 32)
        self.Conv_5 = Conv(32, 2, use_activation=False)
        self.up = up
        if up:
            self.ConvTranspose_0 = ConvTranspose(2, 2)
            self.ConvTranspose_1 = ConvTranspose(32, 2)

    def forward(self, x: torch.Tensor):
        for i in range(len(PREDICTOR_CHANNELS)):
            x = torch.cat([x, getattr(self, f"Conv_{i}")(x)], dim=1)
        c = self.Conv_4(x)
        flow = self.Conv_5(c)
        if not self.up:
            return flow, c
        return flow, self.ConvTranspose_0(flow), self.ConvTranspose_1(c)


class ContextNetwork(nn.Module):
    """Dilated refinement of the level-2 flow: ``Conv_0`` ... ``Conv_6``."""

    def __init__(self, in_channels: int = 32):
        super().__init__()
        chans_in = in_channels
        for i, (chans, dilation) in enumerate(CONTEXT_LAYERS):
            setattr(self, f"Conv_{i}", Conv(chans_in, chans, dilation=dilation))
            chans_in = chans
        self.Conv_6 = Conv(chans_in, 2, use_activation=False)

    def forward(self, x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        for i in range(len(CONTEXT_LAYERS) + 1):
            x = getattr(self, f"Conv_{i}")(x)
        return x + flow


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class PWCNet(nn.Module):
    """PWC-Net on [B, S, H, W, 3] snippets (the last frame is the target)."""

    def __init__(self):
        super().__init__()
        self.encoder_l = PWCEncoder()
        self.encoder_r = PWCEncoder()
        # level 6 sees the cost volume only; levels 5..2 also the left
        # features, the upsampled flow and the upsampled predictor features
        in_channels = [correlation_channels(*level_displacement(6))]
        for level in (5, 4, 3, 2):
            in_channels.append(correlation_channels(*level_displacement(level))
                               + ENCODER_CHANNELS[level - 1] + 2 + 2)
        for i, chans in enumerate(in_channels):
            setattr(self, f"FlowPredictor_{i}", FlowPredictor(chans, up=i < 4))
        self.ContextNetwork_0 = ContextNetwork(32)

    def forward(self, image5d: torch.Tensor) -> dict:
        batch, snippet, height, width, channels = image5d.shape
        numsrc = snippet - 1
        target = image5d[:, -1].permute(0, 3, 1, 2).contiguous()
        sources = image5d[:, :-1].reshape(batch * numsrc, height, width,
                                          channels).permute(0, 3, 1, 2).contiguous()
        feats_l = [torch.repeat_interleave(f, numsrc, dim=0)
                   for f in self.encoder_l(target)]
        feats_r = self.encoder_r(sources)
        c2l, c3l, c4l, c5l, c6l = feats_l[1:]
        c2r, c3r, c4r, c5r, c6r = feats_r[1:]

        corr6 = correlation_cost(c6l, c6r, *level_displacement(6))
        _, up_flow, up_feat = self.FlowPredictor_0(corr6)
        flows = []  # finest first: f2 (refined), f3, f4, f5
        for i, (level, cl, cr) in enumerate(((5, c5l, c5r), (4, c4l, c4r),
                                             (3, c3l, c3r), (2, c2l, c2r)), start=1):
            cr_warp = flow_bilinear_sample(_to_nhwc(cr),
                                           _to_nhwc(up_flow) * WARP_SCALES[level])
            corr = correlation_cost(cl, cr_warp.permute(0, 3, 1, 2),
                                    *level_displacement(level))
            outputs = getattr(self, f"FlowPredictor_{i}")(
                torch.cat([corr, cl, up_flow, up_feat], dim=1))
            if level > 2:
                flow, up_flow, up_feat = outputs
            else:
                flow = self.ContextNetwork_0(outputs[1], outputs[0])
            flows.insert(0, flow)
        flow_ms = [_to_nhwc(f).reshape(batch, numsrc, f.shape[2], f.shape[3], 2)
                   for f in flows]
        return {"flow_ms": flow_ms}
