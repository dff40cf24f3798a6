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

With a bfloat16 compute ``dtype`` (the JAX ``PWCNet(dtype=bfloat16)``):
the images, encoders and predictors run in bfloat16; every flow is
float32 (the flow conv and the upsampled flow, after its bfloat16
transpose conv, are cast up), the upsampled features stay bfloat16; the
feature warp multiplies bfloat16 features by float32 weights and gives
float32, which is cast to bfloat16 with the left features for the cost
volume, so K2, K3 and K4 take and give bfloat16.

On a spatial mesh (``parallel.spatial``) the encoders, predictors and
context network run on this rank's band of each level's rows (a level
too short to cut, as level 6, is computed whole by every rank); a level's
feature warp samples the whole right features at the band's pixels, and
its cost volume reads the warped features' rows ``md`` beyond the band
(their halo, or the whole map where md exceeds the band:
``spatial.correlation_rows``), K2, K3 and K4 taking the rows' offset.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from xpt_mde_tpu_torch.config import MAX_DISPLACEMENT
from xpt_mde_tpu_torch.models.layers import Conv, ConvTranspose, cast_parameters, to_compute
from xpt_mde_tpu_torch.ops.correlation import correlation_channels, correlation_cost
from xpt_mde_tpu_torch.ops.flow_warp import flow_bilinear_sample
from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.utils.precision import at_least_f32

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

    def __init__(self, in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        chans_in = in_channels
        index = 0
        for chans in ENCODER_CHANNELS:
            for stride in (2, 1, 1):
                setattr(self, f"Conv_{index}", Conv(chans_in, chans, 3, stride, dtype=dtype))
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
    upsamplings of the flow and of ``c`` (``ConvTranspose_0/1``). The
    flow and the upsampled flow come out float32 (or float64), ``c`` and
    the upsampled features in the compute dtype."""

    def __init__(self, in_channels: int, up: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        chans_in = in_channels
        for i, chans in enumerate(PREDICTOR_CHANNELS):
            setattr(self, f"Conv_{i}", Conv(chans_in, chans, dtype=dtype))
            chans_in += chans
        self.Conv_4 = Conv(chans_in, 32, dtype=dtype)
        self.Conv_5 = Conv(32, 2, use_activation=False, dtype=dtype)
        self.up = up
        if up:
            self.ConvTranspose_0 = ConvTranspose(2, 2, dtype)
            self.ConvTranspose_1 = ConvTranspose(32, 2, dtype)

    def forward(self, x: torch.Tensor):
        for i in range(len(PREDICTOR_CHANNELS)):
            x = torch.cat([x, getattr(self, f"Conv_{i}")(x)], dim=1)
        c = self.Conv_4(x)
        flow = at_least_f32(self.Conv_5(c))
        if not self.up:
            return flow, c
        return flow, at_least_f32(self.ConvTranspose_0(flow)), self.ConvTranspose_1(c)


class ContextNetwork(nn.Module):
    """Dilated refinement of the level-2 flow: ``Conv_0`` ... ``Conv_6``;
    the refinement is added to the flow in float32 (or float64)."""

    def __init__(self, in_channels: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        chans_in = in_channels
        for i, (chans, dilation) in enumerate(CONTEXT_LAYERS):
            setattr(self, f"Conv_{i}", Conv(chans_in, chans, dilation=dilation, dtype=dtype))
            chans_in = chans
        self.Conv_6 = Conv(chans_in, 2, use_activation=False, dtype=dtype)

    def forward(self, x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        for i in range(len(CONTEXT_LAYERS) + 1):
            x = getattr(self, f"Conv_{i}")(x)
        return at_least_f32(x) + flow


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class PWCNet(nn.Module):
    """PWC-Net on [B, S, H, W, 3] snippets (the last frame is the target),
    computing in ``dtype``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.encoder_l = PWCEncoder(dtype=dtype)
        self.encoder_r = PWCEncoder(dtype=dtype)
        # level 6 sees the cost volume only; levels 5..2 also the left
        # features, the upsampled flow and the upsampled predictor features
        in_channels = [correlation_channels(*level_displacement(6))]
        for level in (5, 4, 3, 2):
            in_channels.append(correlation_channels(*level_displacement(level))
                               + ENCODER_CHANNELS[level - 1] + 2 + 2)
        for i, chans in enumerate(in_channels):
            setattr(self, f"FlowPredictor_{i}", FlowPredictor(chans, up=i < 4, dtype=dtype))
        self.ContextNetwork_0 = ContextNetwork(32, dtype)

    def forward(self, image5d: torch.Tensor) -> dict:
        with cast_parameters(self):
            return self._flow_ms(image5d)

    def _flow_ms(self, image5d: torch.Tensor) -> dict:
        batch, snippet, height, width, channels = image5d.shape
        numsrc = snippet - 1
        cast = self.compute_dtype
        target = to_compute(cast, spatial.to_band(image5d[:, -1].permute(0, 3, 1, 2)))
        target = target.contiguous()
        sources = to_compute(cast, spatial.to_band(image5d[:, :-1].reshape(
            batch * numsrc, height, width, channels).permute(0, 3, 1, 2)))
        sources = sources.contiguous()
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
            md, stride = level_displacement(level)
            cr_rows, row_offset = spatial.correlation_rows(
                to_compute(cast, cr_warp.permute(0, 3, 1, 2)), md)
            corr = correlation_cost(cl, cr_rows, md, stride, row_offset)
            outputs = getattr(self, f"FlowPredictor_{i}")(
                torch.cat([corr, cl, to_compute(cast, up_flow), up_feat], dim=1))
            if level > 2:
                flow, up_flow, up_feat = outputs
            else:
                flow = self.ContextNetwork_0(outputs[1], outputs[0])
            flows.insert(0, flow)
        flow_ms = [_to_nhwc(f).reshape(batch, numsrc, f.shape[2], f.shape[3], 2)
                   for f in flows]
        return {"flow_ms": flow_ms}
