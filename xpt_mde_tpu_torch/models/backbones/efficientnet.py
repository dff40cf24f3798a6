"""EfficientNet B0-B7 encoder (port of
``xpt_mde_tpu.models.backbones.efficientnet``).

Emits the 5 feature maps at strides (2, 4, 8, 16, 32), tapped at the ends
of stages 1, 2, 3, 5 and 7. Module names are the flax parameter path
names (``Conv_0``, ``BatchNorm_0``, ``MBConv_k/Conv_i``, ...) so the flax
-> torch converter maps paths one to one.

Kept from the reference: the input is the [-1, 1] image divided by 255
and normalized by the ``input_mean`` / ``input_var`` buffers (identity at
init; not updated in training, as in flax); BatchNorm eps 1e-3 and flax
momentum 0.99, which is torch momentum 0.01, with flax's running-variance
update (``layers.BatchNorm2d``). Depthwise convs are plain ``groups=C``
convs.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from xpt_mde_tpu_torch.models.layers import (Conv2dSame, batch_norm, fold_statistics_at_end,
                                             to_compute)
from xpt_mde_tpu_torch.parallel import spatial

__all__ = ["EfficientNet", "MBConv", "SqueezeExcite", "round_filters", "round_repeats"]

# (expand_ratio, channels, repeats, stride, kernel) for B0
_B0_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]

# (width_mult, depth_mult) per variant
_SCALING = {
    "B0": (1.0, 1.0), "B1": (1.0, 1.1), "B2": (1.1, 1.2), "B3": (1.2, 1.4),
    "B4": (1.4, 1.8), "B5": (1.6, 2.2), "B6": (1.8, 2.6), "B7": (2.0, 3.1),
}

_TAP_STAGES = (0, 1, 2, 4, 6)


def round_filters(filters: float, width_mult: float, divisor: int = 8) -> int:
    filters *= width_mult
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2dSame(channels, reduced_ch, 1, dtype=dtype)
        self.Conv_1 = Conv2dSame(reduced_ch, channels, 1, dtype=dtype)

    def forward(self, x):
        se = spatial.mean_hw(x, keepdim=True)  # the whole map's, on a spatial mesh
        se = self.Conv_1(F.silu(self.Conv_0(se)))
        return x * torch.sigmoid(se)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with SE and residual. Convs are named
    ``Conv_i`` in order (expand, depthwise, project), as in flax. Every
    conv and norm computes in ``dtype``."""

    def __init__(self, in_ch: int, out_ch: int, expand_ratio: int,
                 stride: int, kernel: int, se_ratio: float = 0.25,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = in_ch * expand_ratio
        convs = ([Conv2dSame(in_ch, mid, 1, bias=False, dtype=dtype)]
                 if expand_ratio != 1 else [])
        convs.append(Conv2dSame(mid, mid, kernel, stride, groups=mid, bias=False,
                                dtype=dtype))
        # (conv, norm) pairs followed by swish; plain lists keep the
        # registration to the flax-named attributes below
        self._pre = []
        for i, conv in enumerate(convs):
            norm = batch_norm(mid, dtype)
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}", norm)
            self._pre.append((conv, norm))
        self.SqueezeExcite_0 = SqueezeExcite(mid, max(1, int(in_ch * se_ratio)), dtype)
        project = Conv2dSame(mid, out_ch, 1, bias=False, dtype=dtype)
        norm = batch_norm(out_ch, dtype)
        self.add_module(f"Conv_{len(convs)}", project)
        self.add_module(f"BatchNorm_{len(convs)}", norm)
        self._project = (project, norm)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x):
        residual = x
        for conv, norm in self._pre:
            x = F.silu(norm(conv(x)))
        x = self.SqueezeExcite_0(x)
        conv, norm = self._project
        x = norm(conv(x))
        if self.residual:
            x = x + residual
        return x


class EfficientNet(nn.Module):
    """EfficientNet encoder; ``variant`` in B0..B7. Takes [B, 3, H, W] in
    [-1, 1] and returns [f2, f4, f8, f16, f32], NCHW, computed in
    ``dtype``."""

    def __init__(self, variant: str = "B5", dtype: torch.dtype = torch.float32,
                 in_channels: int = 3):
        if in_channels != 3:
            raise ValueError(f"EfficientNet takes 3 channels, not {in_channels}: its input "
                             "normalization has a 3-entry mean and variance")
        super().__init__()
        self.compute_dtype = dtype
        width_mult, depth_mult = _SCALING[variant]
        self.register_buffer("input_mean", torch.zeros(3))
        self.register_buffer("input_var", torch.ones(3))
        in_ch = round_filters(32, width_mult)
        self.Conv_0 = Conv2dSame(3, in_ch, 3, 2, bias=False, dtype=dtype)
        self.BatchNorm_0 = batch_norm(in_ch, dtype)
        self._blocks = []
        self._taps = set()
        self.out_channels = []
        for stage_idx, (expand, ch, reps, stride, kernel) in enumerate(_B0_STAGES):
            out_ch = round_filters(ch, width_mult)
            for rep in range(round_repeats(reps, depth_mult)):
                block = MBConv(in_ch, out_ch, expand, stride if rep == 0 else 1,
                               kernel, dtype=dtype)
                self.add_module(f"MBConv_{len(self._blocks)}", block)
                self._blocks.append(block)
                in_ch = out_ch
            if stage_idx in _TAP_STAGES:
                self._taps.add(len(self._blocks) - 1)
                self.out_channels.append(out_ch)

    def forward(self, x):
        mean = self.input_mean[None, :, None, None]
        std = torch.sqrt(self.input_var)[None, :, None, None]
        x = to_compute(self.compute_dtype, (x / 255.0 - mean) / std)
        taps = []
        with fold_statistics_at_end(self):
            x = F.silu(self.BatchNorm_0(self.Conv_0(x)))
            for i, block in enumerate(self._blocks):
                x = block(x)
                if i in self._taps:
                    taps.append(x)
        return taps
