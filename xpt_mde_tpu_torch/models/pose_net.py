"""Pose nets (port of ``xpt_mde_tpu.models.pose_net``): the snippet
[B, S, H, W, 3] stacked on channels -> a conv stack -> 1x1 conv to
numsrc*6 -> spatial mean -> [B, numsrc, 6] target->source twists.

- ``PoseNetBasic``: 7 stride-2 convs;
- ``PoseNetImproved``: 6 stride-2 levels and a 3-conv tail (one more
  stride-2 block at high resolution).

The convs compute in ``dtype``; the mean is taken in float32."""

from __future__ import annotations

import torch
import torch.nn as nn

from xpt_mde_tpu_torch.models.layers import Conv, cast_parameters, to_compute
from xpt_mde_tpu_torch.utils.precision import at_least_f32

# (features, kernel, stride) of the conv stacks, in flax's Conv_i order
_BASIC = [(16, 7, 2), (32, 5, 2), (64, 3, 2), (128, 3, 2),
          (256, 3, 2), (256, 3, 2), (256, 3, 2)]
_IMPROVED = [(32, 5, 2), (32, 5, 2), (64, 3, 2), (128, 3, 2),
             (256, 3, 2), (256, 3, 2), (256, 3, 1), (256, 3, 1)]
_HIGH_RES = [(512, 3, 2), (512, 3, 1), (512, 3, 1)]


class _PoseConvStack(nn.Module):
    """The conv stack ``layers``, then the linear 1x1 pose head."""

    def __init__(self, snippet_len: int, layers, dtype: torch.dtype):
        super().__init__()
        self.numsrc = snippet_len - 1
        self.compute_dtype = dtype
        in_ch = snippet_len * 3
        self._convs = []
        for features, kernel, stride in layers:
            self._add_conv(Conv(in_ch, features, kernel, stride, dtype=dtype))
            in_ch = features
        self._add_conv(Conv(in_ch, self.numsrc * 6, 1, use_activation=False, dtype=dtype))

    def _add_conv(self, conv: Conv) -> None:
        self.add_module(f"Conv_{len(self._convs)}", conv)
        self._convs.append(conv)

    def forward(self, image5d: torch.Tensor):
        b, s, h, w, c = image5d.shape
        # channel index s*C + c, as restack_on_channels orders it
        x = to_compute(self.compute_dtype, image5d.permute(0, 1, 4, 2, 3).reshape(b, s * c, h, w))
        with cast_parameters(self):
            for conv in self._convs:
                x = conv(x)
        poses = torch.mean(at_least_f32(x), dim=(2, 3))
        return {"pose": poses.reshape(-1, self.numsrc, 6)}


class PoseNetBasic(_PoseConvStack):
    """7 stride-2 convs; ``high_res`` changes nothing, as in the JAX net."""

    def __init__(self, snippet_len: int, high_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(snippet_len, _BASIC, dtype)


class PoseNetImproved(_PoseConvStack):
    def __init__(self, snippet_len: int, high_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(snippet_len, _IMPROVED + (_HIGH_RES if high_res else []), dtype)
