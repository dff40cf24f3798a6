"""Pose nets (port of ``xpt_mde_tpu.models.pose_net``): the snippet
[B, S, H, W, 3] stacked on channels -> a conv stack -> 1x1 conv to
numsrc*6 -> spatial mean -> [B, numsrc, 6] target->source twists.

- ``PoseNetBasic``: 7 stride-2 convs;
- ``PoseNetImproved``: 6 stride-2 levels and a 3-conv tail (one more
  stride-2 block at high resolution);
- ``PoseNetDeep``: a 5x5 conv, then 6 blocks each behind a 2x2 max pool:
  two 3x3 convs, then 3x3 -> 1x1 (half the width) -> 3x3 in the other
  five;
- ``PoseNetPreTrained``: a backbone on the 15-channel snippet, its
  stride-32 map max-pooled, then 3x3 -> 1x1 -> 3x3.

Every net gets one more stride-2 block at high resolution but
PoseNetBasic. The convs compute in ``dtype``; the mean is taken in
float32. On a spatial mesh (``parallel.spatial``) the stack runs on this
rank's band of rows and the mean is the whole map's."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from xpt_mde_tpu_torch.models.layers import Conv, cast_parameters, to_compute
from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.utils.precision import at_least_f32

# (features, kernel, stride) of the conv stacks, in flax's Conv_i order
_BASIC = [(16, 7, 2), (32, 5, 2), (64, 3, 2), (128, 3, 2),
          (256, 3, 2), (256, 3, 2), (256, 3, 2)]
_IMPROVED = [(32, 5, 2), (32, 5, 2), (64, 3, 2), (128, 3, 2),
             (256, 3, 2), (256, 3, 2), (256, 3, 1), (256, 3, 1)]
_HIGH_RES = [(512, 3, 2), (512, 3, 1), (512, 3, 1)]
# "pool" is a 2x2 stride-2 max pool (flax max_pool, VALID)
_DEEP = [(32, 5, 1), "pool", (32, 3, 1), (32, 3, 1)] + [
    layer for chans in (64, 64, 128, 256, 256)
    for layer in ("pool", (chans, 3, 1), (chans // 2, 1, 1), (chans, 3, 1))]
_PRETRAINED_TAIL = ["pool", (256, 3, 1), (128, 1, 1), (256, 3, 1)]


class _PoseConvStack(nn.Module):
    """The stack ``layers`` (convs, and max pools where an entry is
    "pool") on the input, or on ``backbone``'s stride-32 map, then the
    linear 1x1 pose head."""

    def __init__(self, snippet_len: int, layers, dtype: torch.dtype,
                 backbone: nn.Module | None = None):
        super().__init__()
        self.numsrc = snippet_len - 1
        self.compute_dtype = dtype
        self.backbone = backbone
        in_ch = snippet_len * 3 if backbone is None else backbone.out_channels[-1]
        self._layers = []
        n_convs = 0
        for layer in layers:
            if layer == "pool":
                self._layers.append(None)
                continue
            features, kernel, stride = layer
            conv = Conv(in_ch, features, kernel, stride, dtype=dtype)
            self.add_module(f"Conv_{n_convs}", conv)
            self._layers.append(conv)
            n_convs += 1
            in_ch = features
        head = Conv(in_ch, self.numsrc * 6, 1, use_activation=False, dtype=dtype)
        self.add_module(f"Conv_{n_convs}", head)
        self._layers.append(head)

    def forward(self, image5d: torch.Tensor):
        b, s, h, w, c = image5d.shape
        # channel index s*C + c, as restack_on_channels orders it
        x = spatial.to_band(
            to_compute(self.compute_dtype, image5d.permute(0, 1, 4, 2, 3).reshape(b, s * c, h, w)))
        with cast_parameters(self):
            if self.backbone is not None:
                x = self.backbone(x)[-1]  # the stride-32 map
            for layer in self._layers:
                x = _max_pool_2x2(x) if layer is None else layer(x)
        poses = spatial.mean_hw(at_least_f32(x))
        return {"pose": poses.reshape(-1, self.numsrc, 6)}


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """flax ``max_pool((2, 2), strides=(2, 2))``, VALID."""
    if spatial.current() is not None:
        return spatial.window(x, 2, 2, (0, 0), lambda rows: F.max_pool2d(rows, 2, 2))
    return F.max_pool2d(x, 2, 2)


class PoseNetBasic(_PoseConvStack):
    """7 stride-2 convs; ``high_res`` changes nothing, as in the JAX net."""

    def __init__(self, snippet_len: int, high_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(snippet_len, _BASIC, dtype)


class PoseNetImproved(_PoseConvStack):
    def __init__(self, snippet_len: int, high_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(snippet_len, _IMPROVED + (_HIGH_RES if high_res else []), dtype)


class PoseNetDeep(_PoseConvStack):
    """The deeper max-pool variant: block 1 two 3x3 convs, blocks 2-6
    3x3 -> 1x1 (C/2) -> 3x3, each block behind a 2x2 max pool."""

    def __init__(self, snippet_len: int, high_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(snippet_len, _DEEP + (_HIGH_RES if high_res else []), dtype)


class PoseNetPreTrained(_PoseConvStack):
    """A backbone (any net of ``backbones.BACKBONE_NAMES`` built on
    ``snippet_len * 3`` input channels) encodes the channel-stacked
    snippet; its stride-32 map is max-pooled 2x2, then 3x3 (256) -> 1x1
    (128) -> 3x3 (256) predict the twists. The backbone is the module
    ``backbone``, as the flax field is."""

    def __init__(self, backbone: nn.Module, snippet_len: int, high_res: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(snippet_len, _PRETRAINED_TAIL + (_HIGH_RES if high_res else []), dtype,
                         backbone)
