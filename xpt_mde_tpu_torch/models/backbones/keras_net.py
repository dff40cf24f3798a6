"""The base of the keras-twin backbones (ResNet50V2, MobileNetV2, VGG16,
DenseNet121, Xception, NASNet): one description of the net builds its
modules and runs it.

A backbone writes its graph once, in ``_net(x)``, with this class's
operations (``conv``, ``norm``, ``relu``, ``add``, ``cat``, the pads and
pools), in the JAX twin's order and with its flat keras layer names. The
constructor runs ``_net`` on a :class:`_Spec`, a stand-in that carries
only a channel count and a stride: ``conv`` and ``norm`` then create their
module under the given name (so the flax parameter path and the torch
state_dict key are the same) and return the output's spec; the other
operations pass specs through. The forward runs ``_net`` on the tensor,
where each operation computes. Taps come back as a list; their specs
give ``out_channels`` and are checked to sit at strides 2, 4, 8, 16, 32.

Every conv is bias-free unless asked, computes in the compute dtype and
draws flax's ``lecun_normal`` at init; every BatchNorm is
:class:`~xpt_mde_tpu_torch.models.layers.BatchNorm2d` with the eps and
momentum the backbone gives. In train mode the forward folds the bfloat16
norms' statistics in at its end (``fold_statistics_at_end``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from xpt_mde_tpu_torch.models.layers import (BatchNorm2d, Conv2dSame, avg_pool_same_excluding_pad,
                                             fold_statistics_at_end, max_pool_same, zero_pad)

TAP_STRIDES = [2, 4, 8, 16, 32]


class _Spec:
    """A tensor while the net is built: its channels and its stride."""

    def __init__(self, channels: int, stride: int):
        self.channels = channels
        self.stride = stride


class KerasNet(nn.Module):
    """A backbone built from its ``_net`` description; takes [B, C, H, W]
    (``in_channels`` C) and returns the 5 taps, NCHW, in the compute
    ``dtype``."""

    # BatchNorm epsilon and torch momentum (flax's 0.99 -> 0.01)
    bn_eps = 1e-3
    bn_momentum = 0.01

    def __init__(self, in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.in_channels = in_channels
        taps = self._net(_Spec(in_channels, 1))
        strides = [t.stride for t in taps]
        if strides != TAP_STRIDES:
            raise AssertionError(f"{type(self).__name__} taps at strides {strides}")
        self.out_channels = [t.channels for t in taps]

    def preprocess(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def _net(self, x):
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        with fold_statistics_at_end(self):
            return self._net(self.preprocess(x))

    # -- the operations: on a _Spec they build, on a tensor they compute

    @staticmethod
    def channels(x) -> int:
        return x.channels if isinstance(x, _Spec) else x.shape[1]

    def conv(self, x, name: str, features: int, kernel: int = 1, stride: int = 1,
             pad: str = "SAME", groups: int = 1, bias: bool = False):
        if isinstance(x, _Spec):
            self.add_module(name, Conv2dSame(x.channels, features, kernel, stride,
                                             groups=groups, bias=bias, dtype=self.compute_dtype,
                                             padding=pad))
            return _Spec(features, x.stride * stride)
        return self._modules[name](x)

    def depthwise(self, x, name: str, kernel: int, stride: int = 1, pad: str = "SAME"):
        channels = self.channels(x)
        return self.conv(x, name, channels, kernel, stride, pad, groups=channels)

    def norm(self, x, name: str):
        if isinstance(x, _Spec):
            self.add_module(name, BatchNorm2d(x.channels, self.compute_dtype, self.bn_eps,
                                              self.bn_momentum))
            return x
        return self._modules[name](x)

    @staticmethod
    def relu(x):
        return x if isinstance(x, _Spec) else F.relu(x)

    @staticmethod
    def relu6(x):
        return x if isinstance(x, _Spec) else F.relu6(x)

    @staticmethod
    def add(a, b):
        if isinstance(a, _Spec):
            if (a.channels, a.stride) != (b.channels, b.stride):
                raise AssertionError("adding tensors of different shapes")
            return a
        return a + b

    @staticmethod
    def cat(parts):
        if isinstance(parts[0], _Spec):
            return _Spec(sum(p.channels for p in parts), parts[0].stride)
        return torch.cat(parts, dim=1)

    @staticmethod
    def pad(x, top: int, bottom: int, left: int, right: int):
        """Explicit zero padding (``jnp.pad``); it moves no stride."""
        return x if isinstance(x, _Spec) else zero_pad(x, top, bottom, left, right)

    @staticmethod
    def subsample(x, offset: int = 0):
        """``x[:, offset::2, offset::2]`` (NHWC in JAX): the 1x1 stride-2
        max pool, and NASNet's shifted path."""
        if isinstance(x, _Spec):
            return _Spec(x.channels, x.stride * 2)
        return x[:, :, offset::2, offset::2]

    @staticmethod
    def max_pool(x, kernel: int, stride: int, same: bool = False):
        """flax ``max_pool``: VALID, or SAME with -inf pads."""
        if isinstance(x, _Spec):
            return _Spec(x.channels, x.stride * stride)
        return max_pool_same(x, kernel, stride) if same else F.max_pool2d(x, kernel, stride)

    @staticmethod
    def avg_pool(x, kernel: int, stride: int):
        """flax ``avg_pool`` VALID: explicit zero pads before it count."""
        if isinstance(x, _Spec):
            return _Spec(x.channels, x.stride * stride)
        return F.avg_pool2d(x, kernel, stride)

    @staticmethod
    def avg_pool_same(x, kernel: int = 3):
        """flax ``avg_pool(padding="SAME", count_include_pad=False)``, stride 1."""
        return x if isinstance(x, _Spec) else avg_pool_same_excluding_pad(x, kernel)


def tf_preprocess(x: torch.Tensor) -> torch.Tensor:
    """keras "tf"-mode ``preprocess_input``, x / 127.5 - 1, on the
    pipeline's [-1, 1] floats (the reference's quirk); any channel count."""
    return x / 127.5 - 1.0
