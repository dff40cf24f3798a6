"""Shared conv building blocks (port of ``xpt_mde_tpu.models.layers``).

Framework defaults: LeakyReLU(0.1), truncated-normal (stddev 0.025)
kernel init, SAME padding. Conv modules run NCHW inside; the public
functions below keep the JAX package's NHWC layout.

SAME padding follows flax/TF: total = max((ceil(in/s) - 1) * s + k_eff - in, 0),
low side total // 2, high side the rest. A stride-2 k3 conv on even input
pads (0, 1) and a stride-2 k5 conv pads (1, 2), which ``padding=k // 2``
would get wrong, so :class:`Conv2dSame` pads explicitly.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from xpt_mde_tpu_torch.utils.image import resize_image, resize_nchw

# the truncated standard normal on [-2, 2] has this std; flax's
# variance-scaling init divides by it
_TRUNC_STD = 0.87962566103423978


def same_padding(size: int, kernel: int, stride: int,
                 dilation: int = 1) -> tuple[int, int]:
    """(low, high) SAME padding of one spatial axis, flax/TF convention."""
    effective = (kernel - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with flax/TF SAME padding, computed per input size.

    ``init_std`` selects the init :meth:`init_weights` draws: a truncated
    normal of that stddev (the framework's default conv), or, when None,
    flax's ``lecun_normal`` (the EfficientNet convs)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, init_std: float | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, dilation=dilation, groups=groups, bias=bias)
        self.init_std = init_std

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph = same_padding(x.shape[-2], self.kernel_size[0], self.stride[0],
                          self.dilation[0])
        pw = same_padding(x.shape[-1], self.kernel_size[1], self.stride[1],
                          self.dilation[1])
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ph[0], pw[0]), self.dilation, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        if self.init_std is None:
            fan_in = self.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        else:
            std = self.init_std
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(features, (4, 4), strides=(2, 2), padding="SAME")``,
    PWC-Net's 2x upsampler.

    flax (``transpose_kernel=False``) dilates the input by the stride,
    pads it by (2, 2) and correlates it with an HWIO kernel WITHOUT
    flipping it; ``conv_transpose2d`` is the gradient of a conv, so it
    flips its [in, out, kh, kw] weight and pads the dilated input by
    k - 1 - padding. Hence ``padding=1``, and the converter stores
    ``weight[i, o, y, x] = kernel[3 - y, 3 - x, i, o]``. The output is
    (2H, 2W). Init: flax's ``lecun_normal`` over the kernel's fan-in
    (in * 4 * 4), zero bias."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(in_channels, features, 4, stride=2, padding=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        in_channels, _, kh, kw = self.weight.shape
        std = math.sqrt(1.0 / (in_channels * kh * kw)) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        nn.init.zeros_(self.bias)


class Conv(nn.Module):
    """Conv with framework defaults: k3 s1 SAME, LeakyReLU(0.1),
    truncated-normal(0.025) init; ``use_activation=False`` is linear.
    The inner conv is named ``Conv_0`` like the flax parameter path."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1, use_activation: bool = True):
        super().__init__()
        self.Conv_0 = Conv2dSame(in_channels, features, kernel_size, strides,
                                 dilation, init_std=0.025)
        self.use_activation = use_activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.use_activation:
            x = F.leaky_relu(x, 0.1)
        return x


def _upsample_method(method: str) -> str:
    if method not in ("nearest", "linear", "bilinear"):
        raise ValueError(f"unknown upsample method: {method!r}")
    return "nearest" if method == "nearest" else "bilinear"


def upsample_2x_nchw(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """2x spatial upsampling of [N, C, H, W] (half-pixel centres)."""
    return resize_nchw(x, x.shape[-2] * 2, x.shape[-1] * 2,
                       _upsample_method(method))


def upsample_2x(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """2x spatial upsampling of [..., H, W, C]."""
    return resize_image(x, x.shape[-3] * 2, x.shape[-2] * 2,
                        _upsample_method(method))


def resize_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of x's (H, W) to ref's, both [..., H, W, C]."""
    return resize_image(x, ref.shape[-3], ref.shape[-2], "bilinear")


def resize_hw(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] to (height, width)."""
    return resize_image(x, height, width, "bilinear")


def restack_on_channels(image5d: torch.Tensor) -> torch.Tensor:
    """[B, S, H, W, C] -> [B, H, W, S*C]."""
    b, s, h, w, c = image5d.shape
    return image5d.permute(0, 2, 3, 1, 4).reshape(b, h, w, s * c)


class InverseSigmoidActivation:
    """depth = 1 / (sigmoid(x) + 0.01), range ~(0.99, 100) m."""

    def __call__(self, x):
        return 1.0 / (torch.sigmoid(x) + 0.01)


class ExponentialActivation:
    """depth = exp(sigmoid(x + 1) * 10 - 5)."""

    def __call__(self, x):
        return torch.exp(torch.sigmoid(x + 1.0) * 10.0 - 5.0)


def activation_factory(name: str) -> Callable:
    if name == "InverseSigmoid":
        return InverseSigmoidActivation()
    if name == "Exponential":
        return ExponentialActivation()
    raise ValueError(f"wrong activation name: {name}")
