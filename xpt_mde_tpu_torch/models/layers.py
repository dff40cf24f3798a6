"""Shared conv building blocks (port of ``xpt_mde_tpu.models.layers``).

Framework defaults: LeakyReLU(0.1), truncated-normal (stddev 0.025)
kernel init, SAME padding. Conv modules run NCHW inside; the public
functions below keep the JAX package's NHWC layout.

SAME padding follows flax/TF: total = max((ceil(in/s) - 1) * s + k_eff - in, 0),
low side total // 2, high side the rest. A stride-2 k3 conv on even input
pads (0, 1) and a stride-2 k5 conv pads (1, 2), which ``padding=k // 2``
would get wrong, so :class:`Conv2dSame` pads explicitly.

The conv modules take a compute ``dtype``, as flax's ``dtype``: in
bfloat16 they cast the input, the weight and the bias to it at call time
(flax's ``promote_dtype``) and return bfloat16, while the parameters stay
float32, so autograd hands float32 gradients back to them. In float32
nothing is cast.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from xpt_mde_tpu_torch.utils.image import resize_image, resize_nchw

# the truncated standard normal on [-2, 2] has this std; flax's
# variance-scaling init divides by it
_TRUNC_STD = 0.87962566103423978


def to_compute(dtype: torch.dtype, x: torch.Tensor | None) -> torch.Tensor | None:
    """``x`` in the compute ``dtype`` (None stays None). A float32 module
    casts nothing, so it runs as it did before the compute dtype existed,
    on float64 inputs too."""
    return x if x is None or dtype == torch.float32 else x.to(dtype)


class ComputeCast:
    """Mixin of the conv modules: ``compute_dtype`` and the weight and bias
    in it. Inside :func:`cast_parameters` (the nets' forwards) they come
    from that block's one cast of all of them; under
    ``torch.inference_mode`` (the predict and eval steps) the cast copies
    are kept until a parameter changes (its version counter or storage),
    so a run of inference steps casts them once; else each call casts."""

    compute_dtype = torch.float32
    _cast_cache = None
    _block_cast = None

    def cast_params(self):
        weight, bias = self.weight, self.bias
        if self.compute_dtype == torch.float32:
            return weight, bias
        if self._block_cast is not None:
            return self._block_cast
        if not torch.is_inference_mode_enabled():
            return weight.to(self.compute_dtype), to_compute(self.compute_dtype, bias)
        key = tuple((t._version, t.data_ptr()) for t in (weight, bias) if t is not None)
        if self._cast_cache is None or self._cast_cache[0] != key:
            self._cast_cache = (key, (weight.to(self.compute_dtype),
                                      to_compute(self.compute_dtype, bias)))
        return self._cast_cache[1]


# each tensor of cast_parameters' block starts at a multiple of this many
# elements (128 bytes of bfloat16): cuDNN runs its tensor-core kernels only
# on aligned weights, and took older, slower ones for unaligned pieces
CAST_ALIGN = 64


def _packed(tensors, dtype: torch.dtype) -> torch.Tensor:
    """``tensors`` flattened into one ``dtype`` buffer, each starting
    CAST_ALIGN-aligned (zeros between): one concatenation, one cast."""
    pad = tensors[0].new_zeros(CAST_ALIGN)
    parts = []
    for t in tensors:
        parts.append(t.reshape(-1))
        if t.numel() % CAST_ALIGN:
            parts.append(pad[:-t.numel() % CAST_ALIGN])
    return torch.cat(parts).to(dtype)


def _unpacked(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    """The views of ``flat`` that :func:`_packed` laid out for ``shapes``."""
    views, start = [], 0
    for shape in shapes:
        numel = math.prod(shape)
        views.append(flat[start: start + numel].view(shape))
        start += numel + (-numel % CAST_ALIGN)
    return views


class _CastAll(torch.autograd.Function):
    """Tensors -> their casts to ``dtype``, through one packed buffer; the
    backward packs the cotangents the same way and casts them back in one
    go (slicing views with autograd would add a buffer-sized backward per
    tensor)."""

    @staticmethod
    def forward(ctx, dtype, *tensors):
        ctx.shapes = [t.shape for t in tensors]
        ctx.source_dtype = tensors[0].dtype
        return tuple(_unpacked(_packed(tensors, dtype), ctx.shapes))

    @staticmethod
    def backward(ctx, *grads):
        flat = _packed([g.contiguous() for g in grads], ctx.source_dtype)
        return (None, *_unpacked(flat, ctx.shapes))


@contextlib.contextmanager
def cast_parameters(net: nn.Module):
    """For the block, every conv of ``net`` that computes in a narrower
    dtype takes its weight and bias from one cast of them all: one
    concatenation and one cast forward, and in the backward one of each,
    where casting each tensor would launch a cast and its backward per
    tensor (~600 kernels a rigid train step). The values and gradients
    are those of casting each; each piece starts CAST_ALIGN-aligned. Under
    ``torch.inference_mode`` the modules' own cache serves instead."""
    convs = [m for m in net.modules()
             if isinstance(m, ComputeCast) and m.compute_dtype != torch.float32]
    if not convs or torch.is_inference_mode_enabled():
        yield
        return
    tensors = [t for m in convs for t in (m.weight, m.bias) if t is not None]
    pieces = iter(_CastAll.apply(convs[0].compute_dtype, *tensors))
    for m in convs:
        m._block_cast = (next(pieces), None if m.bias is None else next(pieces))
    try:
        yield
    finally:
        for m in convs:
            m._block_cast = None


def same_padding(size: int, kernel: int, stride: int,
                 dilation: int = 1) -> tuple[int, int]:
    """(low, high) SAME padding of one spatial axis, flax/TF convention."""
    effective = (kernel - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + effective - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(ComputeCast, nn.Conv2d):
    """``nn.Conv2d`` with flax/TF SAME padding, computed per input size.

    ``init_std`` selects the init :meth:`init_weights` draws: a truncated
    normal of that stddev (the framework's default conv), or, when None,
    flax's ``lecun_normal`` (the EfficientNet convs). ``dtype`` is the
    compute dtype (:func:`to_compute`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, init_std: float | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, dilation=dilation, groups=groups, bias=bias)
        self.init_std = init_std
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_compute(self.compute_dtype, x)
        weight, bias = self.cast_params()
        ph = same_padding(x.shape[-2], self.kernel_size[0], self.stride[0],
                          self.dilation[0])
        pw = same_padding(x.shape[-1], self.kernel_size[1], self.stride[1],
                          self.dilation[1])
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, weight, bias, self.stride,
                            (ph[0], pw[0]), self.dilation, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, weight, bias, self.stride, 0,
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


class ConvTranspose(ComputeCast, nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(features, (4, 4), strides=(2, 2), padding="SAME")``,
    PWC-Net's 2x upsampler.

    flax (``transpose_kernel=False``) dilates the input by the stride,
    pads it by (2, 2) and correlates it with an HWIO kernel WITHOUT
    flipping it; ``conv_transpose2d`` is the gradient of a conv, so it
    flips its [in, out, kh, kw] weight and pads the dilated input by
    k - 1 - padding. Hence ``padding=1``, and the converter stores
    ``weight[i, o, y, x] = kernel[3 - y, 3 - x, i, o]``. The output is
    (2H, 2W). Init: flax's ``lecun_normal`` over the kernel's fan-in
    (in * 4 * 4), zero bias. ``dtype`` is the compute dtype
    (:func:`to_compute`)."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, features, 4, stride=2, padding=1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_compute(self.compute_dtype, x)
        weight, bias = self.cast_params()
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding)

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
    The inner conv is named ``Conv_0`` like the flax parameter path; it
    computes in ``dtype``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, dilation: int = 1, use_activation: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2dSame(in_channels, features, kernel_size, strides,
                                 dilation, init_std=0.025, dtype=dtype)
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
