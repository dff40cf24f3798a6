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

Inside a spatial mesh's step (``parallel.spatial.banded``) the convs, the
pools and the resizes run on this rank's band of rows: each takes the rows
its window reads from the neighbouring bands, and the image's own padding
only at the image's top and bottom (``parallel.spatial.window``). Outside
one they run the code below unchanged.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable

import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F

from xpt_mde_tpu_torch.parallel import spatial
from xpt_mde_tpu_torch.parallel.multihost import step_group
from xpt_mde_tpu_torch.utils.image import resize_image, resize_nchw
from xpt_mde_tpu_torch.utils.precision import at_least_f32

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
    """``nn.Conv2d`` with flax/TF SAME padding, computed per input size
    (``padding="VALID"``: none, as flax's VALID).

    ``init_std`` selects the init :meth:`init_weights` draws: a truncated
    normal of that stddev (the framework's default conv), or, when None,
    flax's ``lecun_normal`` (the backbones' convs). ``dtype`` is the
    compute dtype (:func:`to_compute`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = True, init_std: float | None = None,
                 dtype: torch.dtype = torch.float32, padding: str = "SAME"):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, dilation=dilation, groups=groups, bias=bias)
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
        self.init_std = init_std
        self.compute_dtype = dtype
        self.same = padding == "SAME"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_compute(self.compute_dtype, x)
        weight, bias = self.cast_params()
        if spatial.current() is not None and (self.kernel_size[0] > 1 or self.stride[0] > 1):
            return self._banded(x, weight, bias)
        if not self.same:
            return F.conv2d(x, weight, bias, self.stride, 0, self.dilation, self.groups)
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

    def _banded(self, x, weight, bias):
        """The conv of a band (or a whole map) under the band context: the
        SAME padding of the global rows and of the columns."""
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        ph = same_padding(spatial.global_rows(x), k, s, d) if self.same else (0, 0)
        pw = same_padding(x.shape[-1], self.kernel_size[1], self.stride[1],
                          self.dilation[1]) if self.same else (0, 0)

        def conv(rows):
            if any(pw):
                rows = F.pad(rows, (pw[0], pw[1], 0, 0))
            return F.conv2d(rows, weight, bias, self.stride, 0, self.dilation, self.groups)

        return spatial.window(x, (k - 1) * d + 1, s, ph, conv)

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


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode running statistics.

    Train mode normalizes with the biased batch statistics, as both
    frameworks do, and then updates the running statistics as flax does:
    ``ra = (1 - momentum) * ra + momentum * stat`` with the BIASED batch
    variance. (Torch would put the unbiased one into ``running_var``:
    n/(n-1) times larger, ~7% at the 16 values per channel of B0's
    stride-32 map at batch 2.) Eval mode is torch's, on the running
    statistics. ``momentum`` is torch's: flax's 0.99 (its default, and
    EfficientNet's) is 0.01, MobileNetV2's 0.999 is 0.001; ``eps`` is
    flax's ``epsilon`` (1e-3 in EfficientNet, MobileNetV2, Xception and
    NASNet, 1.001e-5 in ResNet50V2 and DenseNet121).

    With a bfloat16 compute ``dtype`` it is flax's BatchNorm with
    ``dtype=bfloat16`` and ``force_float32_reductions``: torch's batch
    norm on the bfloat16 input with the float32 parameters (its mixed-type
    form) takes the statistics once, in float32, normalizes in float32 and
    returns bfloat16, in one kernel; the running statistics stay float32,
    updated from the batch mean and the biased variance that the same call
    returns (as 1 / invstd^2 - eps). Inside :func:`fold_statistics_at_end`
    (the backbones' forwards) that update waits for the block's end, where
    all its BatchNorms fold theirs in together. Inside
    :func:`frozen_statistics` nothing is folded in.

    Inside a data-parallel step (``parallel.multihost.reducing_over`` a
    group of several ranks) train mode takes the statistics of the GLOBAL
    batch, as the JAX package's BatchNorm does on a batch sharded over a
    mesh: the ranks' per-channel (count, mean, biased variance), in
    float32 at least, are gathered by one all-reduce and combined, and
    the global mean and biased variance normalize every rank's rows and
    fold into every rank's running statistics; the backward sums its
    per-channel terms over the ranks too (:class:`_GlobalBatchNorm`).
    Outside one, or over a group of one, the paths above run unchanged."""

    # the batch statistics of the enclosing fold_statistics_at_end block
    _pending: list | None = None
    # set by frozen_statistics: normalize, but leave the running statistics
    _frozen = False

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-3, momentum: float = 0.01):
        super().__init__(channels, eps=eps, momentum=momentum)
        self.compute_dtype = dtype

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if self._frozen:
            return
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.mul_(keep).add_(mean, alpha=self.momentum)
            self.running_var.mul_(keep).add_(var, alpha=self.momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            group = step_group()
            if group is not None:
                return self._forward_global(x, group)
        if self.compute_dtype != torch.float32:
            return self._forward_f32_stats(x)
        if not self.training:
            return super().forward(x)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        if not self._frozen:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        return out

    def _forward_f32_stats(self, x: torch.Tensor) -> torch.Tensor:
        x = to_compute(self.compute_dtype, x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if self._frozen:
            return out
        if self._pending is not None:
            self._pending.append((self, mean.detach(), invstd.detach()))
        else:
            with torch.no_grad():
                var = invstd.detach().pow(-2).sub_(self.eps)
            self._update_running(mean.detach(), var)
        return out


    def _forward_global(self, x: torch.Tensor, group) -> torch.Tensor:
        """Train mode over the ranks of ``group``: the statistics of the
        global batch (see the class), the output in the compute dtype."""
        x = to_compute(self.compute_dtype, x)
        out, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps, group)
        self._update_running(mean, var)
        return out


class _GlobalBatchNorm(torch.autograd.Function):
    """Batch norm over the global batch of a group's ranks, each holding
    some of its rows, in float32 at least.

    Forward: each rank's per-channel mean and biased variance (two
    passes), gathered by one summing all-reduce of a row per rank and
    combined exactly (Chan's formula). Backward, as a fused batch norm's:
    with xhat the normalized input and N the global count,
    dx = w invstd (dy - (S_dy + xhat S_dyx) / N), where S_dy and S_dyx,
    the global sums of dy and dy xhat per channel, take one all-reduce;
    the weight and bias get this rank's own sums, which the step's
    gradient all-reduce adds up with the other ranks'."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        xf = at_least_f32(x)
        channels = xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        rows = xf.new_zeros(world, 2 * channels + 1)
        rows[rank] = torch.cat([mean, var, mean.new_full((1,), xf.numel() // channels)])
        dist.all_reduce(rows, group=group)
        means, variances, counts = rows[:, :channels], rows[:, channels:-1], rows[:, -1:]
        total = torch.sum(counts)
        mean = torch.sum(counts * means, dim=0) / total
        var = torch.sum(counts * (variances + torch.square(means - mean)), dim=0) / total
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(xhat, weight, invstd, total)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        out = xhat * weight[:, None, None] + bias[:, None, None]
        return out.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, grad_out, _grad_mean, _grad_var):
        xhat, weight, invstd, total = ctx.saved_tensors
        dy = at_least_f32(grad_out)
        sum_dy = torch.sum(dy, dim=(0, 2, 3))
        sum_dyx = torch.sum(dy * xhat, dim=(0, 2, 3))
        sums = torch.cat([sum_dy, sum_dyx])
        dist.all_reduce(sums, group=ctx.group)
        glob_dy, glob_dyx = sums.chunk(2)
        dx = (dy - (glob_dy[:, None, None] + xhat * glob_dyx[:, None, None]) / total) \
            * (weight * invstd)[:, None, None]
        return dx.to(grad_out.dtype), sum_dyx, sum_dy, None, None


def batch_norm(channels: int, dtype: torch.dtype = torch.float32, eps: float = 1e-3,
               momentum: float = 0.01) -> BatchNorm2d:
    return BatchNorm2d(channels, dtype, eps, momentum)


@contextlib.contextmanager
def fold_statistics_at_end(net: nn.Module):
    """Train-mode bfloat16 BatchNorms of ``net`` fold their batch
    statistics into the running ones at the block's end, all together in
    a few foreach operations (the same arithmetic as each one's
    ``_update_running``, ~6 kernels a norm otherwise), each with its own
    eps and momentum. Each norm runs once in the block (a backbone's
    forward)."""
    norms = [m for m in net.modules()
             if isinstance(m, BatchNorm2d) and m.compute_dtype != torch.float32]
    pending = []
    for norm in norms:
        norm._pending = pending
    try:
        yield
    finally:
        for norm in norms:
            norm._pending = None
    if pending:
        with torch.no_grad():
            norms, means, invstds = zip(*pending)
            variances = torch._foreach_pow(list(invstds), -2.0)
            torch._foreach_sub_(variances, [norm.eps for norm in norms])
            # one foreach add per momentum: alpha is a scalar of the call
            by_momentum: dict[float, list[int]] = {}
            for i, norm in enumerate(norms):
                by_momentum.setdefault(norm.momentum, []).append(i)
            for stat, values in (("running_mean", means), ("running_var", variances)):
                running = [getattr(norm, stat) for norm in norms]
                torch._foreach_mul_(running, [1.0 - norm.momentum for norm in norms])
                for momentum, index in by_momentum.items():
                    torch._foreach_add_([running[i] for i in index],
                                        [values[i] for i in index], alpha=momentum)


@contextlib.contextmanager
def frozen_statistics(net: nn.Module):
    """The BatchNorms of ``net`` normalize as they would but fold nothing
    into their running statistics: the recompute of a checkpointed
    backbone, whose forward already folded its batch statistics in."""
    norms = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    for norm in norms:
        norm._frozen = True
    try:
        yield
    finally:
        for norm in norms:
            norm._frozen = False


def zero_pad(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Explicit zero padding of [N, C, H, W] (``jnp.pad`` with zeros)."""
    return F.pad(x, (left, right, top, bottom))


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``max_pool(padding="SAME")``: the SAME pads of each axis
    (low = total // 2, the rest high; (0, 1) for k3 s2 at even sizes)
    filled with -inf, then a VALID max pool."""
    pw = same_padding(x.shape[-1], kernel, stride)
    if spatial.current() is not None:
        def pool(rows):
            if any(pw):
                rows = F.pad(rows, (pw[0], pw[1], 0, 0), value=float("-inf"))
            return F.max_pool2d(rows, kernel, stride)
        return spatial.window(x, kernel, stride,
                              same_padding(spatial.global_rows(x), kernel, stride), pool,
                              float("-inf"))
    ph = same_padding(x.shape[-2], kernel, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def avg_pool_same_excluding_pad(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """flax ``avg_pool(padding="SAME", count_include_pad=False)`` at stride
    1 and an odd ``kernel``: each output averages the in-frame values of
    its window only. As flax computes it: the window sums in ``x``'s dtype
    (summed in float32 and rounded once), divided by the float32 counts,
    so a bfloat16 input gives a float32 output (flax's counts are float32
    arrays, and the division promotes).

    The pool takes a contiguous NCHW copy: on a CUDA tensor in the
    channels-last layout that cuDNN's convolutions hand on, avg_pool2d's
    backward with this padding is wrong (torch 2.11 with CUDA 12.8: half
    the gradient's norm off while the forward agrees), as SSIM's was."""
    pad = kernel // 2
    if spatial.current() is not None:
        sums, counts = window_sums_and_counts(at_least_f32(x).contiguous(), kernel)
        return sums.to(x.dtype).to(sums.dtype) / counts
    sums = F.avg_pool2d(at_least_f32(x).contiguous(), kernel, 1, pad, divisor_override=1)
    ones = torch.ones((1, 1) + x.shape[-2:], dtype=sums.dtype, device=x.device)
    counts = F.avg_pool2d(ones, kernel, 1, pad, divisor_override=1)
    return sums.to(x.dtype).to(sums.dtype) / counts


def _in_frame(first: int, rows: int, size: int, kernel: int, like: torch.Tensor):
    """How many of the ``kernel`` positions centred on each of the rows
    ``first`` .. ``first + rows - 1`` lie in 0 .. ``size - 1``."""
    r = torch.arange(first, first + rows, device=like.device)
    lo = torch.clamp(r - kernel // 2, min=0)
    hi = torch.clamp(r + kernel // 2, max=size - 1)
    return (hi - lo + 1).to(like.dtype)


def window_sums_and_counts(x: torch.Tensor, kernel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The SAME stride-1 window sums of [N, C, H, W] under the band
    context, and each output's count of in-frame positions: the rows from
    the neighbouring bands count, the image's padding does not."""
    pad = kernel // 2
    sums = spatial.window(x, kernel, 1, (pad, pad),
                          lambda rows: F.avg_pool2d(rows, kernel, 1, (0, pad),
                                                    divisor_override=1))
    rows_in = _in_frame(spatial.first_row(sums), sums.shape[-2], spatial.global_rows(sums),
                        kernel, sums)
    cols_in = _in_frame(0, sums.shape[-1], sums.shape[-1], kernel, sums)
    return sums, rows_in[:, None] * cols_in[None, :]


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
    (:func:`to_compute`). Under the band context a band of h rows takes a
    row from each neighbour and gives its 2h output rows
    (``parallel.spatial.transpose_window``)."""

    def __init__(self, in_channels: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, features, 4, stride=2, padding=1)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = to_compute(self.compute_dtype, x)
        weight, bias = self.cast_params()
        if spatial.current() is not None:
            return spatial.transpose_window(
                x, self.kernel_size[0], self.stride[0], self.padding[0],
                lambda rows: F.conv_transpose2d(rows, weight, bias, self.stride,
                                                (0, self.padding[1])))
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
    return resize_nchw(x, spatial.global_rows(x) * 2, x.shape[-1] * 2,
                       _upsample_method(method))


def upsample_2x(x: torch.Tensor, method: str = "nearest") -> torch.Tensor:
    """2x spatial upsampling of [..., H, W, C]."""
    return resize_image(x, spatial.global_rows(x, -3) * 2, x.shape[-2] * 2,
                        _upsample_method(method))


def resize_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear resize of x's (H, W) to ref's, both [..., H, W, C]."""
    return resize_image(x, spatial.global_rows(ref, -3), ref.shape[-2], "bilinear")


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
