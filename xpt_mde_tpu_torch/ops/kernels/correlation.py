"""Kernels K2, K3 and K4: the PWC-Net correlation cost volume on the card
and its two input gradients (``csrc/correlation.cu``).

Port of ``xpt_mde_tpu/ops/pallas/correlation.py``: K2 is the forward
kernel, K3 and K4 the kernels of its custom VJP (dcl and dcr). All three
take and give NCHW float32 tensors and compute exactly
:func:`xpt_mde_tpu_torch.ops.correlation.correlation_cost_plain` and its
autograd, up to the order of the float32 sums. :class:`Correlation` joins
them into one differentiable op. The TPU's routing gate (``_pallas_pays``),
its VMEM gates and the dy-row pre-slicing of its backward are not ported:
every level takes these kernels.
"""

from __future__ import annotations

import ctypes

import torch

from xpt_mde_tpu_torch.ops.kernels.build import load_library

SOURCE = "xpt_mde_tpu_torch/csrc/correlation.cu"
REPLACES = {"K2": "xpt_mde_tpu/ops/pallas/correlation.py:68",
            "K3": "xpt_mde_tpu/ops/pallas/correlation.py:88",
            "K4": "xpt_mde_tpu/ops/pallas/correlation.py:119"}


def num_displacements(max_displacement: int, stride: int) -> int:
    """n, the displacements per axis: ``len(range(-md, md + 1, stride))``;
    the cost volume has n * n channels."""
    return len(range(-max_displacement, max_displacement + 1, stride))


def _check(feats, other, max_displacement, stride, grad_out=None):
    """Raise unless the kernels take these: two feature maps [B,C,H,W] of
    one shape, ``grad_out`` [B,n^2,H,W] or None, an int md >= 0 and an int
    stride >= 1; all float32, contiguous, on one CUDA device."""
    if not (isinstance(max_displacement, int) and max_displacement >= 0):
        raise ValueError(f"max_displacement must be an int >= 0, got {max_displacement!r}")
    if not (isinstance(stride, int) and stride >= 1):
        raise ValueError(f"stride must be an int >= 1, got {stride!r}")
    if feats.dim() != 4 or other.shape != feats.shape:
        raise ValueError(f"feature maps must be two [B,C,H,W] of one shape, got "
                         f"{tuple(feats.shape)} and {tuple(other.shape)}")
    tensors = [("features", feats), ("features", other)]
    if grad_out is not None:
        n = num_displacements(max_displacement, stride)
        batch, _, height, width = feats.shape
        if tuple(grad_out.shape) != (batch, n * n, height, width):
            raise ValueError(f"grad_out must be {(batch, n * n, height, width)}, "
                             f"got {tuple(grad_out.shape)}")
        tensors.append(("grad_out", grad_out))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != feats.device:
            raise ValueError(f"{name} must be on one CUDA device, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _CorrEntry:
    """One C entry of ``correlation.cu``, built at first use. ``launches``
    counts the launches this wrapper made."""

    def __init__(self, name: str, entry: str):
        self.name = name
        self.launches = 0
        self.build_log = ""
        self._entry = entry
        self._fn = None

    def build(self):
        """Compile (or reuse) and load the library; return the C entry."""
        if self._fn is None:
            lib, self.build_log = load_library("correlation", ("correlation.cu",))
            fn = getattr(lib, self._entry)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, first, second, out, feats_shape, max_displacement, stride):
        """Call the entry with the three pointers, the feature maps' shape,
        md, stride and the current stream; raise on a CUDA error."""
        fn = self.build()
        batch, channels, height, width = feats_shape
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = fn(first.data_ptr(), second.data_ptr(), out.data_ptr(),
                     batch, channels, height, width, max_displacement, stride, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {err}")
        self.launches += 1
        return out


class CorrKernel(_CorrEntry):
    """Launches K2."""

    def __init__(self):
        super().__init__("K2", "xpt_corr_fwd")

    def __call__(self, cl: torch.Tensor, cr: torch.Tensor, max_displacement: int,
                 stride: int) -> torch.Tensor:
        """:param cl, cr: [B,C,H,W] float32, contiguous, on one CUDA device.
        :return: [B,n^2,H,W]. Differentiable calls go through
        :class:`Correlation`."""
        _check(cl, cr, max_displacement, stride)
        if torch.is_grad_enabled() and (cl.requires_grad or cr.requires_grad):
            raise ValueError("K2 called directly drops the gradient: use "
                             "Correlation.apply (ops.correlation.correlation_cost)")
        n = num_displacements(max_displacement, stride)
        batch, _, height, width = cl.shape
        out = torch.empty((batch, n * n, height, width), dtype=cl.dtype, device=cl.device)
        return self._launch(cl, cr, out, cl.shape, max_displacement, stride)


class CorrGradKernel(_CorrEntry):
    """Launches K3 (the gradient of the left features, from the right
    ones) or K4 (the gradient of the right features, from the left ones)."""

    def __call__(self, grad_out: torch.Tensor, feats: torch.Tensor,
                 max_displacement: int, stride: int) -> torch.Tensor:
        """:param grad_out: [B,n^2,H,W], the cotangent of K2's output;
        :param feats: [B,C,H,W], cr for K3, cl for K4. :return: dcl (K3) or
        dcr (K4), [B,C,H,W]."""
        grad_out = grad_out.contiguous()
        _check(feats, feats, max_displacement, stride, grad_out)
        out = torch.empty_like(feats)
        return self._launch(grad_out, feats, out, feats.shape, max_displacement, stride)


K2 = CorrKernel()
K3 = CorrGradKernel("K3", "xpt_corr_bwd_cl")
K4 = CorrGradKernel("K4", "xpt_corr_bwd_cr")


class Correlation(torch.autograd.Function):
    """K2 forward; K3 and K4 backward, each only for an input that needs
    its gradient."""

    @staticmethod
    def forward(ctx, cl, cr, max_displacement, stride):
        ctx.save_for_backward(cl, cr)
        ctx.md_stride = (max_displacement, stride)
        return K2(cl, cr, max_displacement, stride)

    @staticmethod
    def backward(ctx, grad_out):
        cl, cr = ctx.saved_tensors
        md, stride = ctx.md_stride
        dcl = dcr = None
        if ctx.needs_input_grad[0]:
            dcl = K3(grad_out, cr, md, stride)
        if ctx.needs_input_grad[1]:
            dcr = K4(grad_out, cl, md, stride)
        return dcl, dcr, None, None
