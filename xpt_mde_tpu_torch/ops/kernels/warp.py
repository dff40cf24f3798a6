"""Kernels K1 and K1-bwd: the const-source bilinear warp on the card and its
coordinate gradient (``csrc/warp.cu``).

Port of ``xpt_mde_tpu/ops/pallas/warp.py``: K1 is the kernel, K1-bwd its
custom VJP. K1 computes exactly
:func:`xpt_mde_tpu_torch.ops.warp.bilinear_sample_plain` in float32 (the
JAX ``mode="exact"`` sampler; the TPU's int8 mode is not reproduced), and
K1-bwd exactly :func:`xpt_mde_tpu_torch.ops.warp.warp_coord_grad_plain`.
:class:`WarpConstSrc` joins them into one differentiable op: like the TPU
kernel it gives the image and the mask no gradient.

The target may be a band of h_t rows of the source's width (a spatial
mesh's band, ``parallel.spatial``): coords [B,N,2|3,h_t*W] in the source's
global pixel coordinates, mask [B,h_t,W,1], output [B,N,h_t,W,C]; the
neighbours are clipped to the source's H and W. h_t = H is the one-process
warp.
"""

from __future__ import annotations

import ctypes

import torch

from xpt_mde_tpu_torch.ops.kernels.build import load_library

SOURCE = "xpt_mde_tpu_torch/csrc/warp.cu"
REPLACES = "xpt_mde_tpu/ops/pallas/warp.py:135"
REPLACES_BWD = "xpt_mde_tpu/ops/pallas/warp.py:288"

# K1's launch: 128 pixels per warp; the block shrinks from 256 threads to
# 128 or 64 until the grid has at least two blocks per SM (csrc/warp.cu)
WARP_PIXELS = 128
FWD_THREADS = (256, 128, 64)


def fwd_threads(planes: int, hw: int, num_sms: int) -> int:
    """K1's threads per block for ``planes`` (B*N) planes of ``hw``
    pixels on a card with ``num_sms`` SMs: the largest of 256, 128 and 64
    that still gives two blocks per SM, else 64."""
    for threads in FWD_THREADS:
        block_pixels = threads // 32 * WARP_PIXELS
        if -(-hw // block_pixels) * planes >= 2 * num_sms:
            return threads
    return FWD_THREADS[-1]


def target_rows(image: torch.Tensor, pixel_coords: torch.Tensor) -> int:
    """The target's rows h_t: the coords' pixels over the source's width."""
    return pixel_coords.shape[-1] // image.shape[3]


def _check(image, pixel_coords, valid_mask, grad_out=None):
    """Raise unless the tensors are what the kernels take: image
    [B,N,H,W,C], coords [B,N,2|3,h_t*W] (h_t >= 1 target rows), mask
    [B,h_t,W,1] or None, grad_out [B,N,h_t,W,C]; all float32, contiguous,
    on one CUDA device."""
    if image.dim() != 5:
        raise ValueError(f"image must be [B,N,H,W,C], got {tuple(image.shape)}")
    batch, numsrc, _, width, channels = image.shape
    if (pixel_coords.dim() != 4 or pixel_coords.shape[2] not in (2, 3)
            or pixel_coords.shape[:2] != (batch, numsrc)
            or pixel_coords.shape[3] == 0 or pixel_coords.shape[3] % width):
        raise ValueError(f"coords must be [{batch},{numsrc},2|3,h_t*{width}], "
                         f"got {tuple(pixel_coords.shape)}")
    rows = target_rows(image, pixel_coords)
    tensors = [("image", image), ("pixel_coords", pixel_coords)]
    if valid_mask is not None:
        if tuple(valid_mask.shape) != (batch, rows, width, 1):
            raise ValueError(f"valid_mask must be [{batch},{rows},{width},1], "
                             f"got {tuple(valid_mask.shape)}")
        tensors.append(("valid_mask", valid_mask))
    if grad_out is not None:
        if tuple(grad_out.shape) != (batch, numsrc, rows, width, channels):
            raise ValueError(f"grad_out must be {(batch, numsrc, rows, width, channels)}, "
                             f"got {tuple(grad_out.shape)}")
        tensors.append(("grad_out", grad_out))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != image.device:
            raise ValueError(f"{name} must be on {image.device} (CUDA), got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


class _WarpEntry:
    """One C entry of ``warp.cu``, built at first use. ``launches``
    counts the launches this wrapper made."""

    def __init__(self, name: str, entry: str, n_pointers: int, n_ints: int):
        self.name = name
        self.launches = 0
        self.build_log = ""
        self._entry = entry
        self._n_pointers = n_pointers
        self._n_ints = n_ints
        self._fn = None

    def build(self):
        """Compile (or reuse) and load the library; return the C entry."""
        if self._fn is None:
            lib, self.build_log = load_library("warp", ("warp.cu",))
            fn = getattr(lib, self._entry)
            fn.argtypes = ([ctypes.c_void_p] * self._n_pointers
                           + [ctypes.c_int] * self._n_ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _launch(self, image, pixel_coords, *tensors, launch=()) -> None:
        """Call the entry with the tensors' pointers, the shapes, the
        ``launch`` ints and the current stream; raise on a CUDA error."""
        fn = self.build()
        batch, numsrc, height, width, channels = image.shape
        pointers = [None if t is None else t.data_ptr() for t in tensors]
        with torch.cuda.device(image.device):
            stream = torch.cuda.current_stream(image.device).cuda_stream
            err = fn(image.data_ptr(), pixel_coords.data_ptr(), *pointers,
                     batch, numsrc, height, width, target_rows(image, pixel_coords),
                     channels, pixel_coords.shape[2], *launch, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed with CUDA error {err}")
        self.launches += 1


class WarpKernel(_WarpEntry):
    """Launches K1."""

    def __init__(self):
        super().__init__("K1", "xpt_warp_const_src_fwd", 4, 8)

    def __call__(self, image: torch.Tensor, pixel_coords: torch.Tensor,
                 valid_mask: torch.Tensor | None = None) -> torch.Tensor:
        """:param image: [B,N,H,W,C]; :param pixel_coords: [B,N,2|3,h_t*W];
        :param valid_mask: optional [B,h_t,W,1]. All float32, contiguous,
        on one CUDA device. :return: [B,N,h_t,W,C]. Differentiable calls go
        through :class:`WarpConstSrc`."""
        _check(image, pixel_coords, valid_mask)
        if torch.is_grad_enabled() and pixel_coords.requires_grad:
            raise ValueError("K1 called directly drops the coordinate gradient: "
                             "use WarpConstSrc.apply (ops.warp.bilinear_sample)")
        batch, numsrc, _, width, channels = image.shape
        if batch * numsrc > 65535:
            raise ValueError(f"K1 takes B*N <= 65535 (one grid row per plane), "
                             f"got {batch * numsrc}")
        rows = target_rows(image, pixel_coords)
        out = image.new_empty((batch, numsrc, rows, width, channels))
        num_sms = torch.cuda.get_device_properties(image.device).multi_processor_count
        threads = fwd_threads(batch * numsrc, rows * width, num_sms)
        self._launch(image, pixel_coords, valid_mask, out, launch=(threads,))
        return out


class WarpBwdKernel(_WarpEntry):
    """Launches K1-bwd."""

    def __init__(self):
        super().__init__("K1-bwd", "xpt_warp_const_src_bwd", 5, 7)

    def __call__(self, image: torch.Tensor, pixel_coords: torch.Tensor,
                 valid_mask: torch.Tensor | None,
                 grad_out: torch.Tensor) -> torch.Tensor:
        """K1's inputs plus ``grad_out`` [B,N,h_t,W,C], the cotangent of its
        output. :return: dcoords [B,N,2|3,h_t*W] (du, dv[, 0])."""
        grad_out = grad_out.contiguous()
        _check(image, pixel_coords, valid_mask, grad_out)
        dcoords = torch.empty_like(pixel_coords)
        self._launch(image, pixel_coords, valid_mask, grad_out, dcoords)
        return dcoords


K1 = WarpKernel()
K1_BWD = WarpBwdKernel()


class WarpConstSrc(torch.autograd.Function):
    """K1 forward, K1-bwd backward. The image and mask cotangents are
    zero by contract (``None``): the image is training data and the mask
    (the depth) only selects pixels, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, image, pixel_coords, valid_mask):
        # references, not copies: the backward re-reads the image
        ctx.save_for_backward(image, pixel_coords, valid_mask)
        return K1(image, pixel_coords, valid_mask)

    @staticmethod
    def backward(ctx, grad_out):
        image, pixel_coords, valid_mask = ctx.saved_tensors
        dcoords = None
        if ctx.needs_input_grad[1]:
            dcoords = K1_BWD(image, pixel_coords, valid_mask, grad_out)
        return None, dcoords, None
