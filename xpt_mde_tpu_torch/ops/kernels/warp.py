"""Kernel K1: the const-source bilinear warp on the card (``csrc/warp.cu``).

Port of ``xpt_mde_tpu/ops/pallas/warp.py``, forward only. K1 computes
exactly :func:`xpt_mde_tpu_torch.ops.warp.bilinear_sample_plain` in
float32 (the JAX ``mode="exact"`` sampler; the TPU's int8 mode is not
reproduced). Like the TPU kernel it gives the image no gradient, and its
coordinate gradient is not written yet: a call that would need one
raises.
"""

from __future__ import annotations

import ctypes

import torch

from xpt_mde_tpu_torch.ops.kernels.build import load_library

SOURCE = "xpt_mde_tpu_torch/csrc/warp.cu"
REPLACES = "xpt_mde_tpu/ops/pallas/warp.py:135"


class WarpKernel:
    """Launches K1. ``launches`` counts the launches this wrapper made."""

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def build(self):
        """Compile (or reuse) and load the library; return its C entry."""
        if self._fn is None:
            lib, self.build_log = load_library("warp", ("warp.cu",))
            fn = lib.xpt_warp_const_src_fwd
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, image: torch.Tensor, pixel_coords: torch.Tensor,
                 valid_mask: torch.Tensor | None = None) -> torch.Tensor:
        """:param image: [B,N,H,W,C]; :param pixel_coords: [B,N,2|3,H*W];
        :param valid_mask: optional [B,H,W,1]. All float32, contiguous,
        on one CUDA device. :return: [B,N,H,W,C]."""
        if image.dim() != 5:
            raise ValueError(f"image must be [B,N,H,W,C], got {tuple(image.shape)}")
        batch, numsrc, height, width, channels = image.shape
        hw = height * width
        if (pixel_coords.dim() != 4 or pixel_coords.shape[2] not in (2, 3)
                or pixel_coords.shape[:2] != (batch, numsrc)
                or pixel_coords.shape[3] != hw):
            raise ValueError(f"coords must be [{batch},{numsrc},2|3,{hw}], "
                             f"got {tuple(pixel_coords.shape)}")
        tensors = [("image", image), ("pixel_coords", pixel_coords)]
        if valid_mask is not None:
            if tuple(valid_mask.shape) != (batch, height, width, 1):
                raise ValueError(f"valid_mask must be [{batch},{height},{width},1], "
                                 f"got {tuple(valid_mask.shape)}")
            tensors.append(("valid_mask", valid_mask))
        for name, t in tensors:
            if t.device.type != "cuda" or t.device != image.device:
                raise ValueError(f"{name} must be on {image.device} (CUDA), got {t.device}")
            if t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if torch.is_grad_enabled() and pixel_coords.requires_grad:
            raise NotImplementedError(
                "K1 has no coordinate gradient yet: its backward comes with the "
                "rigid train step (ROADMAP: 'Rigid train step')")
        fn = self.build()
        out = torch.empty_like(image)
        with torch.cuda.device(image.device):
            stream = torch.cuda.current_stream(image.device).cuda_stream
            err = fn(image.data_ptr(), pixel_coords.data_ptr(),
                     None if valid_mask is None else valid_mask.data_ptr(),
                     out.data_ptr(), batch, numsrc, height, width, channels,
                     pixel_coords.shape[2], stream)
        if err != 0:
            raise RuntimeError(f"K1 launch failed with CUDA error {err}")
        self.launches += 1
        return out


K1 = WarpKernel()
