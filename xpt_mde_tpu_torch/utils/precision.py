"""Full float32 numerics on the card.

cuDNN runs float32 convolutions in TF32 by default, and cuBLAS may do
the same for matmuls when ``allow_tf32`` is set. TF32 keeps about three
decimal digits: enough to move reprojected pixels visibly and to break
the float32 parity with the JAX reference (which pins
``Precision.HIGHEST`` in its geometry). This context owns the setting:
the steps run inside :func:`full_f32`, and code that calls the geometry
or the convolutions directly enters it itself. :func:`at_least_f32` keeps
depth, pose and resampling in float32 or wider.

:func:`compute_dtype` maps ``Config.compute_dtype`` to the dtype the nets
compute in. In ``"bfloat16"`` (the default, as in the JAX package) each
conv casts its input, weight and bias to bfloat16 at call time while the
parameters stay float32, BatchNorm takes its statistics and normalizes
in float32, and the heads return float32 depth, pose and flow; TF32 stays
off either way, so the float32 math around the nets is exact float32.
"""

from __future__ import annotations

import contextlib

import torch


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` setting: ``"float32"`` or
    ``"bfloat16"``; anything else raises ``ValueError``."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or kept in float64: the dtype of the math that
    must not run in a narrower type (depth, pose, resampling)."""
    return x if x.dtype == torch.float64 else x.float()


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions inside the
    block, restoring both flags on exit."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
