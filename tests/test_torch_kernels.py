"""Kernel K1 (``ops/kernels/warp.py`` + ``csrc/warp.cu``) against its plain
PyTorch version.

This file imports torch and numpy only, so it also runs on a GPU machine
without JAX. Tests marked ``gpu`` need a CUDA card and skip without one;
run them there with

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest.py configures JAX). Tolerance
1e-5 absolute: K1 and the plain version form the same float32 products;
only FMA contraction differs, a few ulp of values in [-1, 1].
"""

import numpy as np
import pytest
import torch

from xpt_mde_tpu_torch.ops.kernels import build
from xpt_mde_tpu_torch.ops.kernels import warp as k1
from xpt_mde_tpu_torch.ops.warp import bilinear_sample, bilinear_sample_plain
from xpt_mde_tpu_torch.utils.precision import full_f32

HEADLINE = [(128, 512), (64, 256), (32, 128), (16, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    with full_f32():
        yield torch.device("cuda")


def _case(batch, numsrc, height, width, seed, rows=2, device="cpu"):
    """Coords over in-frame, out-of-frame and border-exact positions and
    a mask with ~20% zeros."""
    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (batch, numsrc, height, width, 3)).astype(np.float32)
    u = rng.uniform(-4, width + 4, (batch, numsrc, 1, height * width))
    v = rng.uniform(-4, height + 4, (batch, numsrc, 1, height * width))
    coords = [u, v] + ([np.ones_like(u)] if rows == 3 else [])
    coords = np.concatenate(coords, axis=2).astype(np.float32)
    coords[:, :, 0, :6] = [0.0, width - 1.0, 0.0, width - 2.0, -1e-6, 3.5]
    coords[:, :, 1, :6] = [0.0, 0.0, height - 1.0, height - 2.0, 1.0, -0.5]
    mask = (rng.rand(batch, height, width, 1) > 0.2).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (image, coords, mask)]


def test_k1_checks_its_inputs_before_launching():
    image, coords, mask = _case(1, 2, 4, 8, seed=0)
    before = k1.K1.launches
    with pytest.raises(ValueError, match="CUDA"):
        k1.K1(image, coords, mask)
    with pytest.raises(ValueError, match="coords"):
        k1.K1(image, coords[:, :, :1], mask)
    with pytest.raises(ValueError, match="coords"):
        k1.K1(image, coords[:, :1], mask)
    with pytest.raises(ValueError, match="valid_mask"):
        k1.K1(image, coords, mask[:, :2])
    with pytest.raises(ValueError, match="image"):
        k1.K1(image[0], coords, mask)
    assert k1.K1.launches == before


def test_nvcc_missing_is_reported(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


@pytest.mark.gpu
@pytest.mark.parametrize("height,width", HEADLINE)
@pytest.mark.parametrize("rows", [2, 3])
def test_k1_matches_plain_at_headline_scales(cuda, height, width, rows):
    image, coords, mask = _case(8, 4, height, width, seed=height, rows=rows,
                                device=cuda)
    for m in (mask, None):
        before = k1.K1.launches
        got = k1.K1(image, coords, m)
        assert k1.K1.launches == before + 1
        ref = bilinear_sample_plain(image, coords, m)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5
        assert bool((got[ref == 0] == 0).all())


@pytest.mark.gpu
def test_cuda_routing_and_refusals(cuda):
    image, coords, mask = _case(2, 4, 16, 64, seed=1, device=cuda)
    before = k1.K1.launches
    got = bilinear_sample(image, coords, mask, const_src=True)
    assert k1.K1.launches == before + 1
    torch.testing.assert_close(got, bilinear_sample_plain(image, coords, mask),
                               atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError):
        bilinear_sample(image, coords, mask)  # the image-differentiable warp
    with pytest.raises(NotImplementedError, match="rigid train step"):
        k1.K1(image, coords.clone().requires_grad_(True), mask)
    with pytest.raises(ValueError, match="float32"):
        k1.K1(image.double(), coords, mask)
    with pytest.raises(ValueError, match="contiguous"):
        k1.K1(image.transpose(2, 3).contiguous().transpose(2, 3), coords, mask)
    assert k1.K1.launches == before + 1
