"""Kernels K1 and K1-bwd (``ops/kernels/warp.py`` + ``csrc/warp.cu``)
against their plain PyTorch versions, and the launches of a train step.

This file imports torch and numpy only, so it also runs on a GPU machine
without JAX. Tests marked ``gpu`` need a CUDA card and skip without one;
run them there with

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest.py configures JAX). Tolerance
1e-5 absolute: each kernel and its plain version form the same float32
products; only FMA contraction differs, a few ulp of values in [-1, 1]
(K1) or of |du|, |dv| <= 6 (K1-bwd: 3 channels, |g| <= 1, |D| <= 2).
"""

import numpy as np
import pytest
import torch

from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.losses.photometric import photometric_loss_ssim
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.ops.kernels import build
from xpt_mde_tpu_torch.ops.kernels import warp as k1
from xpt_mde_tpu_torch.ops.warp import (bilinear_sample, bilinear_sample_plain,
                                        warp_coord_grad_plain)
from xpt_mde_tpu_torch.training import make_eval_step, make_train_step, optimizer_factory
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


def test_k1_bwd_checks_its_inputs_before_launching():
    image, coords, mask = _case(1, 2, 4, 8, seed=0)
    before = k1.K1_BWD.launches
    with pytest.raises(ValueError, match="CUDA"):
        k1.K1_BWD(image, coords, mask, torch.zeros_like(image))
    with pytest.raises(ValueError, match="grad_out"):
        k1.K1_BWD(image, coords, mask, image[:, :1])
    with pytest.raises(ValueError, match="coords"):
        k1.K1_BWD(image, coords[:, :, :1], mask, torch.zeros_like(image))
    assert k1.K1_BWD.launches == before


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
@pytest.mark.parametrize("height,width", HEADLINE)
@pytest.mark.parametrize("rows", [2, 3])
def test_k1_bwd_matches_plain_at_headline_scales(cuda, height, width, rows):
    image, coords, mask = _case(8, 4, height, width, seed=height + 1, rows=rows,
                                device=cuda)
    grad_out = torch.rand(image.shape, generator=torch.Generator().manual_seed(rows))
    grad_out = (grad_out * 2 - 1).to(cuda)
    for m in (mask, None):
        before = k1.K1_BWD.launches
        got = k1.K1_BWD(image, coords, m, grad_out)
        assert k1.K1_BWD.launches == before + 1
        ref = warp_coord_grad_plain(image, coords, m, grad_out)
        leaf = coords.clone().requires_grad_(True)
        bilinear_sample_plain(image, leaf, m).backward(grad_out)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-5
        assert float((got - leaf.grad).abs().max()) <= 1e-5
        if rows == 3:
            assert bool((got[:, :, 2] == 0).all())


@pytest.mark.gpu
def test_cuda_routing_and_refusals(cuda):
    image, coords, mask = _case(2, 4, 16, 64, seed=1, device=cuda)
    before = (k1.K1.launches, k1.K1_BWD.launches)
    got = bilinear_sample(image, coords, mask, const_src=True)
    torch.testing.assert_close(got, bilinear_sample_plain(image, coords, mask),
                               atol=1e-5, rtol=0)
    # differentiable: K1 forward, K1-bwd backward, no image or mask gradient
    image.requires_grad_(True)
    mask.requires_grad_(True)
    leaf = coords.clone().requires_grad_(True)
    bilinear_sample(image, leaf, mask, const_src=True).sum().backward()
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 2, before[1] + 1)
    assert image.grad is None and mask.grad is None
    ref = warp_coord_grad_plain(image.detach(), coords, mask.detach(), torch.ones_like(got))
    torch.testing.assert_close(leaf.grad, ref, atol=1e-5, rtol=0)
    image, mask = image.detach(), mask.detach()
    with pytest.raises(NotImplementedError):
        bilinear_sample(image, coords, mask)  # the image-differentiable warp
    with pytest.raises(ValueError, match="WarpConstSrc"):
        k1.K1(image, coords.clone().requires_grad_(True), mask)
    with pytest.raises(ValueError, match="float32"):
        k1.K1(image.double(), coords, mask)
    with pytest.raises(ValueError, match="contiguous"):
        k1.K1(image.transpose(2, 3).contiguous().transpose(2, 3), coords, mask)
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.gpu
def test_cuda_train_step_launches_both_kernels(cuda):
    """A train step of B0 at 64x128 on the card: 4 K1 and 4 K1-bwd
    launches (one per scale); an eval step: 4 K1 and no K1-bwd."""
    dataset = SyntheticDataset(batch_size=2, height=64, width=128, num_batches=1, seed=0)
    keys = dataset.config_keys()
    model = ModelFactory(keys, {"depth": "EfficientNetB0", "camera": "PoseNetImproved"},
                         stereo=False, device=cuda).get_model()
    loss = loss_factory(keys, {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}, SCALE_WEIGHT_T1,
                        stereo=False, batch_size=2)
    step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model))
    features = {k: torch.from_numpy(v).to(cuda) for k, v in next(iter(dataset)).items()}
    before = (k1.K1.launches, k1.K1_BWD.launches)
    metrics = step(features)
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 4, before[1] + 4)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    make_eval_step(model, loss)(features)
    assert (k1.K1.launches, k1.K1_BWD.launches) == (before[0] + 8, before[1] + 4)


@pytest.mark.gpu
def test_ssim_gradient_on_the_card_matches_the_cpu(cuda):
    """The SSIM pools' backward on the card: given a channels-last view,
    CUDA's avg_pool2d backward disagreed with the CPU's while its forward
    agreed; the loss now pools a contiguous NCHW copy."""
    rng = np.random.RandomState(3)
    synth = rng.uniform(-1, 1, (2, 4, 32, 64, 3)).astype(np.float32)
    synth[rng.rand(2, 4, 32, 64) < 0.2] = 0.0
    target = rng.uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    cot = rng.uniform(-1, 1, synth.shape).astype(np.float32)
    grads = []
    for device in (cuda, torch.device("cpu")):
        s = torch.from_numpy(synth).to(device).requires_grad_(True)
        out = photometric_loss_ssim(s, torch.from_numpy(target).to(device), reduce=False)
        out.backward(torch.from_numpy(cot).to(device))
        grads.append(s.grad.cpu())
    # float32 sums in another order
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-4)
