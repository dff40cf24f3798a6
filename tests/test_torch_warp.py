"""K1's and K1-bwd's plain versions and the view synthesis against the
JAX package.

``ops.warp.bilinear_sample_plain`` (the CPU path and K1's oracle) is held
against both JAX samplers: ``xpt_mde_tpu.ops.warp.bilinear_sample`` and
the Pallas kernel ``bilinear_sample_const_src(mode="exact",
interpret=True)``, at 16x128 (the Pallas kernel's HW % 1024 rule), with
and without a mask, on scattered (spread 1.0) and coherent (spread 0.1)
coordinates. Tolerance atol/rtol 1e-5: the same float32 bilinear weights
on both sides, summed in another order (the Pallas "exact" mode splits
the image into three bf16 terms, ~1e-7). The coordinate gradient
(``warp_coord_grad_plain``, K1-bwd's oracle, and the autograd of the plain
sampler) is held against ``jax.vjp`` of both samplers the same way. The
kernels themselves are tested in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.ops.pallas.warp import bilinear_sample_const_src as j_pallas
from xpt_mde_tpu.ops.synthesize import synthesize_multi_scale as j_synth
from xpt_mde_tpu.ops.warp import bilinear_sample as j_sample
from xpt_mde_tpu.utils import se3 as jse3
from xpt_mde_tpu_torch.ops.kernels import warp as k1
from xpt_mde_tpu_torch.ops.synthesize import synthesize_multi_scale
from xpt_mde_tpu_torch.ops.warp import (bilinear_sample, bilinear_sample_plain,
                                        warp_coord_grad_plain)
from xpt_mde_tpu_torch.utils.precision import full_f32

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    # parity is checked in full float32: TF32 off for cuBLAS and cuDNN
    with full_f32():
        yield


def _case(batch=1, numsrc=2, height=16, width=128, channels=3, seed=0,
          spread=1.0):
    """The inputs of tests/test_pallas_warp.py: coords spanning in-bounds,
    out-of-bounds and border-exact pixels; a mask with ~20% zeros."""
    rng = np.random.RandomState(seed)
    image = (rng.rand(batch, numsrc, height, width, channels)
             .astype(np.float32) * 2 - 1)
    u = rng.uniform(-4, width + 4, (batch, numsrc, 1, height * width))
    v = rng.uniform(-4, height + 4, (batch, numsrc, 1, height * width))
    if spread < 1.0:
        gu, gv = np.meshgrid(np.arange(width), np.arange(height))
        grid = np.stack([gu.ravel(), gv.ravel()])[None, None]
        u = grid[:, :, :1] + (u - grid[:, :, :1]) * spread
        v = grid[:, :, 1:] + (v - grid[:, :, 1:]) * spread
    coords = np.concatenate([u, v], axis=2).astype(np.float32)
    # border-exact samples: u = W-1 and v = H-1 are invalid, u = v = 0 valid
    coords[:, :, 0, :8] = [0.0, width - 1.0, 0.0, width - 1.0, 3.0, -1e-6, 2.0, 5.5]
    coords[:, :, 1, :8] = [0.0, 0.0, height - 1.0, 3.0, height - 1.0, 2.0, -1.0, 4.0]
    mask = (rng.rand(batch, height, width, 1) > 0.2).astype(np.float32)
    return image, coords, mask


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("spread", [1.0, 0.1])
def test_plain_warp_matches_both_jax_samplers(use_mask, spread):
    image, coords, mask = _case(spread=spread)
    m = mask if use_mask else None
    got = bilinear_sample_plain(torch.from_numpy(image), torch.from_numpy(coords),
                                None if m is None else torch.from_numpy(m)).numpy()
    jm = None if m is None else jnp.asarray(m)
    ref_xla = np.asarray(j_sample(jnp.asarray(image), jnp.asarray(coords), jm))
    ref_pallas = np.asarray(j_pallas(jnp.asarray(image), jnp.asarray(coords), jm,
                                     mode="exact", interpret=True))
    np.testing.assert_allclose(got, ref_xla, **TOL)
    np.testing.assert_allclose(got, ref_pallas, **TOL)
    # invalid pixels are exactly black
    assert np.all(got[ref_xla == 0] == 0)


def test_plain_warp_homogeneous_coords_and_cpu_routing():
    image, coords, mask = _case(batch=2, numsrc=3, height=8, width=24, seed=1)
    coords3 = np.concatenate([coords, np.ones_like(coords[:, :, :1])], axis=2)
    ref = np.asarray(j_sample(jnp.asarray(image), jnp.asarray(coords3),
                              jnp.asarray(mask)))
    args = (torch.from_numpy(image), torch.from_numpy(coords3), torch.from_numpy(mask))
    before = k1.K1.launches
    # CPU tensors: the const-source warp takes the plain version, the
    # image-differentiable one the patch gather; K1 is not launched
    for got in (bilinear_sample_plain(*args),
                bilinear_sample(*args, const_src=True),
                bilinear_sample(*args)):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert k1.K1.launches == before


def _synth_case(seed, batch=2, numsrc=4, height=32, width=64):
    rng = np.random.RandomState(seed)
    source = rng.uniform(-1, 1, (batch, numsrc, height, width, 3)).astype(np.float32)
    k = np.tile(np.array([[0.6 * width, 0, width / 2], [0, 0.6 * width, height / 2],
                          [0, 0, 1]], np.float32), (batch, 1, 1))
    depth_ms = []
    for s in range(4):
        d = rng.uniform(2.0, 20.0, (batch, height >> s, width >> s, 1)).astype(np.float32)
        d[:, :2] = 0.0  # zero depth: masked target rows
        depth_ms.append(d)
    twists = rng.uniform(-0.05, 0.05, (batch, numsrc, 6)).astype(np.float32)
    return source, k, depth_ms, twists


@pytest.mark.parametrize("pose_kind", ["twist", "matrix"])
def test_synthesize_multi_scale_matches_jax(pose_kind):
    source, k, depth_ms, pose = _synth_case(7)
    if pose_kind == "matrix":
        pose = np.array(jse3.twist_to_matrix(jnp.asarray(pose)))
    ref = j_synth(jnp.asarray(source), jnp.asarray(k),
                  [jnp.asarray(d) for d in depth_ms], jnp.asarray(pose))
    got = synthesize_multi_scale(torch.from_numpy(source), torch.from_numpy(k),
                                 [torch.from_numpy(d) for d in depth_ms],
                                 torch.from_numpy(pose))
    for r, g, d in zip(ref, got, depth_ms):
        assert tuple(g.shape) == (2, 4) + d.shape[1:3] + (3,)
        # atol 5e-5: reprojected coords of 10-60 px carry ~1e-6 relative
        # float32 error (~1e-5 px) on either side, times image gradients
        # of up to ~2 per pixel
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5, rtol=1e-5)
        assert np.all(g.numpy()[:, :, :2] == 0)  # zero-depth rows are black


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("rows", [2, 3])
def test_coord_grad_matches_jax_vjp(use_mask, rows):
    image, coords, mask = _case()
    if rows == 3:
        coords = np.concatenate([coords, np.ones_like(coords[:, :, :1])], axis=2)
    grad_out = np.random.RandomState(2).uniform(-1, 1, image.shape).astype(np.float32)
    m = mask if use_mask else None
    jm = None if m is None else jnp.asarray(m)
    refs = {}
    for label, sampler in (("pallas", lambda i, c: j_pallas(i, c, jm, mode="exact",
                                                              interpret=True)),
                           ("xla", lambda i, c: j_sample(i, c, jm, const_src=True))):
        _, vjp = jax.vjp(sampler, jnp.asarray(image), jnp.asarray(coords))
        refs[label] = [np.asarray(g) for g in vjp(jnp.asarray(grad_out))]
    # the Pallas VJP gives the image no gradient: its contract, and K1-bwd's
    assert np.all(refs["pallas"][0] == 0)

    t_image, t_mask = torch.from_numpy(image), None if m is None else torch.from_numpy(m)
    plain = warp_coord_grad_plain(t_image, torch.from_numpy(coords), t_mask,
                                  torch.from_numpy(grad_out)).numpy()
    t_coords = torch.from_numpy(coords).requires_grad_(True)
    bilinear_sample_plain(t_image, t_coords, t_mask).backward(torch.from_numpy(grad_out))
    assert plain.shape == coords.shape
    if rows == 3:
        assert np.all(plain[:, :, 2] == 0)
    # 1e-5: |du|, |dv| <= 6 here (3 channels, |g| <= 1, |D| <= 2); the
    # same float32 products, summed in another order
    for got in (plain, t_coords.grad.numpy()):
        for ref in refs.values():
            np.testing.assert_allclose(got, ref[1], atol=1e-5, rtol=1e-5)
    # invalid pixels get no gradient
    invalid = np.all(bilinear_sample_plain(t_image, torch.from_numpy(coords),
                                           t_mask).numpy() == 0, axis=-1)
    assert np.all(plain[:, :, 0].reshape(invalid.shape)[invalid] == 0)


def test_plain_warp_gradcheck_in_float64():
    """The plain sampler's autograd is its true derivative in the coords,
    at points away from integer coordinates (where it has kinks)."""
    rng = np.random.RandomState(3)
    batch, numsrc, height, width = 1, 2, 5, 7
    image = torch.from_numpy(rng.uniform(-1, 1, (batch, numsrc, height, width, 3)))
    whole = np.stack([rng.randint(0, width - 1, (batch, numsrc, height * width)),
                      rng.randint(0, height - 1, (batch, numsrc, height * width))], axis=2)
    coords = torch.from_numpy(whole + rng.uniform(0.2, 0.8, whole.shape)).requires_grad_(True)
    mask = torch.from_numpy((rng.rand(batch, height, width, 1) > 0.2).astype(np.float64))
    assert torch.autograd.gradcheck(lambda c: bilinear_sample_plain(image, c, mask),
                                    (coords,), eps=1e-6, atol=1e-6)


def test_warp_const_src_function_wiring(monkeypatch):
    """``WarpConstSrc`` with its two kernels stood in for by their plain
    versions (the kernels run only on the card): K1 forward, K1-bwd for
    the coordinates, and no gradient for the image or the mask (the
    depth)."""
    calls = []
    monkeypatch.setattr(k1, "K1", lambda *a: calls.append("K1") or bilinear_sample_plain(*a))
    monkeypatch.setattr(k1, "K1_BWD",
                        lambda *a: calls.append("K1-bwd") or warp_coord_grad_plain(*a))
    image, coords, mask = (torch.from_numpy(a).requires_grad_(True) for a in _case())
    grad_out = torch.from_numpy(np.random.RandomState(4).uniform(
        -1, 1, tuple(image.shape)).astype(np.float32))
    out = k1.WarpConstSrc.apply(image, coords, mask)
    torch.testing.assert_close(out, bilinear_sample_plain(image, coords, mask))
    out.backward(grad_out)
    assert calls == ["K1", "K1-bwd"]
    assert image.grad is None and mask.grad is None
    torch.testing.assert_close(coords.grad, warp_coord_grad_plain(image, coords, mask, grad_out))
    with torch.inference_mode():  # an eval step: forward only
        k1.WarpConstSrc.apply(image, coords, mask)
    assert calls == ["K1", "K1-bwd", "K1"]
