"""Parity of the port's rigid losses with the JAX package:
losses/photometric.py and the rigid part of losses/total.py.

Inputs from a seeded numpy RandomState, fed as the same arrays to both
sides. Tolerance atol/rtol 1e-5: float32 on both sides, reductions in
another order. Synthesized views carry exact zeros (invalid warps) so the
black-pixel mask is exercised.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.config import SCALE_WEIGHT_T1, SCALE_WEIGHT_T2
from xpt_mde_tpu.losses import photometric as jphoto
from xpt_mde_tpu.losses import total as jtotal
from xpt_mde_tpu_torch.losses import photometric as tphoto
from xpt_mde_tpu_torch.losses import total as ttotal
from xpt_mde_tpu_torch.utils.precision import full_f32

TOL = dict(atol=1e-5, rtol=1e-5)
RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
KEYS = ["image", "intrinsic", "depth_gt", "pose_gt"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # four intra-op threads: the workers beside this module share the
    # cores, and the CPU's summation order stays the same on any host
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    # parity is checked in full float32: TF32 off for cuBLAS and cuDNN
    with full_f32():
        yield


def _views(seed, batch=2, numsrc=3, height=12, width=20):
    rng = np.random.RandomState(seed)
    synth = rng.uniform(-1, 1, (batch, numsrc, height, width, 3)).astype(np.float32)
    synth[rng.rand(batch, numsrc, height, width) < 0.2] = 0.0  # black = invalid
    target = rng.uniform(-1, 1, (batch, height, width, 3)).astype(np.float32)
    return synth, target


@pytest.mark.parametrize("name", ["L1", "SSIM"])
@pytest.mark.parametrize("reduce", [True, False])
def test_photometric_matches_jax(name, reduce):
    synth, target = _views(0)
    ref = jphoto.PHOTOMETRIC_FNS[name](jnp.asarray(synth), jnp.asarray(target), reduce)
    got = tphoto.PHOTOMETRIC_FNS[name](torch.from_numpy(synth), torch.from_numpy(target),
                                       reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_error_mask_and_avg_pool_match_jax():
    synth, target = _views(1, height=5, width=7)
    np.testing.assert_array_equal(tphoto._error_mask(torch.from_numpy(synth)).numpy(),
                                  np.asarray(jphoto._error_mask(jnp.asarray(synth))))
    np.testing.assert_allclose(
        tphoto.avg_pool_3x3_same(torch.from_numpy(synth)).numpy(),
        np.asarray(jphoto.avg_pool_3x3_same(jnp.asarray(synth))), **TOL)


@pytest.mark.parametrize("weights", [SCALE_WEIGHT_T1, SCALE_WEIGHT_T2])
def test_merge_multi_scale_matches_jax(weights):
    losses = np.random.RandomState(2).rand(4, 3).astype(np.float32)
    ref = jtotal._merge_multi_scale([jnp.asarray(x) for x in losses],
                                    jnp.asarray(weights, jnp.float32))
    got = ttotal._merge_multi_scale([torch.from_numpy(x) for x in losses], weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _rigid_inputs(seed, batch=2, height=32, width=64):
    rng = np.random.RandomState(seed)
    features = {
        "image5d": rng.uniform(-1, 1, (batch, 5, height, width, 3)).astype(np.float32),
        "intrinsic": np.tile(np.array([[0.6 * width, 0, width / 2],
                                       [0, 0.6 * width, height / 2], [0, 0, 1]],
                                      np.float32), (batch, 1, 1)),
    }
    depth_ms = [rng.uniform(2.0, 20.0, (batch, height >> s, width >> s, 1))
                .astype(np.float32) for s in range(4)]
    preds = {"depth_ms": depth_ms,
             "disp_ms": [1.0 / d for d in depth_ms],
             "pose": rng.uniform(-0.05, 0.05, (batch, 4, 6)).astype(np.float32)}
    return features, preds


def _tree(x, to):
    if isinstance(x, dict):
        return {k: _tree(v, to) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, to) for v in x]
    return to(x)


@pytest.mark.parametrize("weights", [SCALE_WEIGHT_T1, SCALE_WEIGHT_T2])
def test_total_loss_matches_jax(weights):
    features, preds = _rigid_inputs(3)
    ref_total, ref_by = jtotal.loss_factory(KEYS, RECIPE, weights, stereo=False,
                                            batch_size=4)(
        _tree(preds, jnp.asarray), _tree(features, jnp.asarray))
    loss = ttotal.loss_factory(KEYS, RECIPE, weights, stereo=False, batch_size=4)
    got_total, got_by = loss(_tree(preds, torch.from_numpy),
                             _tree(features, torch.from_numpy))
    assert set(got_by) == set(ref_by) == set(RECIPE)
    # atol 5e-5 on L1/SSIM: the synthesized views differ by up to ~1e-5
    # per pixel (float32 reprojection, see test_torch_warp)
    for key in RECIPE:
        np.testing.assert_allclose(float(got_by[key]), float(ref_by[key]),
                                   atol=5e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(got_total), float(ref_total), atol=5e-5, rtol=1e-5)


def test_smootheness_matches_jax():
    features, preds = _rigid_inputs(4)
    target = features["image5d"][:, -1]
    target_ms = [np.ascontiguousarray(target[:, ::s, ::s]) for s in (1, 2, 4, 8)]
    ref = jtotal.SmoothenessLossMultiScale(jnp.asarray(SCALE_WEIGHT_T2, jnp.float32))(
        None, _tree(preds, jnp.asarray), {"target_ms": _tree(target_ms, jnp.asarray)})
    got = ttotal.SmoothenessLossMultiScale(SCALE_WEIGHT_T2)(
        None, _tree(preds, torch.from_numpy), {"target_ms": _tree(target_ms, torch.from_numpy)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_factory_drops_like_jax_and_raises_on_unported():
    mono = ["image", "intrinsic"]
    # dependency drop (stereo losses on mono data) and weight-0 drop, as in JAX
    recipe = dict(RECIPE, L1_R=0.5, stereoPose=1.0, SSIM=0.0)
    got = ttotal.loss_factory(mono, recipe, SCALE_WEIGHT_T1, stereo=False)
    ref = jtotal.loss_factory(mono, recipe, SCALE_WEIGHT_T1, stereo=False)
    assert list(got.loss_weights.items()) == list(ref.loss_weights.items())
    # every loss of the pool builds, as in JAX (the md2, md2cmb and moa
    # terms, once refused, are held to JAX in test_torch_zoo_losses.py)
    stereo_keys = mono + ["image_R", "intrinsic_R"]
    for keys, names in ((mono, ("md2SSIM", "md2cmbL1")),
                        (mono + ["image_R", "intrinsic_R", "stereo_T_LR"], ("moaL1",)),
                        (stereo_keys, ("L1_R", "smoothe_R")),
                        (stereo_keys + ["stereo_T_LR"], ("md2L1_R", "moaSSIM_R"))):
        for name in names:
            assert ttotal.check_loss_dependency(name, keys)
            got = ttotal.loss_factory(keys, {name: 1.0}, SCALE_WEIGHT_T1)
            ref = jtotal.loss_factory(keys, {name: 1.0}, SCALE_WEIGHT_T1)
            assert list(got.loss_weights) == list(ref.loss_weights) == [name]
            assert type(got.loss_objects[name]).__name__ \
                == type(ref.loss_objects[name]).__name__
    with pytest.raises(KeyError):  # a name outside the pool, as in JAX
        ttotal.loss_factory(mono, {"L3": 1.0}, SCALE_WEIGHT_T1)
    for name in ("L1", "L1_R", "stereoL1", "moaL1", "flow_reg"):
        for keys in (mono, stereo_keys, stereo_keys + ["stereo_T_LR"]):
            assert (ttotal.check_loss_dependency(name, keys)
                    == jtotal.check_loss_dependency(name, keys))


def test_stereo_features_raise():
    """Stereo features no longer raise (the stereo slice is ported; its
    terms are checked in test_torch_stereo.py): a mono recipe on stereo
    features gives the JAX package's losses, and so does a recipe of the
    terms once refused (moaL1 and md2cmbSSIM_R)."""
    features, preds = _rigid_inputs(5, height=16, width=32)
    features["image5d_R"] = features["image5d"][:, ::-1].copy()
    features["intrinsic_R"] = features["intrinsic"]
    loss = ttotal.loss_factory(KEYS, RECIPE, SCALE_WEIGHT_T1, stereo=True)
    got = loss(_tree(preds, torch.from_numpy), _tree(features, torch.from_numpy))
    ref = jtotal.loss_factory(KEYS, RECIPE, SCALE_WEIGHT_T1, stereo=True)(
        _tree(preds, jnp.asarray), _tree(features, jnp.asarray))
    np.testing.assert_allclose(float(got[0]), float(ref[0]), **TOL)
    stereo_keys = KEYS + ["image_R", "intrinsic_R", "stereo_T_LR"]
    recipe = {"moaL1": 1.0, "md2cmbSSIM_R": 0.5}
    assert list(ttotal.loss_factory(stereo_keys, recipe, SCALE_WEIGHT_T1).loss_weights) \
        == list(jtotal.loss_factory(stereo_keys, recipe, SCALE_WEIGHT_T1).loss_weights) \
        == list(recipe)
