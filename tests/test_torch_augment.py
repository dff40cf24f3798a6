"""The port's augmentation (``training/augmentation.py``) against the JAX
package's, with the drawn parameters pinned: jax.random and
torch.Generator give different numbers, so each augmenter's ``apply``
takes the box, flag, gamma and saturation that both sides are given, and
the draws are checked against the JAX ranges separately.

Inputs from a seeded numpy RandomState. Tolerance 1e-6 unless stated:
float32 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.config import Config
from xpt_mde_tpu.training import augmentation as jaug
from xpt_mde_tpu_torch.config import AUGMENT_PROBS
from xpt_mde_tpu_torch.training import augmentation as taug
from xpt_mde_tpu_torch.utils.precision import full_f32

BOXES = [(0.0, 0.0, 1.0, 1.0),          # no crop: the identity
         (0.05, 0.0, 1.0, 1.0),         # one offset only
         (0.013, 0.071, 0.94, 0.987),
         (0.1, 0.1, 0.9, 0.9)]          # the largest crop


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


def _features(seed, batch=2, height=12, width=20):
    rng = np.random.RandomState(seed)
    pose = np.tile(np.eye(4, dtype=np.float32), (batch, 4, 1, 1))
    pose[..., :3, :] += rng.uniform(-0.2, 0.2, (batch, 4, 3, 4)).astype(np.float32)
    return {"image5d": rng.uniform(-1, 1, (batch, 5, height, width, 3)).astype(np.float32),
            "intrinsic": np.tile(np.array([[0.6 * width, 0.0, width / 2 + 0.3],
                                           [0.0, 0.6 * width, height / 2 - 0.2],
                                           [0.0, 0.0, 1.0]], np.float32), (batch, 1, 1)),
            "depth_gt": rng.uniform(0.0, 50.0, (batch, height, width, 1)).astype(np.float32),
            "pose_gt": pose}


def _stereo(feats):
    """``feats`` with right views: other images, intrinsics, GT depth and
    poses, and a stereo extrinsic with a rotation."""
    rng = np.random.RandomState(9)
    out = dict(feats)
    for key in ("image5d", "intrinsic", "depth_gt", "pose_gt"):
        value = np.asarray(feats[key])
        noise = rng.uniform(-0.1, 0.1, value.shape).astype(np.float32)
        if key == "image5d":
            noise = rng.uniform(-1, 1, value.shape).astype(np.float32) - value
        right = (value + noise).astype(np.float32)
        out[key + "_R"] = torch.from_numpy(right) if isinstance(feats[key], torch.Tensor) \
            else right
    t_lr = np.tile(np.eye(4, dtype=np.float32), (value.shape[0], 1, 1))
    t_lr[:, :3, :] += rng.uniform(-0.1, 0.1, (value.shape[0], 3, 4)).astype(np.float32)
    t_lr[:, 0, 3] = 0.54
    out["stereo_T_LR"] = torch.from_numpy(t_lr) if isinstance(feats["image5d"], torch.Tensor) \
        else t_lr
    return out


def _box32(box):
    return tuple(float(np.float32(b)) for b in box)


@pytest.mark.parametrize("box", BOXES)
def test_crop_resize_and_intrinsics_match_jax(box):
    feats = _features(0)
    jbox = jnp.asarray(box, jnp.float32)
    ref_image = np.asarray(jaug._crop_resize_5d(jnp.asarray(feats["image5d"]), jbox))
    ref_depth = np.asarray(jaug._crop_nearest(jnp.asarray(feats["depth_gt"]), jbox))
    ref_k = np.asarray(jaug.CropAndResize._adjust_intrinsic(
        jnp.asarray(feats["intrinsic"]), jbox, 12, 20))
    out = taug.CropAndResize().apply({k: torch.from_numpy(v) for k, v in feats.items()},
                                     _box32(box))
    # 1e-6: the same float32 weight matrices, contracted in another order
    np.testing.assert_allclose(out["image5d"].numpy(), ref_image, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(out["depth_gt"].numpy(), ref_depth)
    np.testing.assert_allclose(out["intrinsic"].numpy(), ref_k, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(out["pose_gt"].numpy(), feats["pose_gt"])


def test_crop_resize_at_full_width_matches_jax():
    """The headline width: 128 x 512 weight matrices."""
    image = np.random.RandomState(1).uniform(-1, 1, (1, 2, 128, 512, 3)).astype(np.float32)
    box = (0.031, 0.0917, 0.9472, 0.9905)
    ref = np.asarray(jaug._crop_resize_5d(jnp.asarray(image), jnp.asarray(box, jnp.float32)))
    got = taug.crop_resize_5d(torch.from_numpy(image), _box32(box)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


def test_flip_matches_jax():
    feats = _features(2)
    ref = jaug.HorizontalFlip()._flip({k: jnp.asarray(v) for k, v in feats.items()})
    tfeats = {k: torch.from_numpy(v) for k, v in feats.items()}
    out = taug.HorizontalFlip().apply(tfeats, True)
    for key in feats:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-6,
                                   rtol=1e-6, err_msg=key)
    assert taug.HorizontalFlip().apply(tfeats, False)["image5d"] is tfeats["image5d"]


@pytest.mark.parametrize("gamma,saturation", [(0.5, 1.5), (1.37, 0.62), (1.0, 1.0)])
def test_jitter_matches_jax(gamma, saturation):
    gamma, saturation = float(np.float32(gamma)), float(np.float32(saturation))
    image = _features(3)["image5d"]
    ref = np.asarray(jaug.ColorJitter._jitter(jnp.asarray(image), jnp.float32(gamma),
                                              jnp.float32(saturation)))
    out = taug.ColorJitter().apply({"image5d": torch.from_numpy(image)}, True, gamma,
                                   saturation)
    # 1e-6 plus 2e-6 relative: pow in float32 by two libms
    np.testing.assert_allclose(out["image5d"].numpy(), ref, atol=1e-6, rtol=2e-6)


def test_draws_stay_in_the_jax_ranges():
    """Over 2000 draws from a seeded CPU generator: boxes and flags in the
    JAX ranges, each offset nonzero and each flag set with probability
    ~0.2, and the chain draws nothing on the device."""
    generator = torch.Generator().manual_seed(0)
    crop, flip, jitter = taug.CropAndResize(0.2), taug.HorizontalFlip(0.2), taug.ColorJitter(0.2)
    boxes = np.array([crop.draw(generator) for _ in range(2000)])
    assert np.all((boxes[:, :2] >= 0) & (boxes[:, :2] <= 0.1))
    assert np.all((boxes[:, 2:] >= 0.9) & (boxes[:, 2:] <= 1.0))
    cropped = np.mean(np.concatenate([boxes[:, :2] > 0, boxes[:, 2:] < 1]), axis=0)
    assert np.all(np.abs(cropped - 0.2) < 0.03), cropped
    flips = np.mean([flip.draw(generator) for _ in range(2000)])
    jitters = np.array([jitter.draw(generator) for _ in range(2000)])
    assert abs(flips - 0.2) < 0.03 and abs(np.mean(jitters[:, 0]) - 0.2) < 0.03
    assert np.all((jitters[:, 1:] >= 0.5) & (jitters[:, 1:] <= 1.5))


def test_chain_factory_and_defaults():
    assert AUGMENT_PROBS == dict(Config().augment_probs)
    chain = taug.augmentation_factory(AUGMENT_PROBS)
    assert [type(a).__name__ for a in chain.augmenters] == list(AUGMENT_PROBS)
    feats = {k: torch.from_numpy(v) for k, v in _features(4).items()}
    a = chain(dict(feats), torch.Generator().manual_seed(5))
    b = chain(dict(feats), torch.Generator().manual_seed(5))
    for key in feats:  # one seed, one result
        assert torch.equal(a[key], b[key]), key
    assert all(bool(torch.isfinite(v).all()) for v in a.values())
    with pytest.raises(ValueError, match="Wrong augmentation"):
        taug.augmentation_factory({"Rotate": 0.5})
    # a stereo batch: the left views come out as the mono chain gives them
    stereo = _stereo(feats)
    c = chain(dict(stereo), torch.Generator().manual_seed(5))
    for key in feats:
        assert torch.equal(a[key], c[key]), key
    assert set(c) == set(stereo)


@pytest.mark.parametrize("box", BOXES[2:])
def test_stereo_crop_uses_one_box_for_both_views(box):
    """CropAndResize crops the right views with the left views' box,
    adjusts intrinsic_R and crops depth_gt_R, as the JAX package does."""
    feats = _stereo(_features(5))
    jbox = jnp.asarray(box, jnp.float32)
    out = taug.CropAndResize().apply({k: torch.from_numpy(v) for k, v in feats.items()},
                                     _box32(box))
    for sfx in ("", "_R"):
        ref_image = np.asarray(jaug._crop_resize_5d(jnp.asarray(feats["image5d" + sfx]), jbox))
        ref_k = np.asarray(jaug.CropAndResize._adjust_intrinsic(
            jnp.asarray(feats["intrinsic" + sfx]), jbox, 12, 20))
        ref_depth = np.asarray(jaug._crop_nearest(jnp.asarray(feats["depth_gt" + sfx]), jbox))
        # 1e-6, as the mono crop above
        np.testing.assert_allclose(out["image5d" + sfx].numpy(), ref_image, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(out["intrinsic" + sfx].numpy(), ref_k, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(out["depth_gt" + sfx].numpy(), ref_depth)
    for key in ("pose_gt", "pose_gt_R", "stereo_T_LR"):
        np.testing.assert_array_equal(out[key].numpy(), feats[key])


def test_stereo_flip_matches_jax():
    """HorizontalFlip mirrors both views and both intrinsics and conjugates
    pose_gt, pose_gt_R and stereo_T_LR; it does not swap the views."""
    feats = _stereo(_features(6))
    ref = jaug.HorizontalFlip()._flip({k: jnp.asarray(v) for k, v in feats.items()})
    out = taug.HorizontalFlip().apply({k: torch.from_numpy(v) for k, v in feats.items()}, True)
    assert set(out) == set(ref) == set(feats)
    for key in feats:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-6,
                                   rtol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out["image5d_R"].numpy(), feats["image5d_R"][..., ::-1, :])


def test_stereo_jitter_matches_jax():
    """ColorJitter jitters both views with the same gamma and saturation."""
    gamma, saturation = float(np.float32(1.21)), float(np.float32(0.77))
    feats = _stereo(_features(7))
    out = taug.ColorJitter().apply({k: torch.from_numpy(v) for k, v in feats.items()}, True,
                                   gamma, saturation)
    for key in ("image5d", "image5d_R"):
        ref = np.asarray(jaug.ColorJitter._jitter(jnp.asarray(feats[key]), jnp.float32(gamma),
                                                  jnp.float32(saturation)))
        # as test_jitter_matches_jax
        np.testing.assert_allclose(out[key].numpy(), ref, atol=1e-6, rtol=2e-6, err_msg=key)
    unjittered = taug.ColorJitter().apply({k: torch.from_numpy(v) for k, v in feats.items()},
                                          False, gamma, saturation)
    np.testing.assert_array_equal(unjittered["image5d_R"].numpy(), feats["image5d_R"])
