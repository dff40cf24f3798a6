"""Parity of the port's geometry with the JAX package: utils/se3.py,
utils/image.py and ops/camera.py.

Inputs come from a seeded numpy RandomState and go, as the same arrays,
to the JAX function and to its torch counterpart. Tolerance: atol/rtol
1e-5 unless stated -- both sides compute in float32 on the CPU and differ
only in summation order and libm (a few ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.ops import camera as jcam
from xpt_mde_tpu.utils import image as jimage
from xpt_mde_tpu.utils import se3 as jse3
from xpt_mde_tpu_torch.ops import camera as tcam
from xpt_mde_tpu_torch.utils import image as timage
from xpt_mde_tpu_torch.utils import se3 as tse3
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


def _both(fn_j, fn_t, *arrays, **kwargs):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kwargs)
    out_t = fn_t(*(torch.tensor(np.asarray(a)) for a in arrays), **kwargs)
    return np.asarray(out_j), out_t.numpy()


def _intrinsics(batch, height, width, rng):
    fx = rng.uniform(0.5, 1.0, batch) * width
    fy = rng.uniform(0.5, 1.0, batch) * width
    k = np.zeros((batch, 3, 3), np.float32)
    k[:, 0, 0], k[:, 1, 1], k[:, 2, 2] = fx, fy, 1.0
    k[:, 0, 1] = rng.uniform(-2, 2, batch)  # skew exercises the full inverse
    k[:, 0, 2] = width / 2 + rng.uniform(-3, 3, batch)
    k[:, 1, 2] = height / 2 + rng.uniform(-3, 3, batch)
    return k


def _poses(batch, numsrc, rng, scale=0.2):
    twists = rng.uniform(-scale, scale, (batch, numsrc, 6)).astype(np.float32)
    return np.array(jse3.twist_to_matrix(jnp.asarray(twists)))


@pytest.mark.parametrize("scale", [1.0, 1e-9])
def test_twist_to_matrix_matches_jax(scale):
    # 1e-9 hits the small-angle branch
    twists = np.random.RandomState(0).uniform(-scale, scale, (4, 3, 6)).astype(np.float32)
    twists[..., :3] = np.random.RandomState(1).uniform(-2, 2, (4, 3, 3))
    np.testing.assert_allclose(*_both(jse3.twist_to_matrix, tse3.twist_to_matrix,
                                      twists), **TOL)


def test_matrix_to_twist_and_invert_match_jax():
    mats = _poses(5, 4, np.random.RandomState(2), scale=1.0)
    mats[0, 0, :3, :3] = np.eye(3)  # exact identity: the small-theta branch
    np.testing.assert_allclose(*_both(jse3.matrix_to_twist, tse3.matrix_to_twist,
                                      mats), **TOL)
    np.testing.assert_allclose(*_both(jse3.invert_matrix, tse3.invert_matrix,
                                      mats), **TOL)


@pytest.mark.parametrize("size", [(16, 24), (3, 5), (64, 80), (8, 8)])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_resize_image_matches_jax(size, method):
    image = np.random.RandomState(3).uniform(-1, 1, (2, 3, 8, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(*_both(jimage.resize_image, timage.resize_image,
                                      image, *size, method=method), **TOL)


def test_multi_scale_like_and_safe_reciprocal_match_jax():
    rng = np.random.RandomState(4)
    image = rng.uniform(-1, 1, (2, 16, 32, 3)).astype(np.float32)
    pyramid = [np.zeros((2, 16 >> i, 32 >> i, 1), np.float32) for i in range(4)]
    got_j = jimage.multi_scale_like(jnp.asarray(image), [jnp.asarray(p) for p in pyramid])
    got_t = timage.multi_scale_like(torch.from_numpy(image),
                                    [torch.from_numpy(p) for p in pyramid])
    for a, b in zip(got_j, got_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), **TOL)

    depth = rng.uniform(-1e-5, 3.0, (2, 8, 8, 1)).astype(np.float32)
    depth[0, 0, :4, 0] = [0.0, 1e-5, 2e-5, -1.0]  # around the eps cut
    js = jimage.safe_reciprocal_ms([jnp.asarray(depth)])
    ts = timage.safe_reciprocal_ms([torch.from_numpy(depth)])
    np.testing.assert_allclose(np.asarray(js[0]), ts[0].numpy(), **TOL)


def test_camera_basics_match_jax():
    k = _intrinsics(3, 16, 24, np.random.RandomState(5))
    np.testing.assert_array_equal(np.asarray(jcam.pixel_grid(4, 6)),
                                  tcam.pixel_grid(4, 6).numpy())
    np.testing.assert_allclose(*_both(jcam.scale_intrinsics, tcam.scale_intrinsics,
                                      k, 4.0), **TOL)
    np.testing.assert_allclose(*_both(jcam.invert_intrinsics, tcam.invert_intrinsics,
                                      k), **TOL)


def test_step_by_step_chain_and_fused_reprojection_match_jax():
    rng = np.random.RandomState(6)
    batch, numsrc, height, width = 2, 3, 16, 24
    k = _intrinsics(batch, height, width, rng)
    depth = rng.uniform(1.0, 20.0, (batch, height, width, 1)).astype(np.float32)
    poses = _poses(batch, numsrc, rng)
    grid = np.asarray(jcam.pixel_grid(height, width))

    cam_j, cam_t = _both(jcam.pixel2cam, tcam.pixel2cam, grid, depth, k)
    np.testing.assert_allclose(cam_j, cam_t, **TOL)
    src_j, src_t = _both(jcam.transform_to_source, tcam.transform_to_source,
                         cam_j, poses)
    np.testing.assert_allclose(src_j, src_t, **TOL)
    pix_j, pix_t = _both(jcam.cam2pixel, tcam.cam2pixel, src_j, k)
    # pixel coordinates of order 10-100: a relative bound
    np.testing.assert_allclose(pix_j, pix_t, atol=1e-4, rtol=1e-5)

    fused_j, fused_t = _both(jcam.reproject_pixel_coords, tcam.reproject_pixel_coords,
                             depth, poses, k)
    assert fused_t.shape == (batch, numsrc, 2, height * width)
    np.testing.assert_allclose(fused_j, fused_t, atol=1e-4, rtol=1e-5)
    # the fused map and the chain agree up to float association
    np.testing.assert_allclose(fused_t, pix_t[:, :, :2], atol=1e-3, rtol=1e-4)
