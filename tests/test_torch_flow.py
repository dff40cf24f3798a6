"""The port's PWC-Net and flow losses against the JAX package:
``models/layers.py::ConvTranspose`` with the converter's kernel flip,
``models/flow_net.py`` (predictor, context network, the whole net through
``ModelFactory``), the image-differentiable warp ``sample_patch_gather``,
``ops/flow_warp.py``, the L2 photometric loss, ``FlowWarpLossMultiScale``
and ``L2Regularizer``. (One flow train step is in
test_torch_flow_train.py.)

Inputs and weights come from seeded numpy RandomStates and go, as the
same arrays, to both sides (weights through ``xpt_mde_tpu_torch.convert``).
Each test states its tolerance and why.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.config import SCALE_WEIGHT_T1, SCALE_WEIGHT_T2
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.losses import photometric as jphoto
from xpt_mde_tpu.losses import total as jtotal
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.models.flow_net import ContextNetwork as JContextNetwork
from xpt_mde_tpu.models.flow_net import FlowPredictor as JFlowPredictor
from xpt_mde_tpu.ops import flow_warp as jflow
from xpt_mde_tpu.ops.warp import bilinear_sample as j_sample
from xpt_mde_tpu_torch import convert
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.losses import photometric as tphoto
from xpt_mde_tpu_torch.losses import total as ttotal
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.models.flow_net import ContextNetwork, FlowPredictor
from xpt_mde_tpu_torch.models.layers import ConvTranspose
from xpt_mde_tpu_torch.ops import flow_warp as tflow
from xpt_mde_tpu_torch.ops.kernels import warp as k1
from xpt_mde_tpu_torch.ops.warp import bilinear_sample, sample_patch_gather
from xpt_mde_tpu_torch.utils.precision import full_f32

KEYS = ["image", "intrinsic"]
RECIPE = {"flowL2": 1.0, "flow_reg": 4e-7}


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


def _fill(shapes, seed):
    """A flax variable tree shaped like ``shapes``, filled from numpy:
    kernels of unit gain, biases of 0.05."""
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        if path[-1].key == "kernel":
            return (rng.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        return (rng.randn(*sd.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# --------------------------------------------------------------------------
# layers and modules


@pytest.mark.parametrize("in_channels,height,width", [(2, 2, 8), (32, 8, 32), (32, 5, 3)])
def test_conv_transpose_and_converter_flip_match_flax(in_channels, height, width):
    """flax's ConvTranspose(2, (4, 4), strides 2, SAME) correlates the
    dilated input with its kernel unflipped; the port's conv_transpose2d
    flips, so the converter flips the kernel's spatial axes."""
    rng = np.random.RandomState(in_channels + height)
    x = rng.uniform(-1, 1, (2, height, width, in_channels)).astype(np.float32)
    jmod = fnn.ConvTranspose(2, (4, 4), strides=(2, 2), padding="SAME")
    variables = _fill(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                       jnp.asarray(x))), seed=1)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x)))
    assert ref.shape == (2, 2 * height, 2 * width, 2)

    tmod = ConvTranspose(in_channels, 2)
    kernel = np.asarray(variables["params"]["kernel"])
    key, weight = convert._map_leaf("params", ("ConvTranspose_0", "kernel"), kernel)
    assert key == "ConvTranspose_0.weight" and weight.shape == tuple(tmod.weight.shape)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(np.ascontiguousarray(weight)))
        tmod.bias.copy_(torch.from_numpy(np.asarray(variables["params"]["bias"])))
        got = _nhwc(tmod(_nchw(x)))
        # 1e-5: float32 sums of up to 4 * 32 products in another order
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
        # the plain transpose (no flip) is another function
        tmod.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
        assert not np.allclose(_nhwc(tmod(_nchw(x))), ref, atol=1e-3)


def test_conv_transpose_init_is_lecun_normal():
    mod = ConvTranspose(32, 2)
    mod.init_weights(torch.Generator().manual_seed(0))
    std = float(mod.weight.detach().std())
    # lecun normal: variance 1 / fan_in with fan_in = 32 * 4 * 4
    assert 0.8 / np.sqrt(512) < std < 1.2 / np.sqrt(512)
    assert float(mod.bias.detach().abs().max()) == 0.0


def _module_pair(jmodule, tmodule, x, seed, *extra):
    variables = _fill(jax.eval_shape(lambda: jmodule.init(
        jax.random.PRNGKey(0), jnp.asarray(x), *map(jnp.asarray, extra))), seed)
    convert.load_flax_variables(tmodule, variables)
    return variables


def test_flow_predictor_matches_jax():
    """Level-5 predictor input [corr 81, cl 128, up_flow 2, up_feat 2]:
    the dense concat order [x, c] and both upsamplings."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, 4, 16, 213)).astype(np.float32)
    jmod, tmod = JFlowPredictor(), FlowPredictor(213)
    variables = _module_pair(jmod, tmod, x, seed=4)
    ref = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_nchw(x))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        # 1e-4: float32 through 6 convs of up to 441 inputs, another order
        np.testing.assert_allclose(_nhwc(g), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_context_network_matches_jax():
    """Dilations up to 16 at 32x128 (flax SAME padding of a dilated conv)."""
    rng = np.random.RandomState(5)
    feat = rng.uniform(-1, 1, (1, 32, 128, 32)).astype(np.float32)
    flow = rng.uniform(-1, 1, (1, 32, 128, 2)).astype(np.float32)
    jmod, tmod = JContextNetwork(), ContextNetwork(32)
    variables = _module_pair(jmod, tmod, feat, 6, flow)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(feat), jnp.asarray(flow)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(feat), _nchw(flow)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_pwcnet_forward_matches_jax():
    """The whole net through ModelFactory at 64x128 with 2 sources,
    weights converted from the flax tree (every leaf mapped once, every
    torch tensor set): all four flows. Batch 2, not 1: only with two
    targets does repeat_interleave differ from Tensor.repeat."""
    batch, snippet, height, width = 2, 3, 64, 128
    x = np.random.RandomState(7).uniform(-1, 1, (batch, snippet, height, width, 3)
                                         ).astype(np.float32)
    jmodel = JModelFactory(KEYS, {"flow": "PWCNet"}, stereo=False).get_model()
    feats = {"image5d": jnp.asarray(x)}
    variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), feats)), 8)
    ref = jax.jit(lambda v, f: jmodel.apply(v, f))(variables, feats)

    tmodel = ModelFactory(KEYS, {"flow": "PWCNet"}, stereo=False, device="cpu").get_model()
    state = convert.flax_to_state_dict(variables, tmodel)
    assert len(state) == len(jax.tree_util.tree_leaves(variables)) == len(tmodel.state_dict())
    tmodel.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = tmodel({"image5d": torch.from_numpy(x)})
    assert set(got) == set(ref) == {"flow_ms"}
    for i, (g, r) in enumerate(zip(got["flow_ms"], ref["flow_ms"])):
        assert tuple(g.shape) == (batch, snippet - 1, height >> (i + 2), width >> (i + 2), 2)
        # rtol 1e-4 of the flow's scale: float32 through ~60 convs, 4 cost
        # volumes and 4 feature warps, summed in another order
        scale = float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4 * scale, rtol=1e-4,
                                   err_msg=f"flow_ms[{i}]")


# --------------------------------------------------------------------------
# warps


def _warp_case(seed, batch=2, numsrc=1, height=6, width=10, channels=16):
    rng = np.random.RandomState(seed)
    image = rng.uniform(-1, 1, (batch, numsrc, height, width, channels)).astype(np.float32)
    coords = np.stack([rng.uniform(-2, width + 1, (batch, numsrc, height * width)),
                       rng.uniform(-2, height + 1, (batch, numsrc, height * width))],
                      axis=2).astype(np.float32)
    coords[:, :, :, :4] = np.array([[0.0, width - 1.0, 2.0, 0.5],
                                    [0.0, 1.0, height - 1.0, -0.5]], np.float32)[None, None]
    return image, coords


@pytest.mark.parametrize("channels", [3, 16])
def test_sample_patch_gather_matches_jax_values_and_gradients(channels):
    """The image-differentiable warp against JAX's sampler at C=16 (its
    patch-gather path, PWC-Net's feature warp) and C=3 (its one-hot
    path): values, and the image and coordinate gradients against
    jax.vjp. Coordinates are generic (the warp has kinks at integers) but
    for a few in-frame, border-exact and outside ones. 1e-5: float32
    products and sums in another order."""
    image, coords = _warp_case(channels, channels=channels)
    cot = np.random.RandomState(9).uniform(-1, 1, image.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, c: j_sample(a, c), jnp.asarray(image), jnp.asarray(coords))
    ref = [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    timg = torch.from_numpy(image).requires_grad_(True)
    tcoords = torch.from_numpy(coords).requires_grad_(True)
    for fn in (sample_patch_gather, bilinear_sample):  # CPU routing: the same function
        got = fn(timg, tcoords)
        dimg, dcoords = torch.autograd.grad(got, (timg, tcoords), torch.from_numpy(cot))
        for g, r in zip((got, dimg, dcoords), ref):
            np.testing.assert_allclose(g.detach().numpy(), r, atol=1e-5, rtol=1e-5)


def test_flow_warps_match_jax():
    rng = np.random.RandomState(10)
    batch, numsrc, height, width = 2, 2, 16, 32
    source = rng.uniform(-1, 1, (batch, numsrc, height, width, 3)).astype(np.float32)
    flow_ms = [rng.uniform(-3, 3, (batch, numsrc, height >> s, width >> s, 2)).astype(np.float32)
               for s in range(4)]
    np.testing.assert_array_equal(
        tflow.flow_to_pixel_coords(torch.from_numpy(flow_ms[1])).numpy(),
        np.asarray(jflow.flow_to_pixel_coords(jnp.asarray(flow_ms[1]))))
    flat_src = source.reshape(batch * numsrc, height, width, 3)
    flat_flow = flow_ms[0].reshape(batch * numsrc, height, width, 2)
    for const_src in (True, False):
        np.testing.assert_allclose(
            tflow.flow_bilinear_sample(torch.from_numpy(flat_src), torch.from_numpy(flat_flow),
                                       const_src).numpy(),
            np.asarray(jflow.flow_bilinear_sample(jnp.asarray(flat_src),
                                                  jnp.asarray(flat_flow), const_src)),
            atol=1e-5, rtol=1e-5)
    before = k1.K1.launches
    got = tflow.flow_warp_multi_scale(torch.from_numpy(source),
                                      [torch.from_numpy(f) for f in flow_ms])
    ref = jflow.flow_warp_multi_scale(jnp.asarray(source), [jnp.asarray(f) for f in flow_ms])
    assert k1.K1.launches == before  # CPU tensors: the plain sampler
    for g, r in zip(got, ref):
        # 1e-5: the bilinear resizes and the warp in float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# losses


@pytest.mark.parametrize("reduce", [True, False])
def test_photometric_l2_matches_jax(reduce):
    rng = np.random.RandomState(11)
    synth = rng.uniform(-1, 1, (2, 3, 12, 20, 3)).astype(np.float32)
    synth[rng.rand(2, 3, 12, 20) < 0.2] = 0.0  # black = invalid warp
    target = rng.uniform(-1, 1, (2, 12, 20, 3)).astype(np.float32)
    ref = jphoto.PHOTOMETRIC_FNS["L2"](jnp.asarray(synth), jnp.asarray(target), reduce)
    got = tphoto.PHOTOMETRIC_FNS["L2"](torch.from_numpy(synth), torch.from_numpy(target),
                                       reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def _flow_inputs(seed, batch=2, height=32, width=64):
    rng = np.random.RandomState(seed)
    image5d = rng.uniform(-1, 1, (batch, 5, height, width, 3)).astype(np.float32)
    flow_ms = [rng.uniform(-2, 2, (batch, 4, height >> (s + 2), width >> (s + 2), 2))
               .astype(np.float32) for s in range(4)]
    weights = {"a": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32),
                     "bias": rng.randn(5).astype(np.float32)},
               "b": {"kernel": rng.randn(7, 2).astype(np.float32)}}
    return image5d, flow_ms, weights


@pytest.mark.parametrize("scale_weights", [SCALE_WEIGHT_T1, SCALE_WEIGHT_T2])
def test_flow_losses_match_jax(scale_weights):
    """flowL2 (the photometric L2 of flow-warped sources at 4 scales) and
    flow_reg (0.5 sum w^2) through loss_factory: each term, the total, and
    the gradient for the flows. 1e-5: float32 means of squared errors; the
    flow gradient 1e-4 of its norm, as the warps' coordinates are generic
    but carry float32 rounding through the resizes."""
    image5d, flow_ms, weights = _flow_inputs(12)
    intrinsic = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))  # read by JAX only
    leaves = jax.tree_util.tree_leaves(weights)
    jloss = j_loss_factory(KEYS, RECIPE, scale_weights, stereo=False, batch_size=4)
    tloss = loss_factory(KEYS, RECIPE, scale_weights, stereo=False, batch_size=4)
    assert list(tloss.loss_weights.items()) == list(jloss.loss_weights.items())

    def j_fn(*flows):
        preds = {"flow_ms": list(flows),
                 "regularize_weights": jax.tree_util.tree_map(jnp.asarray, weights)}
        return jloss(preds, {"image5d": jnp.asarray(image5d),
                             "intrinsic": jnp.asarray(intrinsic)})

    (ref_total, ref_by), vjp = jax.vjp(j_fn, *map(jnp.asarray, flow_ms))
    ref_grads = vjp((jnp.ones(()), {k: jnp.zeros(()) for k in ref_by}))
    flows = [torch.from_numpy(f).requires_grad_(True) for f in flow_ms]
    total, by = tloss({"flow_ms": flows,
                       "regularize_weights": [torch.from_numpy(w) for w in leaves]},
                      {"image5d": torch.from_numpy(image5d),
                       "intrinsic": torch.from_numpy(intrinsic)})
    assert set(by) == set(ref_by) == set(RECIPE)
    for key in RECIPE:
        np.testing.assert_allclose(float(by[key].detach()), float(ref_by[key]), atol=1e-6,
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), atol=1e-6, rtol=1e-5)
    for g, r in zip(torch.autograd.grad(total, flows), ref_grads):
        err = float(np.linalg.norm(g.numpy() - np.asarray(r)))
        assert err <= 1e-4 * float(np.linalg.norm(np.asarray(r))) + 1e-9


def test_l2_regularizer_matches_jax():
    image5d, _, weights = _flow_inputs(13, batch=3, height=8, width=16)
    features = {"image5d": image5d}
    ref = jtotal.L2Regularizer()(features, {"regularize_weights": weights}, {})
    leaves = [torch.from_numpy(w) for w in jax.tree_util.tree_leaves(weights)]
    got = ttotal.L2Regularizer()({"image5d": torch.from_numpy(image5d)},
                                 {"regularize_weights": leaves}, {})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert tuple(got.shape) == (3,)
    # without weights (an eval step): zeros, as in JAX
    np.testing.assert_array_equal(
        ttotal.L2Regularizer()({"image5d": torch.from_numpy(image5d)}, {}, {}).numpy(),
        np.asarray(jtotal.L2Regularizer()(features, {}, {})))
