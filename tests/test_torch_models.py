"""Parity of the port's models with the JAX package: models/layers.py,
backbones/efficientnet.py, depth_net.py, pose_net.py, factory.py, and the
flax -> torch converter (convert.py).

Weights: the flax variable tree (from ``jax.eval_shape`` of ``init``) is
filled from a seeded numpy RandomState -- random BatchNorm statistics and
scales included, so a swapped mapping shows -- then converted into the
torch module. Inputs are seeded numpy arrays fed to both sides.
Tolerance atol/rtol 1e-5 for single layers and 1e-4 for whole nets:
float32 on both sides, with convolution sums in another order through up
to ~100 layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.models import layers as jlayers
from xpt_mde_tpu.models.backbones.efficientnet import EfficientNet as JEfficientNet
from xpt_mde_tpu.models.pose_net import PoseNetImproved as JPoseNetImproved
from xpt_mde_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.models import layers as tlayers
from xpt_mde_tpu_torch.models.backbones.efficientnet import EfficientNet
from xpt_mde_tpu_torch.models.pose_net import PoseNetImproved
from xpt_mde_tpu_torch.utils.precision import full_f32

RIGID_B0 = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
RIGID_B5 = {"depth": "EfficientNetB5", "camera": "PoseNetImproved"}
KEYS = ["image", "intrinsic"]


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


def random_variables(jax_module, *args, seed=0):
    """The module's flax variables, shaped by eval_shape and filled from
    numpy (no flax init is run)."""
    shapes = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), *args))
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(sd.shape[:-1])
            return (rng.randn(*sd.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("bias", "mean", "input_mean"):
            return (rng.randn(*sd.shape) * 0.05).astype(np.float32)
        return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)  # scale, var

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _image5d(seed, batch=1, height=32, width=64):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (batch, 5, height, width, 3)).astype(np.float32)


@pytest.mark.parametrize("kernel,stride,dilation,size", [
    (3, 2, 1, (16, 24)),   # even input: SAME pads (0, 1)
    (3, 2, 1, (15, 23)),   # odd input: (1, 1)
    (5, 2, 1, (16, 24)),   # (1, 2)
    (5, 2, 1, (9, 11)),
    (7, 2, 1, (16, 20)),
    (3, 1, 2, (10, 12)),
    (1, 1, 1, (6, 8)),
])
@pytest.mark.parametrize("use_activation", [True, False])
def test_conv_same_padding_matches_flax(kernel, stride, dilation, size, use_activation):
    x = np.random.RandomState(1).uniform(-1, 1, (2,) + size + (4,)).astype(np.float32)
    jconv = jlayers.Conv(6, kernel, stride, dilation, use_activation)
    variables = random_variables(jconv, jnp.asarray(x))
    ref = np.asarray(jconv.apply(variables, jnp.asarray(x)))
    tconv = tlayers.Conv(4, 6, kernel, stride, dilation, use_activation)
    load_flax_variables(tconv, variables)
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("method", ["nearest", "linear", "bilinear"])
def test_resize_layers_match_jax(method):
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jlayers.upsample_2x(jnp.asarray(x), method))
    np.testing.assert_allclose(tlayers.upsample_2x(torch.from_numpy(x), method).numpy(),
                               ref, atol=1e-5, rtol=1e-5)
    nchw = tlayers.upsample_2x_nchw(torch.from_numpy(x).permute(0, 3, 1, 2), method)
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5, rtol=1e-5)
    ref_like = np.zeros((2, 11, 4, 1), np.float32)
    np.testing.assert_allclose(
        tlayers.resize_like(torch.from_numpy(x), torch.from_numpy(ref_like)).numpy(),
        np.asarray(jlayers.resize_like(jnp.asarray(x), jnp.asarray(ref_like))),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tlayers.resize_hw(torch.from_numpy(x), 10, 14).numpy(),
        np.asarray(jlayers.resize_hw(jnp.asarray(x), 10, 14)), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        tlayers.upsample_2x(torch.from_numpy(x), "cubic")


def test_restack_and_activations_match_jax():
    x = _image5d(3, batch=2, height=4, width=6)
    np.testing.assert_array_equal(
        tlayers.restack_on_channels(torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.restack_on_channels(jnp.asarray(x))))
    logits = np.linspace(-12, 12, 101, dtype=np.float32)
    for name in ("InverseSigmoid", "Exponential"):
        np.testing.assert_allclose(
            tlayers.activation_factory(name)(torch.from_numpy(logits)).numpy(),
            np.asarray(jlayers.activation_factory(name)(jnp.asarray(logits))),
            rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tlayers.activation_factory("Softplus")


def test_efficientnet_b0_matches_flax():
    x = _image5d(4, batch=2)[:, -1]
    jnet = JEfficientNet("B0")
    variables = random_variables(jnet, jnp.asarray(x), seed=1)
    ref = jax.jit(lambda v, a: jnet.apply(v, a))(variables, jnp.asarray(x))
    tnet = load_flax_variables(EfficientNet("B0"), variables).eval()
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == 5 and tnet.out_channels == [16, 24, 40, 112, 320]
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("high_res", [False, True])
def test_posenet_improved_matches_flax(high_res):
    x = _image5d(5, batch=2, height=64, width=128)
    jnet = JPoseNetImproved(high_res)
    variables = random_variables(jnet, jnp.asarray(x), seed=2)
    ref = jnet.apply(variables, jnp.asarray(x))["pose"]
    tnet = load_flax_variables(PoseNetImproved(5, high_res), variables)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x))["pose"]
    assert tuple(got.shape) == (2, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-4)


def _rigid_pair(nets, height, width, seed):
    jmodel = JModelFactory(KEYS, nets, stereo=False).get_model()
    feats = {"image5d": jnp.zeros((1, 5, height, width, 3)),
             "intrinsic": jnp.zeros((1, 3, 3))}
    variables = random_variables(jmodel, feats, seed=seed)
    tmodel = ModelFactory(KEYS, nets, stereo=False, device="cpu").get_model().eval()
    return jmodel, variables, tmodel


def test_b5_converter_covers_every_leaf_and_forward_agrees():
    """Every flax leaf of the slice's full-width model maps to exactly one
    torch tensor, every torch tensor is set, and one forward agrees."""
    jmodel, variables, tmodel = _rigid_pair(RIGID_B5, 64, 128, seed=3)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    state = flax_to_state_dict(variables, tmodel)
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == n_leaves + n_bn == len(tmodel.state_dict())
    tmodel.load_state_dict(state, strict=True)

    x = _image5d(6, height=64, width=128)
    ref = jax.jit(lambda v, f: jmodel.apply(v, f))(variables, {"image5d": jnp.asarray(x)})
    with torch.inference_mode():
        got = tmodel({"image5d": torch.from_numpy(x)})
    for key in ("depth_ms", "disp_ms"):
        for r, g in zip(ref[key], got[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(ref["pose"]),
                               rtol=1e-4, atol=1e-5)


def test_converter_rejects_unused_missing_and_misshapen():
    _, variables, tmodel = _rigid_pair(RIGID_B0, 32, 64, seed=4)
    params = jax.tree_util.tree_map(np.asarray, variables)
    extra = {**params, "params": {**params["params"], "flownet": {"Conv_0": {
        "kernel": np.zeros((3, 3, 2, 2), np.float32)}}}}
    with pytest.raises(KeyError, match="flownet"):
        flax_to_state_dict(extra, tmodel)
    missing = {"params": params["params"]}  # no batch_stats
    with pytest.raises(KeyError, match="left unset"):
        flax_to_state_dict(missing, tmodel)
    posenet = dict(params["params"]["posenet"])
    posenet["Conv_0"] = {"Conv_0": {"kernel": np.zeros((3, 3, 15, 32), np.float32),
                                    "bias": posenet["Conv_0"]["Conv_0"]["bias"]}}
    bad = {**params, "params": {**params["params"], "posenet": posenet}}
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(bad, tmodel)


def test_factory_seeds_device_and_unported():
    a = ModelFactory(KEYS, RIGID_B0, stereo=False, device="cpu", seed=7).get_model()
    b = ModelFactory(KEYS, RIGID_B0, stereo=False, device="cpu", seed=7).get_model()
    c = ModelFactory(KEYS, RIGID_B0, stereo=False, device="cpu", seed=8).get_model()
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "posenet.Conv_0.Conv_0.weight"
    assert not torch.equal(sa[w], sc[w])
    # framework conv init: truncated normal, stddev 0.025 cut at 2 sigma
    assert float(sa[w].abs().max()) <= 0.05 and 0.015 < float(sa[w].std()) < 0.03
    assert all(t.device.type == "cpu" for t in sa.values())

    with pytest.raises(ValueError, match="compute_dtype"):  # bfloat16 and float32 only
        ModelFactory(KEYS, RIGID_B0, compute_dtype="float16")
    # the zoo builds as in JAX (test_torch_backbones.py and
    # test_torch_zoo.py hold it to flax); a name JAX does not know raises
    # ValueError in both, and so does a backbone that cannot take the
    # snippet's 15 channels as a pose net
    built = ModelFactory(KEYS, {"depth": "ResNet50V2", "camera": "PoseNetDeep"},
                         stereo=False, device="cpu").get_model()
    assert type(built.depthnet.backbone).__name__ == "ResNet50V2"
    assert type(built.posenet).__name__ == "PoseNetDeep"
    for nets, match in (({"camera": "PoseNetPreTrained"}, "wrong pose net name"),
                        ({"depth": "ResNet18"}, "wrong depth net name"),
                        ({"camera": "VGG16"}, "3 channels")):
        with pytest.raises(ValueError, match=match):
            ModelFactory(KEYS, nets, stereo=False, device="cpu").get_model()
        if "3 channels" not in match:
            jfactory = JModelFactory(KEYS, nets, stereo=False)
            with pytest.raises(ValueError, match=match):
                jfactory.get_model()
    # stereo keys build the stereo model (test_torch_stereo.py checks it)
    stereo = ModelFactory(KEYS + ["image_R", "intrinsic_R"], RIGID_B0, device="cpu").get_model()
    assert stereo.stereo and not stereo.stereo_pose


def test_factory_defaults_to_the_card(monkeypatch):
    factory = ModelFactory(KEYS, RIGID_B0, stereo=False)
    assert factory.device == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        factory.get_model()  # no silent fall-back to the CPU
