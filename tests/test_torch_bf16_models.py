"""The port's modules in bfloat16, the JAX package's default compute dtype,
against the flax modules with ``dtype=jnp.bfloat16``: ``Conv``,
``ConvTranspose``, ``BatchNorm2d`` (train and eval, and the running
statistics after a train-mode call), one ``MBConv``, EfficientNetB0,
``DepthNetPretrained``, ``PoseNetImproved`` and ``PWCNet`` (the JAX one
built with ``use_pallas=True``, so its cost volume is the Pallas kernel's,
in interpret mode, and not the XLA fallback's); the factory's float32
parameters and the converter's refusal of narrower ones.

Weights: the flax variable tree filled from a seeded numpy RandomState
(``test_torch_models.random_variables``), converted into the port's
module; inputs are seeded numpy arrays fed to both sides.

Tolerance, the distance rule (:func:`assert_bf16_distance`): two
bfloat16 programs each sit about one rounding from the float32 result,
so the port's bfloat16 output is held to JAX's bfloat16 output by how far
JAX's bfloat16 output lies from JAX's float32 output on the same input:
elementwise, at most 2x that distance at the median and 4x at the
maximum, beside an absolute 1e-6 of the output's scale. Each output's
dtype equals JAX's: features bfloat16; depth, pose and flow float32.
"""

import contextlib
import copy

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import random_variables
from xpt_mde_tpu.models import layers as jlayers
from xpt_mde_tpu.models.backbones.efficientnet import EfficientNet as JEfficientNet
from xpt_mde_tpu.models.backbones.efficientnet import MBConv as JMBConv
from xpt_mde_tpu.models.depth_net import DepthNetPretrained as JDepthNetPretrained
from xpt_mde_tpu.models.flow_net import PWCNet as JPWCNet
from xpt_mde_tpu.models.layers import InverseSigmoidActivation
from xpt_mde_tpu.models.pose_net import PoseNetImproved as JPoseNetImproved
from xpt_mde_tpu_torch.config import FLOW_NET
from xpt_mde_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.models import layers as tlayers
from xpt_mde_tpu_torch.models.backbones import backbone_factory
from xpt_mde_tpu_torch.models.backbones.efficientnet import EfficientNet, MBConv
from xpt_mde_tpu_torch.models.depth_net import DepthNetPretrained
from xpt_mde_tpu_torch.models.flow_net import PWCNet
from xpt_mde_tpu_torch.models.layers import BatchNorm2d, activation_factory
from xpt_mde_tpu_torch.models.pose_net import PoseNetImproved
from xpt_mde_tpu_torch.utils.precision import compute_dtype, full_f32

BF16 = torch.bfloat16
MEDIAN_RATIO, MAX_RATIO, ATOL = 2.0, 4.0, 1e-6


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
    with full_f32():
        yield


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_bf16_distance(got, want_bf16, want_f32, what="", atol=ATOL):
    """The distance rule: |port bf16 - JAX bf16| elementwise at most
    MEDIAN_RATIO times |JAX bf16 - JAX f32| at the median and MAX_RATIO
    times at the maximum, each plus ``atol`` times the output's scale."""
    got, b, r = (_np(x).astype(np.float64) for x in (got, want_bf16, want_f32))
    assert got.shape == b.shape == r.shape, (what, got.shape, b.shape, r.shape)
    assert np.isfinite(got).all(), what
    err, ref = np.abs(got - b), np.abs(b - r)
    slack = atol * max(float(np.abs(r).max()), 1e-30)
    assert np.median(err) <= MEDIAN_RATIO * np.median(ref) + slack, (
        what, "median", float(np.median(err)), float(np.median(ref)))
    assert err.max() <= MAX_RATIO * ref.max() + slack, (
        what, "max", float(err.max()), float(ref.max()))


def _bf16_round(x: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _nchw(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _image5d(seed, batch=2, height=32, width=64):
    return np.random.RandomState(seed).uniform(
        -1, 1, (batch, 5, height, width, 3)).astype(np.float32)


def _flax_pair(make, *args, seed=0, mutable=False):
    """The flax module built in bfloat16 and in float32 on the same
    variables, each applied under jit: (variables, bf16 output, f32
    output), each output with its new batch_stats where ``mutable``.
    ``args`` are arrays, then static python values."""
    arrays = [a for a in args if isinstance(a, jax.Array)]
    static = args[len(arrays):]
    variables = random_variables(make(jnp.bfloat16), *args, seed=seed)
    outs = []
    for dtype in (jnp.bfloat16, jnp.float32):
        module = make(dtype)
        fn = jax.jit(lambda v, *a, module=module: module.apply(
            v, *a, *static, **({"mutable": ["batch_stats"]} if mutable else {})))
        outs.append(fn(variables, *arrays))
    return variables, outs[0], outs[1]


@pytest.mark.parametrize("kernel,stride,dilation,use_activation", [
    (3, 2, 1, True), (5, 2, 1, False), (3, 1, 2, True), (1, 1, 1, False)])
def test_bf16_conv_matches_flax(kernel, stride, dilation, use_activation):
    x = _bf16_round(np.random.RandomState(1).uniform(-1, 1, (2, 16, 24, 8)).astype(np.float32))
    variables, ref16, ref32 = _flax_pair(
        lambda d: jlayers.Conv(12, kernel, stride, dilation, use_activation, dtype=d),
        jnp.asarray(x, jnp.bfloat16))
    assert ref16.dtype == jnp.bfloat16
    tconv = load_flax_variables(tlayers.Conv(8, 12, kernel, stride, dilation, use_activation,
                                             dtype=BF16), variables)
    got = _nhwc(tconv(_nchw(x, BF16)))
    assert got.dtype == BF16 and tconv.Conv_0.weight.dtype == torch.float32
    assert_bf16_distance(got, ref16, ref32, "conv")


def test_bf16_conv_transpose_matches_flax():
    """PWC-Net's 2x upsampler: a float32 input (the flow) cast to
    bfloat16, as the flax module's promote_dtype does."""
    x = np.random.RandomState(2).uniform(-2, 2, (2, 6, 10, 2)).astype(np.float32)

    class Up(nn.Module):  # the converter flips kernels under a ConvTranspose_* path
        dtype: object

        @nn.compact
        def __call__(self, a):
            return nn.ConvTranspose(2, (4, 4), strides=(2, 2), padding="SAME",
                                    dtype=self.dtype, param_dtype=jnp.float32)(a)

    variables, ref16, ref32 = _flax_pair(Up, jnp.asarray(x))
    tconv = torch.nn.Module()
    tconv.ConvTranspose_0 = tlayers.ConvTranspose(2, 2, BF16)
    load_flax_variables(tconv, variables)
    got = _nhwc(tconv.ConvTranspose_0(_nchw(x)))
    assert got.dtype == BF16 and ref16.dtype == jnp.bfloat16
    assert_bf16_distance(got, ref16, ref32, "conv transpose")


@pytest.mark.parametrize("train", [True, False])
def test_bf16_batch_norm_matches_flax(train):
    """Statistics and normalization in float32, bfloat16 out, float32
    running statistics updated with the biased variance."""
    x = _bf16_round(np.random.RandomState(3).normal(0.3, 2.0, (2, 6, 10, 16)).astype(np.float32))

    def make(dtype):
        return nn.BatchNorm(use_running_average=not train, momentum=0.99, epsilon=1e-3,
                            dtype=dtype, param_dtype=jnp.float32)

    variables, (ref16, state16), (ref32, _) = _flax_pair(
        make, jnp.asarray(x, jnp.bfloat16), mutable=True)
    norm = BatchNorm2d(16, BF16)
    load_flax_variables(norm, variables)
    norm.train(train)
    got = _nhwc(norm(_nchw(x, BF16)))
    assert got.dtype == BF16 and ref16.dtype == jnp.bfloat16
    assert_bf16_distance(got, ref16, ref32, "batch norm")
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {**variables, **state16}),
                              norm)
    for key in ("running_mean", "running_var"):
        stat = getattr(norm, key)
        assert stat.dtype == torch.float32
        # float32 statistics of the same bfloat16 values, summed in another order
        np.testing.assert_allclose(stat.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("expand,stride,kernel,in_ch,out_ch", [
    (6, 1, 3, 16, 16),   # expand, depthwise, SE, project, residual
    (1, 2, 5, 16, 24)])  # no expansion, stride 2
def test_bf16_mbconv_matches_flax_in_train_mode(expand, stride, kernel, in_ch, out_ch):
    x = _bf16_round(np.random.RandomState(4).uniform(-1, 1, (2, 12, 16, in_ch))
                    .astype(np.float32))
    variables, (ref16, state16), (ref32, _) = _flax_pair(
        lambda d: JMBConv(out_ch, expand, stride, kernel, dtype=d),
        jnp.asarray(x, jnp.bfloat16), True, seed=5, mutable=True)
    block = load_flax_variables(MBConv(in_ch, out_ch, expand, stride, kernel, dtype=BF16),
                                variables).train()
    got = _nhwc(block(_nchw(x, BF16)))
    assert got.dtype == BF16 and ref16.dtype == jnp.bfloat16
    assert_bf16_distance(got, ref16, ref32, "mbconv")
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {**variables, **state16}),
                              block)
    for key, value in block.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=key)


@pytest.mark.parametrize("train", [False, True])
def test_bf16_efficientnet_b0_matches_flax(train):
    x = _image5d(6)[:, -1]
    # the depth net hands the backbone a bfloat16 image
    variables, ref16, ref32 = _flax_pair(lambda d: JEfficientNet("B0", dtype=d),
                                         jnp.asarray(x, jnp.bfloat16), train, seed=1,
                                         mutable=train)
    if train:
        (ref16, _), (ref32, _) = ref16, ref32
    net = load_flax_variables(backbone_factory("EfficientNetB0", BF16), variables).train(train)
    assert isinstance(net, EfficientNet)
    with torch.no_grad():
        got = net(_nchw(x, BF16))
    assert len(got) == 5
    for i, (g, r16, r32) in enumerate(zip(got, ref16, ref32)):
        assert g.dtype == BF16 and r16.dtype == jnp.bfloat16
        assert_bf16_distance(_nhwc(g), r16, r32, f"tap {i}")


def test_bf16_depthnet_matches_flax():
    x = _image5d(7, height=64, width=128)
    act = InverseSigmoidActivation()
    variables, ref16, ref32 = _flax_pair(
        lambda d: JDepthNetPretrained(JEfficientNet("B0", dtype=d), act, dtype=d),
        jnp.asarray(x), seed=2)
    net = DepthNetPretrained(EfficientNet("B0", BF16), activation_factory("InverseSigmoid"),
                             dtype=BF16)
    load_flax_variables(net, variables).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for i, (g, r16, r32) in enumerate(zip(got["depth_ms"], ref16["depth_ms"],
                                          ref32["depth_ms"])):
        assert g.dtype == torch.float32 and r16.dtype == jnp.float32
        assert_bf16_distance(g, r16, r32, f"depth {i}")
    # debug_out: [dp0 (float32), upconv0 (bf16), dp3 (float32), upconv3 (bf16)]
    assert [g.dtype for g in got["debug_out"]] == [torch.float32, BF16, torch.float32, BF16]
    assert [r.dtype for r in ref16["debug_out"]] == [jnp.float32, jnp.bfloat16,
                                                    jnp.float32, jnp.bfloat16]


def test_bf16_posenet_matches_flax():
    x = _image5d(8, height=64, width=128)
    variables, ref16, ref32 = _flax_pair(lambda d: JPoseNetImproved(dtype=d), jnp.asarray(x),
                                         seed=3)
    net = load_flax_variables(PoseNetImproved(5, dtype=BF16), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))["pose"]
    assert got.dtype == torch.float32 and ref16["pose"].dtype == jnp.float32
    assert_bf16_distance(got, ref16["pose"], ref32["pose"], "pose")


def test_bf16_pwcnet_matches_flax():
    """PWC-Net at 64x64, one snippet of 4 pairs; the JAX bfloat16 net on
    the Pallas cost volume (interpret mode), as on its TPU."""
    x = _image5d(9, batch=1, height=64, width=64)
    # the float32 reference on the XLA cost volume: in float32 it is the
    # kernel's function (products and sums in float32), and quicker to build
    variables, ref16, ref32 = _flax_pair(
        lambda d: JPWCNet(dtype=d, use_pallas=d == jnp.bfloat16), jnp.asarray(x), seed=4)
    net = load_flax_variables(PWCNet(BF16), variables)
    with torch.no_grad():
        got = net(torch.from_numpy(x))["flow_ms"]
    for i, (g, r16, r32) in enumerate(zip(got, ref16["flow_ms"], ref32["flow_ms"])):
        assert g.dtype == torch.float32 and r16.dtype == jnp.float32
        assert_bf16_distance(g, r16, r32, f"flow {i}")


def test_factory_builds_float32_parameters_in_bf16():
    nets = {"depth": "EfficientNetB0", "camera": "PoseNetImproved", **FLOW_NET}
    model = ModelFactory(["image", "intrinsic"], nets, stereo=False, compute_dtype="bfloat16",
                         device="cpu").get_model()
    assert {t.dtype for t in model.state_dict().values() if t.is_floating_point()} == {
        torch.float32}
    convs = [m for m in model.modules() if isinstance(m, (tlayers.Conv2dSame,
                                                          tlayers.ConvTranspose))]
    assert convs and all(m.compute_dtype == BF16 for m in convs)
    assert compute_dtype("float32") == torch.float32 and compute_dtype("bfloat16") == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        ModelFactory(["image"], nets, compute_dtype="float16", device="cpu")
    # the converter refuses a narrower parameter on either side
    conv = tlayers.Conv(3, 4, 3, dtype=BF16)
    variables = random_variables(jlayers.Conv(4, 3), jnp.zeros((1, 8, 8, 3)))
    half = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                  variables)
    with pytest.raises(TypeError, match="float32"):
        load_flax_variables(conv, half)
    with pytest.raises(TypeError, match="float32"):
        load_flax_variables(conv.to(BF16), variables)


def test_one_cast_per_net_matches_casting_each_tensor(monkeypatch):
    """``layers.cast_parameters`` (one concatenated cast of a net's conv
    weights and biases per call) gives the bits of casting each tensor:
    outputs and float32 parameter gradients; under inference mode each
    conv keeps its cast until the parameter changes."""
    from xpt_mde_tpu_torch.models import pose_net

    x = torch.from_numpy(_image5d(10, height=64, width=128))
    nets = [PoseNetImproved(5, dtype=BF16)]
    nets.append(copy.deepcopy(nets[0]))
    runs = []
    for net in nets:
        if runs:  # the second net casts each tensor in its conv
            monkeypatch.setattr(pose_net, "cast_parameters",
                                lambda net: contextlib.nullcontext())
        pose = net(x)["pose"]
        pose.square().sum().backward()
        runs.append((pose.detach(), {n: p.grad for n, p in net.named_parameters()}))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for name, grad in runs[0][1].items():
        assert grad.dtype == torch.float32
        torch.testing.assert_close(grad, runs[1][1][name], rtol=0, atol=0)

    # each cast piece starts a multiple of 128 bytes into the one cast buffer
    # (whose allocation the device aligns), as cuDNN's tensor-core kernels want
    with tlayers.cast_parameters(nets[0]):
        pieces = [t for m in nets[0].modules() if isinstance(m, tlayers.ComputeCast)
                  for t in m.cast_params() if t is not None]
    base = pieces[0].data_ptr()
    assert all((t.data_ptr() - base) % 128 == 0 and t.dtype == BF16 for t in pieces)

    conv = nets[0].Conv_0.Conv_0
    with torch.inference_mode():
        first = conv.cast_params()
        assert conv.cast_params()[0] is first[0] and first[0].dtype == BF16
    with torch.no_grad():
        conv.weight.add_(1.0)
    with torch.inference_mode():
        again = conv.cast_params()
        assert again[0] is not first[0]
        torch.testing.assert_close(again[0], conv.weight.to(BF16), rtol=0, atol=0)


def test_bf16_feature_warp_promotes_as_jax():
    """PWC-Net's feature warp on bfloat16 features and float32 flow gives
    float32 in both packages (bfloat16 patches times float32 weights), and
    the same values up to the float32 rounding of the weights."""
    from xpt_mde_tpu.ops.flow_warp import flow_bilinear_sample as j_warp
    from xpt_mde_tpu_torch.ops.flow_warp import flow_bilinear_sample

    rng = np.random.RandomState(11)
    feats = _bf16_round(rng.uniform(-1, 1, (2, 8, 12, 16)).astype(np.float32))
    flow = rng.uniform(-3, 3, (2, 8, 12, 2)).astype(np.float32)
    ref = j_warp(jnp.asarray(feats, jnp.bfloat16), jnp.asarray(flow))
    got = flow_bilinear_sample(torch.from_numpy(feats).to(BF16), torch.from_numpy(flow))
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_bf16_predict_and_eval_steps_return_float32():
    """The bfloat16 model's predict step gives float32 depth, disparity,
    pose and flow, and its eval step float32 losses, as the JAX package's
    (the nets cast up at their heads)."""
    from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1
    from xpt_mde_tpu_torch.data import SyntheticDataset
    from xpt_mde_tpu_torch.losses import loss_factory
    from xpt_mde_tpu_torch.training import make_eval_step, make_predict_step

    dataset = SyntheticDataset(batch_size=1, height=64, width=128, num_batches=1)
    keys = dataset.config_keys()
    feats = {k: torch.from_numpy(v) for k, v in next(iter(dataset)).items()}
    nets = {"depth": "EfficientNetB0", "camera": "PoseNetImproved", **FLOW_NET}
    model = ModelFactory(keys, nets, stereo=False, compute_dtype="bfloat16",
                         device="cpu").get_model()
    preds = make_predict_step(model)(feats)
    for key in ("depth_ms", "disp_ms", "flow_ms"):
        assert all(t.dtype == torch.float32 for t in preds[key]), key
    assert preds["pose"].dtype == torch.float32
    loss = loss_factory(keys, {"L1": 1.0, "smoothe": 1.0}, SCALE_WEIGHT_T1, stereo=False,
                        batch_size=1)
    metrics = make_eval_step(model, loss)(feats)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v)) for v in metrics.values())
