"""The port's rigid train step against the JAX package: the flax-exact
BatchNorm, the optimizers and the gradients of every module the step
differentiates through (the whole step is in test_torch_train_step.py).

Inputs and weights come from seeded numpy RandomStates and go, as the
same arrays, to both sides (weights through ``xpt_mde_tpu_torch.convert``).
Each test states its tolerance and why.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xpt_mde_tpu.config import SCALE_WEIGHT_T1
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.losses import photometric as jphoto
from xpt_mde_tpu.models.depth_net import DepthDecoder as JDepthDecoder
from xpt_mde_tpu.models.layers import activation_factory as j_activation
from xpt_mde_tpu.models.pose_net import PoseNetImproved as JPoseNetImproved
from xpt_mde_tpu.ops import camera as jcam
from xpt_mde_tpu.ops.synthesize import synthesize_multi_scale as j_synth
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.utils import image as jimage
from xpt_mde_tpu.utils import se3 as jse3
from xpt_mde_tpu_torch.convert import flax_params_to_torch, load_flax_variables
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.losses import photometric as tphoto
from xpt_mde_tpu_torch.models.depth_net import DepthDecoder
from xpt_mde_tpu_torch.models.layers import BatchNorm2d, activation_factory
from xpt_mde_tpu_torch.models.pose_net import PoseNetImproved
from xpt_mde_tpu_torch.ops import camera as tcam
from xpt_mde_tpu_torch.ops.synthesize import synthesize_multi_scale
from xpt_mde_tpu_torch.training import optimizer_factory
from xpt_mde_tpu_torch.utils import image as timage
from xpt_mde_tpu_torch.utils import se3 as tse3
from xpt_mde_tpu_torch.utils.precision import full_f32

NETS_B0 = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}


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
    random BN statistics and scales too, so a swapped mapping shows."""
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean", "input_mean"):
            return (rng.randn(*sd.shape) * 0.05).astype(np.float32)
        return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _grad_close(got, want, name, rtol, atol):
    """Per-tensor bound ||got - want|| <= rtol ||want|| + atol."""
    err = float(np.linalg.norm(got - want))
    bound = rtol * float(np.linalg.norm(want)) + atol
    assert err <= bound, f"{name}: |diff| {err:.3g} > {bound:.3g} (|want| {np.linalg.norm(want):.3g})"


# --------------------------------------------------------------------------
# BatchNorm in train mode


@pytest.mark.parametrize("shape", [(2, 2, 4, 40), (4, 6, 9, 24)])
def test_batchnorm_train_mode_matches_flax(shape):
    """(2, 2, 4, 40): 16 values per channel, B0's stride-32 map at batch 2,
    where torch's unbiased running variance is 16/15 of flax's update."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2.0 + 0.7).astype(np.float32)
    channels = shape[-1]
    mean0 = (rng.randn(channels) * 0.1).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = (rng.randn(channels) * 0.1).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    ref, new_vars = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    def run(bn):
        bn.weight.data = torch.from_numpy(scale.copy())
        bn.bias.data = torch.from_numpy(bias.copy())
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
        out = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        return (out.detach().permute(0, 2, 3, 1).numpy(), bn.running_mean.numpy(),
                bn.running_var.numpy())

    out, mean, var = run(BatchNorm2d(channels))
    # 1e-5: float32 on both sides; flax takes the variance as E[x^2] - E[x]^2,
    # torch in two passes, a few ulp apart at these magnitudes
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean, np.asarray(new_vars["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(var, np.asarray(new_vars["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)
    # the plain torch module puts the unbiased variance into running_var
    _, _, torch_var = run(torch.nn.BatchNorm2d(channels, eps=1e-3, momentum=0.01))
    assert not np.allclose(torch_var, np.asarray(new_vars["batch_stats"]["var"]),
                           atol=1e-6, rtol=1e-6)


def test_batchnorm_eval_mode_uses_running_stats():
    bn = BatchNorm2d(3)
    bn.running_mean.fill_(0.5)
    bn.running_var.fill_(4.0)
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(0))
    out = bn.eval()(x)
    torch.testing.assert_close(out, (x - 0.5) / torch.sqrt(torch.tensor(4.0 + 1e-3)))
    assert float(bn.running_mean[0]) == 0.5 and float(bn.running_var[0]) == 4.0


# --------------------------------------------------------------------------
# optimizers


class _TwoNets(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.depthnet = torch.nn.Linear(3, 4)
        self.posenet = torch.nn.Linear(4, 2)


@pytest.mark.parametrize("name", ["adam_constant", "sgd"])
def test_optimizer_step_matches_optax(name):
    rng = np.random.RandomState(1)
    net = _TwoNets()
    params = {"depthnet": {"kernel": rng.randn(4, 3).astype(np.float32),
                           "bias": rng.randn(4).astype(np.float32)},
              "posenet": {"kernel": rng.randn(2, 4).astype(np.float32),
                          "bias": rng.randn(2).astype(np.float32)}}
    grads = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
    grads["depthnet"]["bias"][0] = 1e-9  # within Adam's eps

    tx = j_optimizer_factory(name, 1e-2, frozen_nets=["posenet"])
    state = tx.init(params)
    params_ref = params
    for _ in range(2):  # two steps: Adam's bias corrections and moments
        updates, state = tx.update(grads, state, params_ref)
        params_ref = optax.apply_updates(params_ref, updates)
    params_ref = jax.tree_util.tree_map(np.asarray, params_ref)

    with torch.no_grad():
        for net_name in ("depthnet", "posenet"):
            layer = getattr(net, net_name)
            layer.weight.copy_(torch.from_numpy(params[net_name]["kernel"]))
            layer.bias.copy_(torch.from_numpy(params[net_name]["bias"]))
    opt = optimizer_factory(name, 1e-2, net, frozen_nets=["posenet"])
    for _ in range(2):
        for net_name in ("depthnet", "posenet"):
            layer = getattr(net, net_name)
            layer.weight.grad = torch.from_numpy(grads[net_name]["kernel"].copy())
            layer.bias.grad = torch.from_numpy(grads[net_name]["bias"].copy())
        opt.step()
    for net_name in ("depthnet", "posenet"):
        layer = getattr(net, net_name)
        # 1e-6: the same float32 update formula, evaluated in another order
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   params_ref[net_name]["kernel"], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   params_ref[net_name]["bias"], atol=1e-6, rtol=1e-6)
    # the frozen net is out of the optimizer and never moves
    np.testing.assert_array_equal(net.posenet.weight.detach().numpy(), params["posenet"]["kernel"])


def test_optimizer_factory_rejects_unknown():
    with pytest.raises(ValueError, match="invalid optimizer"):
        optimizer_factory("rmsprop", 1e-3, _TwoNets())


# --------------------------------------------------------------------------
# gradients of what the train step differentiates through


def _vjp_both(j_fn, t_fn, inputs, seed=0):
    """jax.vjp of ``j_fn`` and torch autograd of ``t_fn`` on the same
    inputs and the same random cotangent: (jax grads, torch grads)."""
    j_inputs = [jnp.asarray(a) for a in inputs]
    out = jax.jit(j_fn)(*j_inputs)
    cot = np.random.RandomState(seed).uniform(-1, 1, out.shape).astype(np.float32)
    ref = jax.jit(lambda c, *a: jax.vjp(j_fn, *a)[1](c))(jnp.asarray(cot), *j_inputs)
    ref = [np.asarray(g) for g in ref]
    args = [torch.tensor(a, requires_grad=True) for a in inputs]
    got_out = t_fn(*args)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    got = torch.autograd.grad(got_out, args, torch.from_numpy(cot), allow_unused=True)
    return ref, [np.zeros_like(a) if g is None else g.numpy() for a, g in zip(inputs, got)]


def _intrinsics(batch, height, width):
    return np.tile(np.array([[0.6 * width, 0.0, width / 2], [0.0, 0.6 * width, height / 2],
                             [0.0, 0.0, 1.0]], np.float32), (batch, 1, 1))


def _j_flat(xs):
    return jnp.concatenate([x.reshape(-1) for x in xs])


def _t_flat(xs):
    return torch.cat([x.reshape(-1) for x in xs])


def _geometry_case(name):
    """(jax fn, torch fn, inputs, rtol): inputs are the differentiated
    arguments; everything else is fixed data."""
    rng = np.random.RandomState(2)
    batch, numsrc, height, width = 2, 4, 16, 32
    k = _intrinsics(batch, height, width)
    if name == "twist_to_matrix":
        twists = rng.uniform(-0.3, 0.3, (batch, numsrc, 6)).astype(np.float32)
        return jse3.twist_to_matrix, tse3.twist_to_matrix, [twists], 1e-5
    if name == "reproject_pixel_coords":
        depth = rng.uniform(2.0, 20.0, (batch, height, width, 1)).astype(np.float32)
        pose = np.array(jse3.twist_to_matrix(jnp.asarray(
            rng.uniform(-0.05, 0.05, (batch, numsrc, 6)).astype(np.float32))))
        return (lambda d, p: jcam.reproject_pixel_coords(d, p, jnp.asarray(k)),
                lambda d, p: tcam.reproject_pixel_coords(d, p, torch.from_numpy(k)),
                [depth, pose], 1e-4)
    if name == "safe_reciprocal":
        x = rng.uniform(-1e-5, 3.0, (batch, height, width, 1)).astype(np.float32)
        x[0, 0, :3, 0] = [0.0, 1e-5, 2e-5]
        return jimage.safe_reciprocal, timage.safe_reciprocal, [x], 1e-5
    if name in ("L1", "SSIM"):
        synth = rng.uniform(-1, 1, (batch, numsrc, height, width, 3)).astype(np.float32)
        synth[rng.rand(batch, numsrc, height, width) < 0.2] = 0.0
        target = rng.uniform(-1, 1, (batch, height, width, 3)).astype(np.float32)
        return (lambda s: jphoto.PHOTOMETRIC_FNS[name](s, jnp.asarray(target)),
                lambda s: tphoto.PHOTOMETRIC_FNS[name](s, torch.from_numpy(target)),
                [synth], 1e-5)
    # the 4-scale synthesis, differentiated in the depths and the twists
    source = rng.uniform(-1, 1, (batch, numsrc, height, width, 3)).astype(np.float32)
    depth_ms = [rng.uniform(2.0, 20.0, (batch, height >> s, width >> s, 1)).astype(np.float32)
                for s in range(4)]
    depth_ms[0][:, :2] = 0.0  # zero depth: masked rows
    twists = rng.uniform(-0.05, 0.05, (batch, numsrc, 6)).astype(np.float32)
    return (lambda p, *d: _j_flat(j_synth(jnp.asarray(source), jnp.asarray(k), list(d), p)),
            lambda p, *d: _t_flat(synthesize_multi_scale(torch.from_numpy(source),
                                                         torch.from_numpy(k), list(d), p)),
            [twists] + depth_ms, 1e-4)


@pytest.mark.parametrize("name", ["twist_to_matrix", "reproject_pixel_coords",
                                  "safe_reciprocal", "L1", "SSIM", "synthesize_multi_scale"])
def test_vjp_matches_jax(name):
    j_fn, t_fn, inputs, rtol = _geometry_case(name)
    ref, got = _vjp_both(j_fn, t_fn, inputs)
    # per-tensor norm bound: rtol 1e-5 for float32 elementwise chains;
    # 1e-4 where the reprojection divides by z: pixel coordinates of 10-60
    # px carry ~1e-6 relative float32 error (test_torch_geometry), which
    # the synthesis also carries into the image gradients
    for i, (r, g) in enumerate(zip(ref, got)):
        _grad_close(g, r, f"{name} input {i}", rtol, 1e-6)


def test_total_loss_vjp_matches_jax():
    rng = np.random.RandomState(3)
    batch, height, width = 2, 32, 64
    keys = ["image", "intrinsic"]
    image5d = rng.uniform(-1, 1, (batch, 5, height, width, 3)).astype(np.float32)
    k = _intrinsics(batch, height, width)
    depth_ms = [rng.uniform(2.0, 20.0, (batch, height >> s, width >> s, 1)).astype(np.float32)
                for s in range(4)]
    pose = rng.uniform(-0.05, 0.05, (batch, 4, 6)).astype(np.float32)
    jloss = j_loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=batch)
    tloss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=batch)

    def j_fn(p, *d):
        preds = {"depth_ms": list(d), "disp_ms": jimage.safe_reciprocal_ms(list(d)), "pose": p}
        return jloss(preds, {"image5d": jnp.asarray(image5d), "intrinsic": jnp.asarray(k)})[0]

    def t_fn(p, *d):
        preds = {"depth_ms": list(d), "disp_ms": timage.safe_reciprocal_ms(list(d)), "pose": p}
        return tloss(preds, {"image5d": torch.from_numpy(image5d),
                             "intrinsic": torch.from_numpy(k)})[0]

    ref, got = _vjp_both(j_fn, t_fn, [pose] + depth_ms)
    for i, (r, g) in enumerate(zip(ref, got)):
        # 1e-4, as for the synthesis above
        _grad_close(g, r, f"total loss input {i}", 1e-4, 1e-7)


def _module_vjp(jmodule, tmodule, init_args, inputs, j_apply, t_apply, seed, rtol):
    """Parameter (and input) gradients of a flax module and its port, in
    float64, under the same converted weights and cotangent. Float64: a
    float32 forward's rounding moves some deep LeakyReLU input across 0 on
    one side only, and that unit's slope change alters a whole patch of
    the gradient; in float64 no unit lies that close to the kink."""
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(lambda a: a.astype(np.float64), _fill(
            jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *init_args)), seed))
        def j_fn(p, *a):
            return _j_flat(j_apply({"params": p}, *a))

        j_inputs = [jnp.asarray(a) for a in inputs]
        out = jax.jit(j_fn)(variables["params"], *j_inputs)
        # the depth heads and the pose mean put out float32 on both sides
        cot = np.random.RandomState(seed).uniform(-1, 1, out.shape).astype(out.dtype)
        ref_params, *ref_inputs = jax.jit(lambda c, *a: jax.vjp(j_fn, *a)[1](c))(
            jnp.asarray(cot), variables["params"], *j_inputs)
        out, ref_inputs = np.asarray(out), [np.asarray(r) for r in ref_inputs]
    load_flax_variables(tmodule.double(), variables)
    args = [torch.tensor(a, requires_grad=True) for a in inputs]
    got_out = _t_flat(t_apply(*args))
    np.testing.assert_allclose(got_out.detach().numpy(), out, atol=1e-6, rtol=1e-6)
    got_out.backward(torch.from_numpy(cot))
    ref_params = flax_params_to_torch(ref_params, tmodule)
    for name, p in tmodule.named_parameters():
        _grad_close(p.grad.numpy(), ref_params[name].numpy(), name, rtol, 1e-12)
    for i, (a, r) in enumerate(zip(args, ref_inputs)):
        _grad_close(a.grad.numpy(), r, f"input {i}", rtol, 1e-12)


def test_depth_decoder_vjp_matches_jax():
    rng = np.random.RandomState(4)
    channels, height, width = (8, 12, 16, 24, 32), 32, 64
    feats = [rng.uniform(-1, 1, (2, height >> (i + 1), width >> (i + 1), c))
             for i, c in enumerate(channels)]
    jdec = JDepthDecoder(j_activation("InverseSigmoid"), dtype=jnp.float64)
    tdec = DepthDecoder(channels, activation_factory("InverseSigmoid"))
    _module_vjp(jdec, tdec, ([jnp.asarray(f) for f in feats], height, width), feats,
                lambda v, *f: jdec.apply(v, list(f), height, width)["depth_ms"],
                lambda *f: tdec([x.permute(0, 3, 1, 2) for x in f], height, width)["depth_ms"],
                # 1e-5: the depth heads' activations run in float32 on both
                # sides, a few ulp apart per pixel
                seed=5, rtol=1e-5)


def test_posenet_vjp_matches_jax():
    x = np.random.RandomState(6).uniform(-1, 1, (2, 5, 64, 128, 3))
    jnet = JPoseNetImproved(False, dtype=jnp.float64)
    tnet = PoseNetImproved(5, False)
    _module_vjp(jnet, tnet, (jnp.asarray(x),), [x], lambda v, a: [jnet.apply(v, a)["pose"]],
                lambda a: [tnet(a)["pose"]], seed=7, rtol=1e-6)
