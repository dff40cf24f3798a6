"""The learning chain against the JAX package: ``DepthNetBasic``,
``DepthNetNoResize`` and ``PoseNetBasic`` (float32 and bfloat16), one train
step of the miniature plan's rigid row and the plan's constants (the
evaluation helpers of ``training/mini_plan.py`` are held in
test_torch_mini_plan_eval.py, a two-batch run of the plan in
test_torch_mini_plan_run.py).

Weights: flax variable trees filled from a seeded numpy RandomState
(``test_torch_models.random_variables``), or the JAX helpers' own init,
converted into the port's modules (``convert.py``). Each test states its
tolerance: the nets as ``test_torch_models.py`` (rtol 1e-4, atol 1e-5 for
whole nets, float32 on both sides) and ``test_torch_bf16_models.py`` (the
distance rule); the train step as ``test_torch_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bf16_models import _flax_pair, assert_bf16_distance
from test_torch_models import random_variables
from test_torch_train import _fill, _grad_close
from xpt_mde_tpu.config import SCALE_WEIGHT_T1
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.models import depth_net as jdn
from xpt_mde_tpu.models.layers import ExponentialActivation
from xpt_mde_tpu.models.pose_net import PoseNetBasic as JPoseNetBasic
from xpt_mde_tpu.training import mini_plan as jmp
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.convert import flax_params_to_torch, flax_to_state_dict, load_flax_variables
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.models import depth_net as dn
from xpt_mde_tpu_torch.models.layers import activation_factory
from xpt_mde_tpu_torch.models.pose_net import PoseNetBasic
from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
from xpt_mde_tpu_torch.training import mini_plan as mp
from xpt_mde_tpu_torch.utils.precision import full_f32

BF16 = torch.bfloat16
KEYS = ["image", "intrinsic"]


@pytest.fixture(autouse=True)
def _no_tf32():
    # full float32, and 4 threads: the plan and the JAX steps share the
    # cores with the test workers beside them
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    with full_f32():
        yield
    torch.set_num_threads(threads)


def _image5d(seed, batch=2, height=128, width=128):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, 5, height, width, 3)).astype(
        np.float32)


def _port_depth_net(name, dtype=torch.float32):
    cls = {"DepthNetBasic": dn.DepthNetBasic, "DepthNetNoResize": dn.DepthNetNoResize}[name]
    return cls(activation_factory("Exponential"), dtype=dtype)


def _jax_depth_net(name, dtype=jnp.float32):
    cls = {"DepthNetBasic": jdn.DepthNetBasic, "DepthNetNoResize": jdn.DepthNetNoResize}[name]
    return cls(ExponentialActivation(), dtype=dtype)


# --------------------------------------------------------------------------
# the nets


@pytest.mark.parametrize("name,height,width", [
    ("DepthNetBasic", 128, 128), ("DepthNetNoResize", 128, 128),
    # the mini plan's rigid size: the stride-64 and -128 maps are 1x1, and
    # the up-blocks resize 2x2 to 1x1 and 1x2
    ("DepthNetBasic", 32, 64)])
def test_depth_net_matches_flax(name, height, width):
    x = _image5d(1, height=height, width=width)
    jnet = _jax_depth_net(name)
    variables = random_variables(jnet, jnp.asarray(x), seed=2)
    ref = jax.jit(lambda v, a: jnet.apply(v, a))(variables, jnp.asarray(x))
    tnet = _port_depth_net(name)
    # every flax leaf maps to exactly one torch tensor, and every one is set
    state = flax_to_state_dict(variables, tnet)
    assert len(state) == len(jax.tree_util.tree_leaves(variables)) == len(tnet.state_dict())
    tnet.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x))
    for key in ("depth_ms", "debug_out"):
        for r, g in zip(ref[key], got[key]):
            assert tuple(g.shape) == r.shape, key
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5,
                                       err_msg=key)


def test_posenet_basic_matches_flax():
    x = _image5d(3, height=128, width=128)
    jnet = JPoseNetBasic()
    variables = random_variables(jnet, jnp.asarray(x), seed=3)
    ref = jnet.apply(variables, jnp.asarray(x))["pose"]
    tnet = load_flax_variables(PoseNetBasic(5), variables)
    with torch.inference_mode():
        got = tnet(torch.from_numpy(x))["pose"]
    assert tuple(got.shape) == (2, 4, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["DepthNetBasic", "DepthNetNoResize"])
def test_bf16_depth_net_matches_flax(name):
    x = _image5d(4, height=128, width=128)
    variables, ref16, ref32 = _flax_pair(lambda d: _jax_depth_net(name, d), jnp.asarray(x),
                                         seed=5)
    tnet = load_flax_variables(_port_depth_net(name, BF16), variables)
    assert {p.dtype for p in tnet.parameters()} == {torch.float32}
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))
    for i, (g, r16, r32) in enumerate(zip(got["depth_ms"], ref16["depth_ms"],
                                          ref32["depth_ms"])):
        assert g.dtype == torch.float32 and r16.dtype == jnp.float32
        assert_bf16_distance(g, r16, r32, f"{name} depth {i}")
    assert [g.dtype for g in got["debug_out"]] == [torch.float32, BF16, torch.float32, BF16]


def test_bf16_posenet_basic_matches_flax():
    x = _image5d(6, height=128, width=128)
    variables, ref16, ref32 = _flax_pair(lambda d: JPoseNetBasic(dtype=d), jnp.asarray(x),
                                         seed=6)
    tnet = load_flax_variables(PoseNetBasic(5, dtype=BF16), variables)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x))["pose"]
    assert got.dtype == torch.float32
    assert_bf16_distance(got, ref16["pose"], ref32["pose"], "pose")


def test_factory_routes_the_mini_plan_nets():
    for nets, depth_cls, pose_cls in (
            (mp.RIGID_NETS, dn.DepthNetBasic, PoseNetBasic),
            ({"depth": "DepthNetNoResize", "camera": "PoseNetBasic"}, dn.DepthNetNoResize,
             PoseNetBasic)):
        model = ModelFactory(KEYS, nets, "Exponential", stereo=False, device="cpu",
                             compute_dtype="bfloat16").get_model()
        assert type(model.depthnet) is depth_cls and type(model.posenet) is pose_cls
        assert model.depthnet.compute_dtype == BF16 == model.posenet.compute_dtype
        assert {t.dtype for t in model.state_dict().values()} == {torch.float32}


# --------------------------------------------------------------------------
# one train step of the rigid row


BATCH, LR = 2, 3e-4


@pytest.fixture(scope="module")
def rigid_step():
    """The JAX train step and the port's on the same batch and weights,
    under the mini plan's rigid recipe (DepthNetBasic + PoseNetBasic,
    Exponential, 32x64, Adam at 3e-4, no augmentation)."""
    with full_f32():
        dataset = SyntheticDataset(batch_size=BATCH, height=mp.RIGID_SIZE[0],
                                   width=mp.RIGID_SIZE[1], num_batches=1, varying_depth=True,
                                   vary_motion=True, seed=2)
        keys = dataset.config_keys()
        batch = next(iter(dataset))
        jmodel = JModelFactory(keys, jmp.RIGID_NETS, "Exponential", stereo=False).get_model()
        jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)), 4)
        state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=None, tx=j_optimizer_factory("adam_constant", LR))
        jloss = j_loss_factory(keys, jmp.RECIPE_RIGID, SCALE_WEIGHT_T1, stereo=False,
                               batch_size=BATCH)
        new_state, jmetrics = j_make_train_step(jmodel, jloss)(state, jfeats,
                                                               jax.random.PRNGKey(0))
        # Adam's first moment after one step is (1 - b1) * g
        jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9),
                                        new_state.opt_state[0].mu)
        jnew = jax.tree_util.tree_map(np.asarray, {"params": new_state.params})

        model = ModelFactory(keys, mp.RIGID_NETS, "Exponential", stereo=False,
                             device="cpu").get_model()
        load_flax_variables(model, variables)
        step = make_train_step(model, loss_factory(keys, mp.RECIPE_RIGID, SCALE_WEIGHT_T1,
                                                   stereo=False, batch_size=BATCH),
                               optimizer_factory("adam_constant", LR, model))
        metrics = step({k: torch.from_numpy(v) for k, v in batch.items()})
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(model=model, metrics=metrics, grads=grads, jmetrics=jmetrics, jgrads=jgrads,
                jnew=jnew, variables=variables)


def test_rigid_step_losses_match_jax(rigid_step):
    metrics, jmetrics = rigid_step["metrics"], rigid_step["jmetrics"]
    assert set(metrics) == set(jmetrics)
    for key in ["loss"] + [f"loss/{k}" for k in mp.RECIPE_RIGID]:
        # 1e-5: float32 on both sides, the same train-mode forward
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    for key in ("depth_abs_rel", "depth_center_mean", "trj_err", "rot_err"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_rigid_step_gradients_match_jax(rigid_step):
    model = rigid_step["model"]
    ref = flax_params_to_torch(rigid_step["jgrads"], model)
    assert set(ref) == set(rigid_step["grads"])
    for name, grad in rigid_step["grads"].items():
        # rtol 1e-3 of the tensor's norm: float32 through ~40 layers summed in
        # another order (test_torch_train.py's rule)
        _grad_close(grad.numpy(), ref[name].numpy(), name, 1e-3, 1e-7)


def test_rigid_step_update_matches_jax(rigid_step):
    """Adam's first step moves each weight by lr * g / (|g| + eps): the
    two updates may differ elementwise only as far as that function of
    the two gradients does (most of the 512-wide convs' gradients are
    within a few eps of 0 at this fill, where it is steep), plus the
    rounding of weights below 1."""
    model = rigid_step["model"]
    want = flax_to_state_dict(rigid_step["jnew"], model)
    before = flax_to_state_dict(rigid_step["variables"], model)
    grads, ref_grads = rigid_step["grads"], flax_params_to_torch(rigid_step["jgrads"], model)
    eps = 1e-8
    for key, value in model.state_dict().items():
        got, ref = value.numpy(), want[key].numpy()
        g, rg = grads[key].numpy().astype(np.float64), ref_grads[key].numpy().astype(np.float64)
        allowed = LR * np.abs(g / (np.abs(g) + eps) - rg / (np.abs(rg) + eps))
        excess = np.abs(got.astype(np.float64) - ref) - allowed
        assert excess.max() <= 2.5e-7, (key, float(excess.max()))
        assert np.any(got != before[key].numpy()), f"{key} did not move"


def test_mini_plan_constants_match_jax():
    for name in ("RIGID_NETS", "FLOW_NETS", "JOINT_NETS", "RECIPE_RIGID", "RECIPE_FLOW",
                 "RECIPE_JOINT", "RECIPE_STEREO", "RIGID_SIZE", "FLOW_SIZE"):
        assert getattr(mp, name) == getattr(jmp, name), name
    for got, want in zip(mp.miniature_plan(12, 3, 3), jmp.miniature_plan(12, 3, 3),
                         strict=True):
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    cfg, jcfg = (m.make_config("/d", m.miniature_plan(1, 1, 1), batch=8, compute_dtype="bfloat16")
                 for m in (mp, jmp))
    assert cfg.to_json_dict() == jcfg.to_json_dict()
    for factory, jfactory in ((mp.synthetic_factory(3, 1), jmp.synthetic_factory(3, 1)),
                              (mp.planar_factory(2, 1), jmp.planar_factory(2, 1))):
        for dataset, split in (("synthetic_small", "train"), ("synthetic", "val")):
            ours, ref = factory(dataset, split, 2), jfactory(dataset, split, 2)
            assert len(ours) == len(ref)
            for got, want in zip(ours, ref, strict=True):
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key], err_msg=key)
