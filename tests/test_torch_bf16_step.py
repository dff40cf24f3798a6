"""One train step of each stage in bfloat16, the JAX package's default
compute dtype, against the JAX bfloat16 step: rigid (the mono terms of
``LOSS_RIGID_T1``, EfficientNetB0 + PoseNetImproved) here; stereo (the
published "MS" recipe on stereo snippets), flow (``LOSS_FLOW`` without
``flowL2_R``, PWCNet regularized) and joint (``LOSS_RIGID_COMB`` without
its stereo terms, the flownet frozen) in test_torch_bf16_stereo_step.py,
test_torch_bf16_flow_step.py and test_torch_bf16_joint_step.py, one file
a stage so that each file's time on one worker stays near a minute and a
half (the two JAX steps compile ~15-40 s each). Each step takes
one uint8-coded batch of 2 snippets at 64x128 from the same weights
(seeded numpy fills through ``xpt_mde_tpu_torch.convert``), without
augmentation (the two packages draw it from different generators).

The JAX flownet is built with ``use_pallas=True``: its cost volume is
then the Pallas kernel's (interpret mode on the CPU), which sums float32
products, as the port's does, and not the XLA fallback's, which rounds
every product to bfloat16.

Tolerance, the distance rule of test_torch_bf16_models.py, against the
JAX float32 step on the same batch and weights: two bfloat16 steps each
sit about one rounding per layer from the float32 step, so the port's
bfloat16 step may lie at most 2x (median) and 4x (max) as far from JAX's
bfloat16 step as that lies from JAX's float32 step:
- the loss and each term: its relative distance at most 4x the largest
  relative bf16-vs-f32 distance among the recipe's terms (the terms are
  the elements, so their median and max), beside 1e-6;
- the parameter gradients (float32 on both sides): each tensor's
  relative distance ||port - JAX||/||JAX||, over the tensors at most 2x
  the median and 4x the max of the bf16-vs-f32 relative distances (a
  tensor of ~0 gradient, a projection BatchNorm's bias, by its absolute
  distance, 4x, beside 1e-7). At this size the depth net's bfloat16
  gradients are mostly rounding: train-mode BatchNorm over 16 values a
  channel at stride 32 cancels, and the cotangents carry 8 bits, so their
  median relative distance from the float32 gradients is ~1 (the
  posenet's ~0.08), in both packages alike;
- the BatchNorm running statistics, elementwise, all tensors pooled;
- the updated parameters: Adam's first step moves each by about the
  learning rate in its gradient's sign, so their distance counts the
  signs that differ: the pooled mean distance at most 2x, every element
  within 2 learning rates plus rounding, and every parameter moved.
The stereo step runs at CHECK_T_LR (the baseline with a vertical offset),
as test_torch_stereo_step.py explains. The combined losses' threshold
(static error below the flow error) flips near-tie pixels with any
rounding, in both bfloat16 steps alike; the rule's reference distance
holds those flips too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_bf16_models import assert_bf16_distance
from test_torch_stereo_step import _fill
from xpt_mde_tpu.config import FLOW_NET, LOSS_RIGID_COMB, LOSS_RIGID_T1, SCALE_WEIGHT_T1
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.models.flow_net import PWCNet as JPWCNet
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.convert import (flax_params_to_torch, flax_to_state_dict,
                                       load_flax_variables)
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.tools.profile_steps import STEREO_RECIPE
from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
from xpt_mde_tpu_torch.utils.precision import full_f32

RIGID = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
JOINT = dict(RIGID, **FLOW_NET)


def _mono(recipe):
    return {k: v for k, v in recipe.items()
            if not k.endswith("_R") and not k.startswith("stereo")}


# (nets, recipe, stereo data, frozen nets, regularized net)
STAGES = {"rigid": (RIGID, _mono(LOSS_RIGID_T1), False, (), None),
          "stereo": (RIGID, STEREO_RECIPE, True, (), None),
          "flow": (FLOW_NET, {"flowL2": 1.0, "flow_reg": 4e-7}, False, (), "flownet"),
          "joint": (JOINT, _mono(LOSS_RIGID_COMB), False, ("flownet",), None)}
BATCH, HEIGHT, WIDTH, LR = 2, 64, 128, 1e-4
CHECK_T_LR = np.array(chip_smoke.CHECK_T_LR, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _four_threads():
    # four intra-op threads: the workers beside this module keep their cores
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


class _PallasFactory(JModelFactory):
    """The JAX factory with its bfloat16 flownet on the Pallas cost
    volume, as on its TPU (on the CPU the factory picks the XLA fallback).
    In float32 the XLA cost volume is the kernel's function (float32
    products and sums) and compiles faster, so float32 keeps it."""

    def flow_net_factory(self, net_name):
        assert net_name == "PWCNet"
        return JPWCNet(dtype=self.dtype, use_pallas=self.dtype == jnp.bfloat16)


def _batch(stereo):
    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH, num_batches=1,
                               stereo=stereo, seed=3)
    batch = next(iter(dataset))
    for key in ("image5d", "image5d_R"):
        if key in batch:
            batch[key] = np.round((batch[key] + 1.0) * 127.5).astype(np.uint8)
    if stereo:
        batch["stereo_T_LR"] = np.tile(CHECK_T_LR, (BATCH, 1, 1))
    return dataset.config_keys(), batch


def _jax_step(stage, dtype, keys, batch, variables=None):
    """The JAX step in ``dtype``: (variables, metrics, gradients, new
    variables), the gradients from Adam's first moment."""
    nets, recipe, stereo, frozen, reg_net = STAGES[stage]
    jmodel = _PallasFactory(keys, nets, stereo=stereo, compute_dtype=dtype).get_model()
    jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
    if variables is None:
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)),
                          5)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables.get("batch_stats"),
                              tx=j_optimizer_factory("adam_constant", LR, frozen_nets=frozen))
    jloss = j_loss_factory(keys, recipe, SCALE_WEIGHT_T1, stereo=stereo, batch_size=BATCH)
    new_state, metrics = j_make_train_step(jmodel, jloss, regularize_net=reg_net,
                                           frozen_nets=frozen)(
        state, jfeats, jax.random.PRNGKey(0))
    opt_state = new_state.opt_state.inner_states["train"].inner_state if frozen \
        else new_state.opt_state
    grads = {net: jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9), mu)
             for net, mu in opt_state[0].mu.items()}
    new = jax.tree_util.tree_map(np.asarray, {"params": new_state.params,
                                              "batch_stats": new_state.batch_stats or {}})
    return variables, {k: float(v) for k, v in metrics.items()}, grads, new


def _port_step(stage, keys, batch, variables):
    nets, recipe, stereo, frozen, reg_net = STAGES[stage]
    model = ModelFactory(keys, nets, stereo=stereo, compute_dtype="bfloat16",
                         device="cpu").get_model()
    load_flax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = loss_factory(keys, recipe, SCALE_WEIGHT_T1, stereo=stereo, batch_size=BATCH)
    step = make_train_step(model, loss, optimizer_factory("adam_constant", LR, model,
                                                          frozen_nets=list(frozen)),
                           frozen_nets=list(frozen), regularize_net=reg_net)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return model, before, {k: float(v) for k, v in metrics.items()}, grads


def _dist(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b))


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return _dist(a, b) / max(float(np.linalg.norm(b)), 1e-30)


def check_bf16_step(stage):
    """The distance-rule checks of one stage's bfloat16 step."""
    nets, recipe, stereo, frozen, _ = STAGES[stage]
    keys, batch = _batch(stereo)
    with full_f32():
        variables, m16, g16, new16 = _jax_step(stage, "bfloat16", keys, batch)
        _, m32, g32, new32 = _jax_step(stage, "float32", keys, batch, variables)
        model, before, metrics, grads = _port_step(stage, keys, batch, variables)

    # the loss and its terms
    terms = ["loss"] + [f"loss/{k}" for k in recipe]
    assert set(metrics) == set(m16) and set(terms) <= set(metrics)
    ref_rel = max(abs(m16[k] - m32[k]) / abs(m32[k]) for k in terms)
    for key in terms:
        assert np.isfinite(metrics[key]), key
        rel = abs(metrics[key] - m16[key]) / abs(m16[key])
        assert rel <= 4 * ref_rel + 1e-6, (key, metrics[key], m16[key], m32[key], ref_rel)

    # the parameter gradients, float32, of the nets that train
    trained = [net for net in g16 if net not in frozen]
    assert {n.split(".")[0] for n in grads} == set(trained)
    assert all(g.dtype == torch.float32 for g in grads.values())
    ref16 = flax_params_to_torch({n: g16[n] for n in trained}, _sub(model, trained))
    ref32 = flax_params_to_torch({n: g32[n] for n in trained}, _sub(model, trained))
    port, base = [], []
    for name, grad in grads.items():
        got, want, want32 = grad.numpy(), ref16[name].numpy(), ref32[name].numpy()
        if np.linalg.norm(want32) < 1e-7:
            # a projection BN's bias, whose gradient is 0 but for rounding:
            # held by its absolute distance, as the others by their relative one
            assert _dist(got, want) <= 4 * _dist(want, want32) + 1e-7, name
            continue
        port.append(_rel(got, want))
        base.append(_rel(want, want32))
    assert np.median(port) <= 2 * np.median(base), (np.median(port), np.median(base))
    assert max(port) <= 4 * max(base), (max(port), max(base))

    # the BatchNorm running statistics, pooled
    want16 = flax_to_state_dict(new16, model)
    want32 = flax_to_state_dict(new32, model)
    state = model.state_dict()
    stats = [k for k in state if k.endswith(("running_mean", "running_var"))
             and k.split(".")[0] not in frozen]
    assert bool(stats) == ("depth" in nets)
    if stats:
        pool = lambda d: np.concatenate([d[k].numpy().ravel() for k in stats])
        assert all(state[k].dtype == torch.float32 for k in stats)
        assert_bf16_distance(pool(state), pool(want16), pool(want32), "BN statistics")

    # the updated parameters: Adam's first step, sign by sign
    params = [n for n in grads]
    pool = lambda d: np.concatenate([d[k].numpy().ravel() for k in params])
    got, w16, w32, start = pool(state), pool(want16), pool(want32), pool(before)
    rounding = np.maximum(1e-7, np.spacing(np.abs(w16)))
    assert np.all(np.abs(got - w16) <= 2 * LR + rounding)
    assert np.mean(np.abs(got - w16)) <= 2 * np.mean(np.abs(w16 - w32)) + 1e-9
    for name in params:
        assert not torch.equal(state[name], before[name]), f"{name} did not move"
    for key, value in state.items():  # a frozen net is bit-unchanged
        if key.split(".")[0] in frozen:
            assert torch.equal(value, before[key]), key


def _sub(model, nets):
    """A module holding only ``nets`` of ``model``, for the converter."""
    holder = torch.nn.Module()
    for net in nets:
        holder.add_module(net, getattr(model, net))
    return holder


@pytest.mark.parametrize("stage", ["rigid"])
def test_bf16_train_step_matches_jax(stage):
    check_bf16_step(stage)
