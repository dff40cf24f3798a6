"""Whole train steps of the model zoo against the JAX package's:

- the stereo step of MobileNetV2 + PoseNetDeep under ``LOSS_RIGID_MD2``
  (``test_torch_stereo_step._one_step``: one uint8-coded stereo batch of 2
  snippets at 64x128 from the same weights, at CHECK_T_LR);
- the accumulating step (``grad_accum_steps=2``, EfficientNetB0 +
  PoseNetImproved, batch 4 at 64x128) against JAX's ``lax.scan`` step;
- a BatchNorm-free net (DepthNetBasic + PoseNetBasic) whose k = 2 update
  equals its k = 1 update within float summation order, as JAX's test
  holds its own.

The MD2 step is held to a float64 run of the port, not to JAX's float32
step alone. The pipeline's [-1, 1] images, "tf"-mode preprocessed (x /
127.5 - 1), reach MobileNetV2 as -1 +- 0.008: every stem channel is
nearly constant, and the train-mode BatchNorms' backward loses most of
float32's digits there. Measured on this batch: the backbone's parameter
gradients sit a median 21% from the float64 step's in the port's float32
and 23% in JAX's (they differ from each other by 16%), the decoder's
0.3% / 0.5%, the pose net's 0.01% / 0.1%; EfficientNetB0, whose input
normalization keeps the channels centred, sits at 0.02-0.06%. One
coarse-scale pixel of the right view's md2 terms also falls on the other
side of the warp's validity in JAX's float32 (md2L1_R 8e-4 from float64;
the port's 8e-6). So the rule is the card's in ``chip_smoke.py``: the
port's float32 step as close to the float64 step as JAX's float32 step,
each loss term within that distance plus 1e-5 relative, the gradients'
median and maximum relative distances at most 1.5x JAX's (the backbone's,
the decoder's and the pose net's apart), each running statistic within
1.5x JAX's distance plus ``check_stereo_step``'s atol; the Adam update
as ``check_stereo_step`` bounds it. JAX's own distance from the float64
step is bounded too (each loss term 1e-3, each group's median gradient
0.3 for MobileNetV2, 1e-2 elsewhere), which ties the float64 step to the
JAX package's semantics. The accumulating step's gradients and running
statistics go by the same rule: on its batch EfficientNetB0's step sits
~4e-3 from float64 in either package's float32, at k = 1 too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_stereo_step as stereo_step
from test_torch_train import NETS_B0, RECIPE, _fill, _grad_close
from xpt_mde_tpu.config import SCALE_WEIGHT_T1
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.convert import (flax_params_to_torch, flax_to_state_dict,
                                       load_flax_variables)
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
from xpt_mde_tpu_torch.utils.precision import full_f32

GRAD_RATIO = 1.5  # chip_smoke.GRAD_MEDIAN_RATIO


@pytest.fixture(autouse=True, scope="module")
def _four_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    with full_f32():
        yield


def _float64_step(nets, recipe, batch, before, stereo=True, **step_kwargs):
    """The port's step in float64 from the weights ``before`` on ``batch``
    (its uint8 images decoded in float64): (metrics, gradients, the state
    after it)."""
    model = ModelFactory(list(batch), nets, stereo=stereo, device="cpu").get_model()
    model.load_state_dict(before)
    model.double()
    batch_size = len(batch["image5d"])
    step = make_train_step(model, loss_factory(list(batch), recipe, SCALE_WEIGHT_T1,
                                               stereo=stereo, batch_size=batch_size),
                           optimizer_factory("adam_constant", 1e-4, model), **step_kwargs)
    feats = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    for key in ("image5d", "image5d_R"):  # the step's decode, in float64
        if key in feats:
            feats[key] = feats[key] * (2.0 / 255.0) - 1.0
    metrics = step(feats)
    return metrics, {n: p.grad for n, p in model.named_parameters()}, model.state_dict()


def _check_by_float64(grads, jgrads, grads64, state, jstate, state64, before, anchors):
    """The port's float32 gradients and running statistics at least as
    close to the float64 step as JAX's: per group of parameters (the keys
    of ``anchors``) the median and the maximum relative distance at most
    GRAD_RATIO times JAX's; each statistic tensor's largest distance at
    most GRAD_RATIO times JAX's plus check_stereo_step's atol 2e-5. Each
    group's ``anchors`` value bounds JAX's own median distance from the
    float64 step, which ties that step to the JAX package's semantics."""
    assert set(grads) == set(jgrads) == set(grads64)
    for group, anchor in anchors.items():
        port, jax_ = [], []
        for name, ref in grads64.items():
            norm = float(ref.norm())
            if name.startswith(group) and norm > 1e-6:
                port.append(float((grads[name].double() - ref).norm()) / norm)
                jax_.append(float((jgrads[name].double() - ref).norm()) / norm)
        assert port, group
        assert np.median(jax_) <= anchor, (group, np.median(jax_))
        assert np.median(port) <= GRAD_RATIO * np.median(jax_), (group, np.median(port),
                                                                 np.median(jax_))
        assert max(port) <= GRAD_RATIO * max(jax_), (group, max(port), max(jax_))
    stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert stats
    for key in stats:
        exact = state64[key].numpy()
        port = float(np.abs(state[key].numpy() - exact).max())
        assert port <= GRAD_RATIO * float(np.abs(jstate[key].numpy() - exact).max()) + 2e-5, key
        assert not np.array_equal(state[key].numpy(), before[key].numpy()), key


def test_zoo_stereo_md2_step_matches_jax_by_float64():
    r = stereo_step._one_step("LOSS_RIGID_MD2")
    nets, recipe, _, _ = stereo_step.CASES["LOSS_RIGID_MD2"]
    metrics64, grads64, state64 = _float64_step(nets, recipe, stereo_step.stereo_batch(),
                                                r["before"])
    model, metrics, jmetrics = r["model"], r["metrics"], r["jmetrics"]

    assert set(metrics) == set(jmetrics)
    assert {f"loss/{k}" for k in recipe} <= set(metrics)
    for key in ["loss"] + [f"loss/{k}" for k in recipe]:
        got, want, ref = float(metrics[key]), float(jmetrics[key]), float(metrics64[key])
        assert abs(want - ref) <= 1e-3 * abs(ref), (key, want, ref)
        assert abs(got - ref) <= abs(want - ref) + 1e-5 * abs(ref) + 1e-7, (key, got, want, ref)

    want = flax_to_state_dict(r["jnew"], model)
    _check_by_float64(r["grads"], flax_params_to_torch(r["jgrads"], model), grads64,
                      model.state_dict(), want, state64, r["before"],
                      {"depthnet.backbone.": 0.3, "depthnet.DepthDecoder_0.": 1e-2,
                       "posenet.": 1e-2})
    lr = stereo_step.LR
    for key, value in model.state_dict().items():
        if key in r["grads"]:
            # Adam's first step moves each weight by at most lr (either sign)
            got, ref_value = value.numpy(), want[key].numpy()
            rounding = np.maximum(1e-7, np.spacing(np.abs(ref_value)))
            assert np.all(np.abs(got - ref_value) <= 2 * lr + rounding), key
            assert np.any(got != r["before"][key].numpy()), f"{key} did not move"


def _mono_batch(batch_size, seed=3, height=64, width=128):
    dataset = SyntheticDataset(batch_size=batch_size, height=height, width=width,
                               num_batches=1, seed=seed)
    batch = next(iter(dataset))
    batch["image5d"] = np.round((batch["image5d"] + 1.0) * 127.5).astype(np.uint8)
    return dataset.config_keys(), batch


def test_grad_accum_step_matches_jax():
    """k = 2 microbatches of 2 (EfficientNetB0 + PoseNetImproved): the
    losses (summed over the microbatches) within test_torch_train_step.py's
    tolerances; the summed gradients and the running statistics (folded
    once a microbatch) by the float64 rule; the update within Adam's
    first step."""
    keys, batch = _mono_batch(4)
    lr = 1e-4
    jmodel = JModelFactory(keys, NETS_B0, stereo=False).get_model()
    jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)), 5)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=j_optimizer_factory("adam_constant", lr))
    jloss = j_loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=4)
    new_state, jmetrics = j_make_train_step(jmodel, jloss, grad_accum_steps=2)(
        state, jfeats, jax.random.PRNGKey(0))
    jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9),
                                    new_state.opt_state[0].mu)
    jnew = jax.tree_util.tree_map(np.asarray, {"params": new_state.params,
                                               "batch_stats": new_state.batch_stats})

    model = ModelFactory(keys, NETS_B0, stereo=False, device="cpu").get_model()
    load_flax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(model, loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                               batch_size=4),
                           optimizer_factory("adam_constant", lr, model), grad_accum_steps=2)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()})

    assert set(metrics) == set(jmetrics)
    for key in ["loss"] + [f"loss/{k}" for k in RECIPE]:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    for key in ("depth_abs_rel", "depth_center_mean", "trj_err", "rot_err"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    # the gradients and statistics: this batch's B0 step sits ~4e-3 from
    # float64 in either package's float32 at k = 1 too, so by float64
    _, grads64, state64 = _float64_step(NETS_B0, RECIPE, batch, before, stereo=False,
                                        grad_accum_steps=2)
    want = flax_to_state_dict(jnew, model)
    _check_by_float64({n: p.grad for n, p in model.named_parameters()},
                      flax_params_to_torch(jgrads, model), grads64, model.state_dict(), want,
                      state64, before, {"depthnet.": 1e-2, "posenet.": 1e-2})
    for name, _ in model.named_parameters():
        assert np.abs(model.state_dict()[name].numpy() - want[name].numpy()).max() \
            <= 2 * lr + 1e-6, name


def test_grad_accum_without_batch_norm_equals_one_batch():
    """DepthNetBasic + PoseNetBasic have no BatchNorm, so k = 2
    microbatches give the whole batch's gradients up to float summation
    order (1e-5 of each tensor's norm) and the same Adam update."""
    keys, batch = _mono_batch(4, seed=4, height=32, width=64)
    nets = {"depth": "DepthNetBasic", "camera": "PoseNetBasic"}
    runs = []
    for k in (1, 2):
        model = ModelFactory(keys, nets, stereo=False, device="cpu", seed=5).get_model()
        step = make_train_step(model, loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False,
                                                   batch_size=4),
                               optimizer_factory("adam_constant", 1e-4, model),
                               grad_accum_steps=k)
        metrics = step({key: torch.from_numpy(v) for key, v in batch.items()})
        runs.append((metrics, {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: p.detach().clone() for n, p in model.named_parameters()}))
    (m1, g1, p1), (m2, g2, p2) = runs
    for key in ["loss"] + [f"loss/{k}" for k in RECIPE]:
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=1e-6, err_msg=key)
    for name, grad in g1.items():
        # atol 1e-7: biases whose gradient is 0 but for float noise
        _grad_close(g2[name].numpy(), grad.numpy(), name, 1e-5, 1e-7)
        assert float((p2[name] - p1[name]).abs().max()) <= 1e-6, name
