"""The port's whole rigid train step against the JAX package: one train
step of EfficientNetB0 + PoseNetImproved (losses, gradients, the Adam
update and the BatchNorm statistics), the loss falling over further
steps, a frozen net, the step's guards, and a float64 step. The modules
the step differentiates through are held in test_torch_train.py, whose
helpers and fixtures these tests share; the two files split one module's
tests only to keep each file's time on one worker short.

Inputs and weights come from seeded numpy RandomStates and go, as the
same arrays, to both sides (weights through ``xpt_mde_tpu_torch.convert``).
Each test states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import NETS_B0, RECIPE, _few_threads, _fill, _grad_close, _no_tf32  # noqa: F401
from xpt_mde_tpu.config import SCALE_WEIGHT_T1
from xpt_mde_tpu.data import SyntheticDataset
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.convert import (flax_params_to_torch, flax_to_state_dict,
                                       load_flax_variables)
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
from xpt_mde_tpu_torch.utils.precision import full_f32


BATCH, HEIGHT, WIDTH, LR = 2, 64, 128, 1e-4


@pytest.fixture(scope="module")
def one_step():
    """The JAX train step and the port's on the same batch and weights:
    (torch model, optimizer, step, features, torch metrics, torch grads,
    jax metrics, jax grads, jax updated variables, initial variables)."""
    with full_f32():
        dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                                   num_batches=1, seed=3)
        keys = dataset.config_keys()
        batch = next(iter(dataset))
        batch["image5d"] = np.round((batch["image5d"] + 1.0) * 127.5).astype(np.uint8)

        jmodel = JModelFactory(keys, NETS_B0, stereo=False).get_model()
        jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)), 5)
        state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  tx=j_optimizer_factory("adam_constant", LR))
        jloss = j_loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=BATCH)
        new_state, jmetrics = j_make_train_step(jmodel, jloss)(state, jfeats,
                                                               jax.random.PRNGKey(0))
        # Adam's first moment after one step is (1 - b1) * g
        jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9),
                                        new_state.opt_state[0].mu)
        jnew = jax.tree_util.tree_map(np.asarray, {"params": new_state.params,
                                                   "batch_stats": new_state.batch_stats})

        model = ModelFactory(keys, NETS_B0, stereo=False, device="cpu").get_model()
        load_flax_variables(model, variables)
        optimizer = optimizer_factory("adam_constant", LR, model)
        step = make_train_step(model, loss_factory(keys, RECIPE, SCALE_WEIGHT_T1,
                                                   stereo=False, batch_size=BATCH), optimizer)
        feats = {k: torch.from_numpy(v) for k, v in batch.items()}
        metrics = step(feats)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(model=model, step=step, feats=feats, metrics=metrics, grads=grads,
                jmetrics=jmetrics, jgrads=jgrads, jnew=jnew, variables=variables)


def test_train_step_losses_match_jax(one_step):
    metrics, jmetrics = one_step["metrics"], one_step["jmetrics"]
    assert set(metrics) == set(jmetrics)
    for key in ["loss"] + [f"loss/{k}" for k in RECIPE]:
        # 1e-5: float32 on both sides, the same train-mode forward
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    for key in ("depth_abs_rel", "depth_center_mean", "trj_err", "rot_err"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_train_step_gradients_match_jax(one_step):
    model = one_step["model"]
    ref = flax_params_to_torch(one_step["jgrads"], model)
    assert set(ref) == set(one_step["grads"])
    for name, grad in one_step["grads"].items():
        # rtol 1e-3 of the tensor's norm: float32 through ~100 layers and
        # train-mode BatchNorm on as few as 16 values per channel, summed in
        # another order. atol 1e-7: the projection BNs' biases whose shift
        # the next train-mode BN removes have a gradient that is 0 but for
        # float noise (norm ~1e-9 on either side)
        _grad_close(grad.numpy(), ref[name].numpy(), name, 1e-3, 1e-7)


def test_train_step_update_and_bn_stats_match_jax(one_step):
    model = one_step["model"]
    want = flax_to_state_dict(one_step["jnew"], model)
    before = flax_to_state_dict(one_step["variables"], model)
    grads = one_step["grads"]
    ref_grads = flax_params_to_torch(one_step["jgrads"], model)
    resolved = total = 0
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        got, ref = value.numpy(), want[key].numpy()
        if key.endswith(("running_mean", "running_var")):
            # flax's biased-variance update (the unbiased one would be off by
            # 1/15 of the 0.01 update at 16 values per channel, ~1e-4)
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5, err_msg=key)
            continue
        if key not in grads:  # the input normalization buffers
            np.testing.assert_array_equal(got, ref, err_msg=key)
            continue
        # Adam's first step moves a weight by lr * g / (|g| + 1e-8), ~lr in
        # magnitude: a gradient element that is float noise may have
        # either sign, so every weight is held within 2 lr ...
        assert np.abs(got - ref).max() <= 2 * LR + 1e-6, key
        # ... and where both gradients exceed 1e-6 with one sign (most
        # weights) the two updates differ by at most lr * 1e-8 / 1e-6 =
        # 1e-6, plus one ulp
        g, rg = grads[key].numpy(), ref_grads[key].numpy()
        mask = (np.sign(g) == np.sign(rg)) & (np.abs(g) > 1e-6) & (np.abs(rg) > 1e-6)
        np.testing.assert_allclose(got[mask], ref[mask], atol=2e-6, rtol=0, err_msg=key)
        assert np.any(got != before[key].numpy()), f"{key} did not move"
        resolved += int(mask.sum())
        total += mask.size
    assert resolved >= 0.8 * total, (resolved, total)


def test_train_step_loss_decreases(one_step):
    losses = [float(one_step["metrics"]["loss"])]
    for _ in range(3):
        metrics = one_step["step"](one_step["feats"])
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


def test_train_step_frozen_net_and_guards():
    dataset = SyntheticDataset(batch_size=1, height=32, width=64, num_batches=1, seed=1)
    keys = dataset.config_keys()
    model = ModelFactory(keys, NETS_B0, stereo=False, device="cpu", seed=2).get_model()
    loss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=1)
    optimizer = optimizer_factory("adam_constant", 1e-3, model, frozen_nets=["posenet"])
    step = make_train_step(model, loss, optimizer, frozen_nets=["posenet"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.eval()
    metrics = step({k: torch.from_numpy(v) for k, v in next(iter(dataset)).items()})
    assert not model.training  # the step restores the mode
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    after = model.state_dict()
    for key in before:
        moved = not torch.equal(before[key], after[key])
        if key.startswith("posenet."):
            assert not moved, key
        elif key.endswith("running_var") or key.endswith("Conv_0.weight"):
            assert moved, key  # the depth net trains, its BN statistics update
    assert all(p.requires_grad for p in model.posenet.parameters())
    assert all(p.grad is None for p in model.posenet.parameters())

    # a regularized net the model lacks adds nothing, as in JAX
    make_train_step(model, loss, optimizer, regularize_net="flownet")
    # gradient accumulation trains (test_torch_zoo_step.py holds it to
    # JAX) and raises as the JAX step does: k < 1, a loss without the
    # global batch, a batch that k does not divide
    with pytest.raises(ValueError, match=">= 1"):
        make_train_step(model, loss, optimizer, grad_accum_steps=0)
    unpinned = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False)
    with pytest.raises(ValueError, match="GLOBAL batch"):
        make_train_step(model, unpinned, optimizer, grad_accum_steps=2)
    accumulating = make_train_step(model, loss, optimizer, grad_accum_steps=2)
    with pytest.raises(ValueError, match="must divide"):
        accumulating({k: torch.from_numpy(v) for k, v in next(iter(dataset)).items()})


def test_train_step_keeps_float64():
    """A float64 model and batch train in float64 end to end (the depth
    and pose heads and the resizes compute in float32 or wider): the
    reference that the card's float32 gradients are held against."""
    dataset = SyntheticDataset(batch_size=1, height=32, width=64, num_batches=1, seed=4)
    keys = dataset.config_keys()
    model = ModelFactory(keys, NETS_B0, stereo=False, device="cpu", seed=3).get_model().double()
    loss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=1)
    feats = {k: torch.from_numpy(v).double() for k, v in next(iter(dataset)).items()}
    with torch.no_grad():
        preds = model(feats)
    assert preds["depth_ms"][0].dtype == preds["pose"].dtype == torch.float64
    metrics = make_train_step(model, loss, optimizer_factory("sgd", 1e-3, model))(feats)
    assert metrics["loss"].dtype == torch.float64 and bool(torch.isfinite(metrics["loss"]))
    assert all(p.grad.dtype == torch.float64 for p in model.parameters())
