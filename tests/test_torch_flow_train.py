"""One flow train step of the port against the JAX package's: PWC-Net
alone, the flow stage's recipe ``{"flowL2": 1.0, "flow_reg": 4e-7}`` with
``regularize_net="flownet"`` and Adam at 1e-4, at 64x128, batch 2, 2
sources. Losses, every gradient, and the updated parameters.

Inputs and weights come from seeded numpy RandomStates and go, as the
same arrays, to both sides (weights through ``xpt_mde_tpu_torch.convert``);
the JAX side runs its XLA correlation and samplers on the CPU. Each test
states its tolerance and why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.config import LOSS_FLOW, SCALE_WEIGHT_T1
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

KEYS = ["image", "intrinsic"]
NETS = {"flow": "PWCNet"}
RECIPE = {k: v for k, v in LOSS_FLOW.items() if k != "flowL2_R"}
BATCH, SNIPPET, HEIGHT, WIDTH, LR = 2, 3, 64, 128, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # four intra-op threads: the workers beside this module share the
    # cores, and the CPU's summation order stays the same on any host
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


def _fill(shapes, seed):
    """Kernels of unit gain and biases of 0.05 from numpy: the flows come
    out of order 1, so the warps' coordinates are generic (away from the
    integer pixels where the bilinear warp has kinks)."""
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        if path[-1].key == "kernel":
            return (rng.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        return (rng.randn(*sd.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch():
    rng = np.random.RandomState(21)
    image5d = rng.uniform(0, 255, (BATCH, SNIPPET, HEIGHT, WIDTH, 3)).round().astype(np.uint8)
    intrinsic = np.tile(np.array([[0.6 * WIDTH, 0, WIDTH / 2], [0, 0.6 * WIDTH, HEIGHT / 2],
                                  [0, 0, 1]], np.float32), (BATCH, 1, 1))
    return {"image5d": image5d, "intrinsic": intrinsic}


@pytest.fixture(scope="module")
def one_step():
    with full_f32():
        batch = _batch()
        jmodel = JModelFactory(KEYS, NETS, stereo=False).get_model()
        jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)), 22)
        state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  tx=j_optimizer_factory("adam_constant", LR))
        jloss = j_loss_factory(KEYS, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=BATCH)
        new_state, jmetrics = j_make_train_step(jmodel, jloss, regularize_net="flownet")(
            state, jfeats, jax.random.PRNGKey(0))
        # Adam's first moment after one step is (1 - b1) * g
        jgrads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9),
                                        new_state.opt_state[0].mu)
        jnew = jax.tree_util.tree_map(np.asarray, {"params": new_state.params})

        model = ModelFactory(KEYS, NETS, stereo=False, device="cpu").get_model()
        load_flax_variables(model, variables)
        loss = loss_factory(KEYS, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=BATCH)
        step = make_train_step(model, loss, optimizer_factory("adam_constant", LR, model),
                               regularize_net="flownet")
        feats = {k: torch.from_numpy(v) for k, v in batch.items()}
        metrics = step(feats)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return dict(model=model, step=step, feats=feats, metrics=metrics, grads=grads,
                jmetrics=jmetrics, jgrads=jgrads, jnew=jnew, variables=variables)


def test_flow_train_step_losses_match_jax(one_step):
    metrics, jmetrics = one_step["metrics"], one_step["jmetrics"]
    assert set(metrics) == set(jmetrics) == {"loss", "loss/flowL2", "loss/flow_reg"}
    for key in metrics:
        # 1e-5: float32 on both sides, the same forward summed in another order
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert float(metrics["loss/flow_reg"]) > 0.0


def test_flow_train_step_gradients_match_jax(one_step):
    model = one_step["model"]
    ref = flax_params_to_torch(one_step["jgrads"], model)
    assert set(ref) == set(one_step["grads"]) == {n for n, _ in model.named_parameters()}
    for name, grad in one_step["grads"].items():
        want = ref[name].numpy()
        err = float(np.linalg.norm(grad.numpy() - want))
        # rtol 1e-3 of the tensor's norm: float32 through ~60 convs, 5 cost
        # volumes and 8 warps, summed in another order (the regularizer's
        # share, 4e-7 * w, is exact on both sides)
        bound = 1e-3 * float(np.linalg.norm(want)) + 1e-8
        assert err <= bound, f"{name}: |diff| {err:.3g} > {bound:.3g}"


def test_flow_train_step_update_matches_jax(one_step):
    """Adam's first step moves a weight by lr * g / (|g| + eps), so two
    gradients g, g' of one sign give updates at most
    lr * eps * |g - g'| / ((|g| + eps)(|g'| + eps)) apart: each weight is
    held to that bound from the two steps' own gradients (held to each
    other by the test above), plus 1e-7 for the weight's float32
    rounding; every weight within 2 lr whatever the signs."""
    model = one_step["model"]
    want = flax_to_state_dict(one_step["jnew"], model)
    before = flax_to_state_dict({"params": one_step["variables"]["params"]}, model)
    ref_grads = flax_params_to_torch(one_step["jgrads"], model)
    eps, same_sign, total = 1e-8, 0, 0
    for key, value in model.state_dict().items():
        got, ref = value.numpy(), want[key].numpy()
        assert np.abs(got - ref).max() <= 2 * LR + 1e-7, key
        g, rg = one_step["grads"][key].numpy(), ref_grads[key].numpy()
        same = np.sign(g) == np.sign(rg)
        bound = LR * eps * np.abs(g - rg) / ((np.abs(g) + eps) * (np.abs(rg) + eps)) + 1e-7
        assert np.all(np.abs(got - ref)[same] <= bound[same]), key
        assert np.any(got != before[key].numpy()), f"{key} did not move"
        same_sign += int(same.sum())
        total += same.size
    assert same_sign >= 0.99 * total, (same_sign, total)


def test_regularized_net_is_never_frozen(one_step):
    """JAX drops the regularized net from the frozen set: a step with
    flownet listed as frozen and regularized still trains every weight."""
    model, feats = one_step["model"], one_step["feats"]
    loss = loss_factory(KEYS, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=BATCH)
    step = make_train_step(model, loss, optimizer_factory("adam_constant", LR, model),
                           frozen_nets=["flownet"], regularize_net="flownet")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = step(feats)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(not torch.equal(before[k], v) for k, v in model.state_dict().items())
