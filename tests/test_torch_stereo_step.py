"""One stereo train step of the port against the JAX package's, per
published stereo recipe: ``LOSS_RIGID_T1`` and ``LOSS_RIGID_T2``
(EfficientNetB0 + PoseNetImproved), ``LOSS_RIGID_COMB`` (the three nets,
the flownet frozen) and ``LOSS_FLOW`` (PWCNet alone, regularized), each on
one uint8-coded stereo batch of 2 snippets at 64x128 from the same
weights: every loss term, every parameter gradient, the BatchNorm running
statistics and the Adam update.

Inputs and weights come from seeded numpy RandomStates and go, as the
same arrays, to both sides (weights through ``xpt_mde_tpu_torch.convert``).
The combined losses keep a pixel's static error only where it is below
the flow error; each comparison of a combined term allows the pixels
within a float32 gap of a tie their whole share (the method of
test_torch_joint.py, with the gap measured against a float64 forward).

The synthetic world's extrinsic is a pure x translation, so the
cross-synthesis maps each row onto itself: the reprojected v lands on
an integer, or a rounding away from it, and the warp takes a pixel whose
floor and ceil coincide as invalid. Which pixels do differs with the
order of float32 operations, and with it the stereo terms (by ~1e-3 on
this batch). The steps therefore run at CHECK_T_LR, the dataset's
baseline with a vertical offset, as real calibrations have, which moves
v off the integers.

The recipes' cases are split over this file and
test_torch_stereo_joint_step.py (the three-net and the flow recipes), so
that each file's JAX compilations stay near a minute and a half on one
worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from xpt_mde_tpu.config import (FLOW_NET, LOSS_FLOW, LOSS_RIGID_COMB, LOSS_RIGID_MD2,
                                LOSS_RIGID_T1, LOSS_RIGID_T2, SCALE_WEIGHT_T1)
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.convert import (flax_params_to_torch, flax_to_state_dict,
                                       load_flax_variables)
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.losses import photometric as tphoto
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
from xpt_mde_tpu_torch.utils.image import resize_image
from xpt_mde_tpu_torch.utils.precision import full_f32

RIGID = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
JOINT = dict(RIGID, **FLOW_NET)
# (nets, recipe, the step's frozen nets, its regularized net)
CASES = {"LOSS_RIGID_T1": (RIGID, LOSS_RIGID_T1, (), None),
         "LOSS_RIGID_T2": (RIGID, LOSS_RIGID_T2, (), None),
         "LOSS_RIGID_COMB": (JOINT, LOSS_RIGID_COMB, ("flownet",), None),
         "LOSS_FLOW": (FLOW_NET, LOSS_FLOW, (), "flownet"),
         # the model zoo's case (test_torch_zoo_step.py)
         "LOSS_RIGID_MD2": ({"depth": "MobileNetV2", "camera": "PoseNetDeep"}, LOSS_RIGID_MD2,
                            (), None)}
BATCH, HEIGHT, WIDTH, LR = 2, 64, 128, 1e-4
# right -> left: the synthetic baseline (0.3 m) and a 13 mm vertical offset
CHECK_T_LR = np.array(chip_smoke.CHECK_T_LR, np.float32)


@pytest.fixture(autouse=True, scope="module")
def _four_threads():
    # four intra-op threads, as test_torch_joint.py: they keep the workers
    # beside this module from oversubscribing the cores and fix the CPU's
    # summation order whatever the host's core count
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


def _fill(shapes, seed):
    """Kernels of unit gain, biases of 0.05, random BN statistics and
    scales, so a swapped mapping shows and the flows are of order 1."""
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean", "input_mean"):
            return (rng.randn(*sd.shape) * 0.05).astype(np.float32)
        return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tie_allowance(method, augm, augm64, sfx):
    """The most the combined term of ``method`` on side ``sfx`` can move
    when every pixel whose static and flow errors lie within 4 times the
    sum of their float32 errors (against the float64 forward) flips its
    side, scale weighted and summed over the batch; and the share of
    such pixels."""
    photo = tphoto.PHOTOMETRIC_FNS[method]

    def maps(a):
        target = a["target" + sfx]
        ho, wo = target.shape[1:3]
        flow = photo(resize_image(a["warped_target_ms" + sfx][0], ho, wo), target, reduce=False)
        return flow, [photo(resize_image(s, ho, wo), target, reduce=False)
                      for s in a["synth_target_ms" + sfx]]

    (flow, statics), (flow64, statics64) = maps(augm), maps(augm64)
    flow_err = (flow.double() - flow64).abs()
    allowance, ties, total = 0.0, 0, 0
    for weight, static, static64 in zip(SCALE_WEIGHT_T1, statics, statics64):
        gap = 4 * (flow_err + (static.double() - static64).abs())
        near = ((static - flow).abs() <= gap) & (static > 0)
        allowance += weight * float((static * near).sum()) / static[0].numel()
        ties += int(near.sum())
        total += near.numel()
    return allowance, ties / total


def stereo_batch():
    """The steps' batch: 2 uint8-coded stereo snippets at 64x128, at
    CHECK_T_LR."""
    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH, num_batches=1,
                               stereo=True, seed=3)
    batch = next(iter(dataset))
    for key in ("image5d", "image5d_R"):
        batch[key] = np.round((batch[key] + 1.0) * 127.5).astype(np.uint8)
    batch["stereo_T_LR"] = np.tile(CHECK_T_LR, (BATCH, 1, 1))
    return batch


def _one_step(case):
    """The JAX step and the port's on one stereo batch from the same
    weights."""
    nets, recipe, frozen, reg_net = CASES[case]
    batch = stereo_batch()
    keys = list(batch)

    jmodel = JModelFactory(keys, nets).get_model()
    jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)), 5)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables.get("batch_stats"),
                              tx=j_optimizer_factory("adam_constant", LR, frozen_nets=frozen))
    jloss = j_loss_factory(keys, recipe, SCALE_WEIGHT_T1, batch_size=BATCH)
    new_state, jmetrics = j_make_train_step(jmodel, jloss, regularize_net=reg_net,
                                            frozen_nets=frozen)(
        state, jfeats, jax.random.PRNGKey(0))
    # Adam's first moment after one step is (1 - b1) * g, for the nets that train
    opt_state = new_state.opt_state.inner_states["train"].inner_state if frozen \
        else new_state.opt_state
    jgrads = {net: jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9), mu)
              for net, mu in opt_state[0].mu.items()}
    for net in frozen:  # a frozen net's gradient is 0
        jgrads[net] = jax.tree_util.tree_map(np.zeros_like, variables["params"][net])
    jnew = jax.tree_util.tree_map(np.asarray, {"params": new_state.params,
                                               "batch_stats": new_state.batch_stats or {}})

    model = ModelFactory(keys, nets, device="cpu").get_model()
    load_flax_variables(model, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss = loss_factory(keys, recipe, SCALE_WEIGHT_T1, batch_size=BATCH)
    step = make_train_step(model, loss, optimizer_factory("adam_constant", LR, model,
                                                          frozen_nets=list(frozen)),
                           frozen_nets=list(frozen), regularize_net=reg_net)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    allowance = {}
    if "cmbL1" in recipe:
        # the combined terms' inputs at the step's own train-mode forward from
        # the initial weights, in float32 and in float64
        augms = []
        for dtype in (torch.float32, torch.float64):
            check = ModelFactory(keys, nets, device="cpu").get_model()
            load_flax_variables(check, variables)
            check.to(dtype)
            with torch.no_grad():
                tfeats = {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}
                for key in ("image5d", "image5d_R"):
                    tfeats[key] = tfeats[key] * (2.0 / 255.0) - 1.0
                preds = check.train()(tfeats)
                augm = loss.append_data(tfeats, preds)
                augm.update(loss.append_data(tfeats, preds, "_R"))
                augms.append(augm)
        for sfx in ("", "_R"):
            for method in ("L1", "SSIM"):
                per_batch, tie_share = _tie_allowance(method, *augms, sfx)
                assert tie_share < 1e-4, (method, sfx, tie_share)
                allowance[f"loss/cmb{method}{sfx}"] = per_batch / BATCH
        allowance["loss"] = sum(recipe[k[5:]] * v for k, v in allowance.items())
    return dict(model=model, before=before, metrics=metrics, grads=grads, jmetrics=jmetrics,
                jgrads=jgrads, jnew=jnew, allowance=allowance, recipe=recipe, frozen=frozen)


def check_stereo_step(case):
    """The checks of one recipe's step."""
    with full_f32():
        r = _one_step(case)
    model, metrics, jmetrics = r["model"], r["metrics"], r["jmetrics"]

    # the losses: every term of the recipe, rtol 1e-5 (as test_torch_train.py:
    # float32 on both sides, the same train-mode forward summed in another
    # order), plus each combined term's near-tie allowance
    assert set(metrics) == set(jmetrics)
    assert {f"loss/{k}" for k in r["recipe"]} <= set(metrics)
    for key in ["loss"] + [f"loss/{k}" for k in r["recipe"]]:
        got, want = float(metrics[key]), float(jmetrics[key])
        bound = 1e-5 * abs(want) + 1e-7 + r["allowance"].get(key, 0.0)
        assert abs(got - want) <= bound, (key, got, want, bound)

    # the gradients. The smoothness terms take |d disparity|, whose
    # derivative jumps where two neighbouring disparities tie; on this
    # batch two pixels of the right view's finest disparity tie in the
    # port's float32 and not in JAX's, which moves the gradient with
    # respect to that depth map by 0.6% (the other terms' gradients agree
    # to 3e-5 at the same predictions, and each stereo term's to 1e-4 in
    # test_torch_stereo.py). Through the depth net that spreads to 2-4e-3
    # of every depth-net tensor under the rigid recipes (measured: max
    # 3.7e-3, median 2.9e-3 with smoothe_R at weight 20), against 3e-5
    # under LOSS_FLOW, which has no smoothness term; LOSS_RIGID_T2 without
    # its two smoothness terms agrees to 6.1e-4 (median 1.4e-4), inside the
    # 1e-3 that test_torch_train.py holds. So each tensor within 1e-2 of
    # its norm and the median within 5e-3; atol 1e-7 for the projection
    # BNs' biases, 0 but for float noise
    ref = flax_params_to_torch(r["jgrads"], model)
    trained = {n for n, _ in model.named_parameters()
               if n.split(".")[0] not in r["frozen"]}
    assert set(r["grads"]) == trained
    rel = []
    for name, grad in r["grads"].items():
        want = ref[name].numpy()
        err, norm = float(np.linalg.norm(grad.numpy() - want)), float(np.linalg.norm(want))
        assert err <= 1e-2 * norm + 1e-7, (name, err, norm)
        if norm > 1e-6:
            rel.append(err / norm)
    assert np.median(rel) <= 5e-3, np.median(rel)

    # the updated state: running statistics as test_torch_train.py holds
    # them; Adam's first step as test_torch_joint.py bounds it; a frozen
    # net bit-unchanged on both sides
    want = flax_to_state_dict(r["jnew"], model)
    eps, same_sign, total = 1e-8, 0, 0
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        got, ref_value = value.numpy(), want[key].numpy()
        if key.split(".")[0] in r["frozen"]:
            np.testing.assert_array_equal(got, r["before"][key].numpy(), err_msg=key)
            np.testing.assert_array_equal(ref_value, r["before"][key].numpy(), err_msg=key)
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, ref_value, atol=2e-5, rtol=1e-5, err_msg=key)
            assert not np.array_equal(got, r["before"][key].numpy()), key
            continue
        if key not in r["grads"]:  # the input normalization buffers
            np.testing.assert_array_equal(got, ref_value, err_msg=key)
            continue
        rounding = np.maximum(1e-7, np.spacing(np.abs(ref_value)))
        assert np.all(np.abs(got - ref_value) <= 2 * LR + rounding), key
        g, rg = r["grads"][key].numpy(), ref[key].numpy()
        same = np.sign(g) == np.sign(rg)
        bound = LR * eps * np.abs(g - rg) / ((np.abs(g) + eps) * (np.abs(rg) + eps)) + rounding
        assert np.all(np.abs(got - ref_value)[same] <= bound[same]), key
        assert np.any(got != r["before"][key].numpy()), f"{key} did not move"
        same_sign += int(same.sum())
        total += same.size
    assert same_sign >= 0.99 * total, (same_sign, total)


@pytest.mark.parametrize("case", ["LOSS_RIGID_T1", "LOSS_RIGID_T2"])
def test_stereo_train_step_matches_jax(case):
    check_stereo_step(case)
