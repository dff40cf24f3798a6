"""The joint stage of the port against the JAX package: the combined loss
(``cmbL1``, ``cmbSSIM``) and one joint train step at EfficientNetB0 +
PoseNetImproved + PWCNet with the flownet frozen.

Inputs and weights come from seeded numpy RandomStates and go, as the
same arrays, to both sides (weights through ``xpt_mde_tpu_torch.convert``).
The combined loss keeps a pixel's static error only where it is below
the flow error: a hard threshold, so a pixel whose two errors tie within
float rounding may fall on either side on either package. Each
comparison of a combined loss therefore first finds the pixels within
``gap`` of a tie on its own inputs and allows each its whole
contribution to the loss on top of the stated tolerance, and checks that
such pixels are rare. For the train step ``gap`` is set per pixel, to 4
times the sum of the float32 errors of the port's static and flow errors
there, measured against a float64 forward of the same weights: each
package's float32 error is of that size, so the two packages' errors of
the difference static - flow differ by at most twice that sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.config import SCALE_WEIGHT_T1, SCALE_WEIGHT_T2
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.losses import total as jtotal
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.convert import (flax_params_to_torch, flax_to_state_dict,
                                       load_flax_variables)
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.losses import photometric as tphoto
from xpt_mde_tpu_torch.losses import total as ttotal
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
from xpt_mde_tpu_torch.utils.image import resize_image
from xpt_mde_tpu_torch.utils.precision import full_f32

NETS = {"depth": "EfficientNetB0", "camera": "PoseNetImproved", "flow": "PWCNet"}
RECIPE = {"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 20.0}
BATCH, HEIGHT, WIDTH, LR = 2, 64, 128, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _four_threads():
    # these steps are heavy: four intra-op threads keep the test workers
    # that run beside this module from oversubscribing the cores, and fix
    # the CPU's summation order whatever the host's core count (with two
    # threads torch's CPU reductions take another order, under which this
    # float32 step's depth-net gradients sit ~9e-4 from JAX's even under
    # the rigid recipe; with 4 or 8, ~6e-5)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    # parity is checked in full float32: TF32 off for cuBLAS and cuDNN
    with full_f32():
        yield


def _error_maps(method, augm):
    """The full-resolution flow error and each scale's static error."""
    photo = tphoto.PHOTOMETRIC_FNS[method]
    target = augm["target"]
    ho, wo = target.shape[1:3]
    flow = photo(resize_image(augm["warped_target_ms"][0], ho, wo), target, reduce=False)
    return flow, [photo(resize_image(s, ho, wo), target, reduce=False)
                  for s in augm["synth_target_ms"]]


def _tie_allowance(method, augm, scale_weights, gap=None, augm64=None):
    """The most the combined loss of ``method`` ([batch]) can move when
    every pixel whose static and flow errors lie within the gap of each
    other flips its side: the sum of those pixels' static errors, scale
    weighted, over the element count. Also the share of such pixels (a
    pixel whose static error is 0 counts 0 either way and is left out).

    :param gap: one gap for every pixel, or
    :param augm64: the same inputs from a float64 forward, which sets each
        pixel's gap (see the module docstring)
    """
    flow, statics = _error_maps(method, augm)
    if augm64 is not None:
        flow64, statics64 = _error_maps(method, augm64)
        flow_err = (flow.double() - flow64).abs()
    allowance, ties, total = 0.0, 0, 0
    for i, (weight, static) in enumerate(zip(scale_weights, statics)):
        if augm64 is not None:
            gap = 4 * (flow_err + (static.double() - statics64[i]).abs())
        near = ((static - flow).abs() <= gap) & (static > 0)
        allowance = allowance + weight * (static * near).sum(dim=(1, 2, 3, 4)) / static[0].numel()
        ties += int(near.sum())
        total += near.numel()
    return allowance, ties / total


def _pyramids(seed, batch=2, numsrc=4, height=32, width=64):
    """Synthesized views at four scales (10% black, invalid) and the
    flow-warped views at the flow's four scales (from 1/4), against a
    target they partly resemble, so both errors spread over [0, 2]."""
    rng = np.random.RandomState(seed)
    target = rng.uniform(-1, 1, (batch, height, width, 3)).astype(np.float32)

    def views(scale):
        h, w = height // scale, width // scale
        small = target[:, ::scale, ::scale][:, None]
        out = small + rng.uniform(-0.8, 0.8, (batch, numsrc, h, w, 3))
        out = out.astype(np.float32)
        out[rng.rand(batch, numsrc, h, w) < 0.1] = 0.0
        return out

    synth_ms = [views(s) for s in (1, 2, 4, 8)]
    warped_ms = [views(s) for s in (4, 8, 16, 32)]
    return synth_ms, warped_ms, target


@pytest.mark.parametrize("method", ["L1", "SSIM"])
@pytest.mark.parametrize("weights", [SCALE_WEIGHT_T1, SCALE_WEIGHT_T2])
def test_combined_loss_matches_jax(method, weights):
    synth_ms, warped_ms, target = _pyramids(3)
    augm = {"synth_target_ms": synth_ms, "warped_target_ms": warped_ms, "target": target}
    ref = jtotal.CombinedLossMultiScale(method, weights)(
        None, None, jax.tree_util.tree_map(jnp.asarray, augm))
    t_augm = {k: ([torch.from_numpy(v) for v in vs] if isinstance(vs, list)
                  else torch.from_numpy(vs)) for k, vs in augm.items()}
    got = ttotal.CombinedLossMultiScale(method, weights)(None, None, t_augm)
    # both sides compute the same float32 resizes and errors of these
    # same arrays: they may differ by rounding, ~1e-7; pixels within 1e-5
    # of a tie may flip
    allowance, tie_share = _tie_allowance(method, t_augm, weights, 1e-5)
    assert tie_share < 1e-3, tie_share
    ref = np.asarray(ref)
    bound = 1e-6 * np.abs(ref) + allowance.numpy()
    assert np.all(np.abs(got.numpy() - ref) <= bound), (got.numpy(), ref, bound)
    assert np.all(ref > 0)


def test_combined_loss_masks_where_flow_explains_better():
    """A static error at or above the flow error counts 0; below, in full."""
    target = torch.zeros(1, 2, 2, 3)
    synth = torch.full((1, 1, 2, 2, 3), 0.5)
    warped = torch.full((1, 1, 2, 2, 3), 0.5)
    warped[0, 0, 0] = 0.75  # flow error 0.75 > static 0.5 in the first row
    loss = ttotal.CombinedLossMultiScale("L1", [1.0])(
        None, None, {"synth_target_ms": [synth], "warped_target_ms": [warped],
                     "target": target})
    torch.testing.assert_close(loss, torch.tensor([0.25]), rtol=0, atol=0)


def test_factory_builds_the_combined_losses():
    keys = ["image", "intrinsic"]
    total = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False)
    assert list(total.loss_weights.items()) == list(RECIPE.items())
    assert all(isinstance(total.loss_objects[k], ttotal.CombinedLossMultiScale)
               for k in ("cmbL1", "cmbSSIM"))
    ref = j_loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False)
    assert list(ref.loss_weights.items()) == list(total.loss_weights.items())


def _fill(shapes, seed):
    """A flax variable tree shaped like ``shapes``, filled from numpy:
    kernels of unit gain, biases of 0.05, random BN statistics and
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


@pytest.fixture(scope="module")
def joint_step():
    """The JAX joint train step (optimizer and step both freezing the
    flownet, as its trainer builds them) and the port's, on one batch
    from the same weights."""
    with full_f32():
        dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                                   num_batches=1, seed=3)
        keys = dataset.config_keys()
        batch = next(iter(dataset))
        batch["image5d"] = np.round((batch["image5d"] + 1.0) * 127.5).astype(np.uint8)

        jmodel = JModelFactory(keys, NETS, stereo=False).get_model()
        jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
        # the fill of test_torch_train.py (seed 5): some other fills make
        # this float32 step ill-conditioned on both packages alike (the
        # depth net's gradients then differ ~0.6% under the rigid recipe too)
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)),
                          5)
        state = TrainState.create(
            apply_fn=jmodel.apply, params=variables["params"],
            batch_stats=variables["batch_stats"],
            tx=j_optimizer_factory("adam_constant", LR, frozen_nets=["flownet"]))
        jloss = j_loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=BATCH)
        new_state, jmetrics = j_make_train_step(jmodel, jloss, frozen_nets=["flownet"])(
            state, jfeats, jax.random.PRNGKey(0))
        # Adam's first moment after one step is (1 - b1) * g, for the nets
        # that train; the frozen flownet's gradient is 0
        mu = new_state.opt_state.inner_states["train"].inner_state[0].mu
        jgrads = {net: jax.tree_util.tree_map(lambda m: np.asarray(m) / (1.0 - 0.9), mu[net])
                  for net in ("depthnet", "posenet")}
        jgrads["flownet"] = jax.tree_util.tree_map(np.zeros_like,
                                                   variables["params"]["flownet"])
        jnew = jax.tree_util.tree_map(np.asarray, {"params": new_state.params,
                                                   "batch_stats": new_state.batch_stats})

        model = ModelFactory(keys, NETS, stereo=False, device="cpu").get_model()
        load_flax_variables(model, variables)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        loss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=BATCH)
        optimizer = optimizer_factory("adam_constant", LR, model, frozen_nets=["flownet"])
        step = make_train_step(model, loss, optimizer, frozen_nets=["flownet"])
        feats = {k: torch.from_numpy(v) for k, v in batch.items()}
        metrics = step(feats)
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

        # the combined losses' inputs at the step's own train-mode forward
        # from the initial weights, in float32 and in float64
        augms = []
        for dtype in (torch.float32, torch.float64):
            check = ModelFactory(keys, NETS, stereo=False, device="cpu").get_model()
            load_flax_variables(check, variables)
            check.to(dtype)
            with torch.no_grad():
                tfeats = {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}
                tfeats["image5d"] = tfeats["image5d"] * (2.0 / 255.0) - 1.0
                augms.append(loss.append_data(tfeats, check.train()(tfeats)))
        augm, augm64 = augms
    return dict(model=model, before=before, metrics=metrics, grads=grads, augm=augm,
                augm64=augm64,
                jmetrics=jmetrics, jgrads=jgrads, jnew=jnew, variables=variables)


def test_joint_step_losses_match_jax(joint_step):
    metrics, jmetrics, augm = joint_step["metrics"], joint_step["jmetrics"], joint_step["augm"]
    assert set(metrics) == set(jmetrics)
    assert {"loss/cmbL1", "loss/cmbSSIM", "loss/smoothe"} <= set(metrics)
    # rtol 1e-5 (as test_torch_flow_train.py): float32 on both sides, the
    # same train-mode forward summed in another order; each pixel within
    # the measured float32 gap of a tie is allowed its share
    allowance = {}
    for name, method in (("cmbL1", "L1"), ("cmbSSIM", "SSIM")):
        per_sample, tie_share = _tie_allowance(method, augm, SCALE_WEIGHT_T1,
                                               augm64=joint_step["augm64"])
        assert tie_share < 1e-4, (name, tie_share)
        allowance[f"loss/{name}"] = float(per_sample.sum()) / BATCH
    allowance["loss"] = sum(RECIPE[k[5:]] * v for k, v in allowance.items())
    for key in ["loss"] + [f"loss/{k}" for k in RECIPE]:
        got, want = float(metrics[key]), float(jmetrics[key])
        bound = 1e-5 * abs(want) + 1e-7 + allowance.get(key, 0.0)
        assert abs(got - want) <= bound, (key, got, want, bound)
    for key in ("depth_abs_rel", "depth_center_mean", "trj_err", "rot_err"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_joint_step_gradients_match_jax(joint_step):
    model = joint_step["model"]
    ref = flax_params_to_torch(joint_step["jgrads"], model)
    trained = {n for n, _ in model.named_parameters() if not n.startswith("flownet.")}
    assert set(joint_step["grads"]) == trained
    for name, grad in joint_step["grads"].items():
        want = ref[name].numpy()
        err = float(np.linalg.norm(grad.numpy() - want))
        # rtol 1e-3 of the tensor's norm (as test_torch_flow_train.py and
        # test_torch_train.py): float32 through ~100 layers and train-mode
        # BatchNorm on 16 values per channel, summed in another order; atol
        # 1e-7 for the projection BNs' biases, whose gradient is 0 but for
        # float noise
        bound = 1e-3 * float(np.linalg.norm(want)) + 1e-7
        assert err <= bound, f"{name}: |diff| {err:.3g} > {bound:.3g}"


def test_joint_step_update_bn_stats_and_frozen_flownet_match_jax(joint_step):
    model, before = joint_step["model"], joint_step["before"]
    want = flax_to_state_dict(joint_step["jnew"], model)
    ref_grads = flax_params_to_torch(joint_step["jgrads"], model)
    eps, same_sign, total = 1e-8, 0, 0
    for key, value in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        got, ref = value.numpy(), want[key].numpy()
        if key.startswith("flownet."):
            # frozen on both sides: bit-unchanged
            np.testing.assert_array_equal(got, before[key].numpy(), err_msg=key)
            np.testing.assert_array_equal(ref, before[key].numpy(), err_msg=key)
            continue
        if key.endswith(("running_mean", "running_var")):
            # flax's biased-variance update, as test_torch_train.py holds it
            np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5, err_msg=key)
            continue
        if key not in joint_step["grads"]:  # the input normalization buffers
            np.testing.assert_array_equal(got, ref, err_msg=key)
            continue
        # Adam's first step, as test_torch_flow_train.py bounds it: updates
        # of one sign differ by lr * eps * |g - g'| / ((|g| + eps)(|g'| + eps))
        # plus the weight's float32 rounding (1e-7, or one ulp where the
        # weight is larger than 1, as BatchNorm scales are); every weight
        # within 2 lr
        rounding = np.maximum(1e-7, np.spacing(np.abs(ref)))
        assert np.all(np.abs(got - ref) <= 2 * LR + rounding), key
        g, rg = joint_step["grads"][key].numpy(), ref_grads[key].numpy()
        same = np.sign(g) == np.sign(rg)
        bound = LR * eps * np.abs(g - rg) / ((np.abs(g) + eps) * (np.abs(rg) + eps)) + rounding
        assert np.all(np.abs(got - ref)[same] <= bound[same]), key
        assert np.any(got != before[key].numpy()), f"{key} did not move"
        same_sign += int(same.sum())
        total += same.size
    assert same_sign >= 0.99 * total, (same_sign, total)
    assert all(p.requires_grad and p.grad is None for p in model.flownet.parameters())
