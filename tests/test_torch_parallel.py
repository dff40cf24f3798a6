"""The port's data-parallel step (``xpt_mde_tpu_torch.parallel``) against
the JAX package's step on the same global batch.

Two gloo ranks on the CPU (``tools/ddp_check.py``, spawned, meeting through
a ``file://`` rendezvous in ``tmp_path``) each take their rows of a global
batch of 4 (EfficientNetB0 + PoseNetImproved at 64x128, so train-mode
BatchNorm is in play) and run one step of ``make_parallel_train_step``. The
result is held to ``xpt_mde_tpu.training.train_step.make_train_step`` on
the whole batch, from the same weights (``convert.py``), with JAX's own
tolerances (``tests/test_parallel.py``: the loss within rtol 1e-4, the
parameters within 1e-4), each BatchNorm running statistic within 2e-5 of
flax's ``batch_stats`` (``test_torch_train_step.py``'s tolerance), and the
gradients by ``test_torch_zoo_step.py``'s float64 rule. Cases: the rigid recipe and ``grad_accum_steps=2``
against JAX's ``lax.scan`` step (the joint md2cmb recipe is
``test_torch_parallel_joint.py``'s, which shares these helpers). A third case
augments, which JAX draws from another stream: every rank must draw what
the single-process step draws, and the two-rank step must equal it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _fill
from xpt_mde_tpu.config import SCALE_WEIGHT_T1
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.config import AUGMENT_PROBS
from xpt_mde_tpu_torch.convert import (flax_params_to_torch, flax_to_state_dict,
                                       load_flax_variables)
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.data.shard_io import _microbatch_share
from xpt_mde_tpu_torch.parallel import (is_main_process, local_view, make_mesh,
                                        make_multihost_mesh, process_count, process_index,
                                        rank_rows)
from xpt_mde_tpu_torch.tools import ddp_check
from xpt_mde_tpu_torch.utils.precision import full_f32

BATCH, HEIGHT, WIDTH, LR, WORLD = 4, 64, 128, 1e-4, 2
GRAD_RATIO = 1.5  # chip_smoke.GRAD_MEDIAN_RATIO
NETS_B0 = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
RIGID = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
CASES = {  # name: (nets, recipe, step options); the joint case has a file of its own
    "rigid": (NETS_B0, RIGID, {}),
    "grad_accum_steps=2": (NETS_B0, RIGID, {"grad_accum_steps": 2}),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch():
    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH, num_batches=1,
                               seed=3)
    batch = next(iter(dataset))
    batch["image5d"] = np.round((batch["image5d"] + 1.0) * 127.5).astype(np.uint8)
    return dataset.config_keys(), batch


def jax_and_port_case(keys, batch, nets, recipe, options):
    """The flax variables (test_torch_train.py's fill, seed 5), the JAX
    model and the port's StepCase carrying the same weights."""
    jmodel = JModelFactory(keys, nets, stereo=False).get_model()
    jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)), 5)
    model = ModelFactory(keys, nets, stereo=False, device="cpu").get_model()
    load_flax_variables(model, variables)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    return jmodel, variables, ddp_check.StepCase(nets, keys, recipe, batch, state=state, lr=LR,
                                                 **options)


@pytest.fixture(scope="module")
def setup():
    keys, batch = _batch()
    out = {name: jax_and_port_case(keys, batch, *spec) for name, spec in CASES.items()}
    # the augmenting case: the rigid weights, every augmentation drawn
    out["augment"] = (None, None, ddp_check.StepCase(
        NETS_B0, keys, RIGID, batch, state=out["rigid"][2].state, lr=LR,
        augment_probs=dict(AUGMENT_PROBS, CropAndResize=1.0, HorizontalFlip=1.0,
                           ColorJitter=1.0), generator_seed=11))
    return out


def run_two_ranks(cases: dict, workdir) -> dict:
    """Every case's two-rank step, in one gloo group: {case: [rank 0, rank 1]}."""
    results = ddp_check.ddp_steps(list(cases.values()), WORLD, "cpu", workdir=workdir)
    return dict(zip(cases, results))


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    return run_two_ranks({n: c for n, (_, _, c) in setup.items()},
                         tmp_path_factory.mktemp("ddp"))


def grads_by_float64(grads, ref, grads64) -> None:
    """test_torch_zoo_step.py's float64 rule: each gradient's distance
    from the port's float64 step (relative to its norm), the median and
    the largest at most GRAD_RATIO times ``ref``'s; ``ref``'s median below
    1e-2."""
    port, other = [], []
    for key, exact in grads64.items():
        norm = float(exact.norm())
        if norm > 1e-6:
            port.append(float((grads[key].double() - exact).norm()) / norm)
            other.append(float((ref[key].double() - exact).norm()) / norm)
    assert np.median(other) <= 1e-2, np.median(other)
    assert np.median(port) <= GRAD_RATIO * np.median(other), (np.median(port), np.median(other))
    assert max(port) <= GRAD_RATIO * max(other), (max(port), max(other))


def _jax_step(jmodel, variables, case):
    """JAX's step on the whole global batch: (metrics, gradients, new
    variables), the gradients from Adam's first moment (1 - b1) g."""
    frozen = list(case.frozen_nets)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=j_optimizer_factory("adam_constant", LR, frozen_nets=frozen))
    jloss = j_loss_factory(case.keys, case.recipe, SCALE_WEIGHT_T1, stereo=False,
                           batch_size=BATCH)
    with full_f32():
        new_state, metrics = j_make_train_step(
            jmodel, jloss, frozen_nets=frozen, grad_accum_steps=case.grad_accum_steps)(
            state, {k: jnp.asarray(v) for k, v in case.batch.items()}, jax.random.PRNGKey(0))
    if frozen:
        mu = new_state.opt_state.inner_states["train"].inner_state[0].mu
        grads = {net: jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu[net])
                 for net in mu if net not in frozen}
        for net in frozen:
            grads[net] = jax.tree_util.tree_map(np.zeros_like, variables["params"][net])
    else:
        grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                       new_state.opt_state[0].mu)
    new = jax.tree_util.tree_map(np.asarray, {"params": new_state.params,
                                              "batch_stats": new_state.batch_stats})
    return metrics, grads, new


def check_against_jax(jmodel, variables, case, ranks) -> None:
    """The two-rank step ``ranks`` against JAX's step of ``case``."""
    jmetrics, jgrads, jnew = _jax_step(jmodel, variables, case)
    first = ranks[0]
    model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()

    # every rank holds the same state and logs the same metrics
    for other in ranks[1:]:
        assert other["metrics"] == first["metrics"]
        for key, value in first["state"].items():
            assert torch.equal(other["state"][key], value), key

    # the loss and its terms: JAX's own rtol 1e-4 (tests/test_parallel.py)
    assert set(first["metrics"]) == set(jmetrics)
    for key in ["loss"] + [f"loss/{k}" for k in case.recipe]:
        np.testing.assert_allclose(first["metrics"][key], float(jmetrics[key]), rtol=1e-4,
                                   err_msg=key)
    for key in ("depth_abs_rel", "depth_center_mean", "trj_err", "rot_err"):
        np.testing.assert_allclose(first["metrics"][key], float(jmetrics[key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)

    # the gradients (summed over the ranks) by the float64 rule of
    # test_torch_zoo_step.py: on this batch of 4 either package's float32
    # step sits ~7e-3 (median) from the float64 step, and the one-process
    # port ~3e-3 from JAX, so each gradient's distance from the port's
    # float64 step is held to JAX's: the median and the largest at most
    # GRAD_RATIO times JAX's
    ref = flax_params_to_torch(jgrads, model)
    trained = {n for n, _ in model.named_parameters()
               if n.split(".")[0] not in case.frozen_nets}
    assert set(first["grads"]) == trained
    grads_by_float64(first["grads"], ref,
                     ddp_check.single_step(case, dtype=torch.float64)["grads"])

    want = flax_to_state_dict(jnew, model)
    before = case.state
    moved = same_sign = total = 0
    for key, value in first["state"].items():
        if key.endswith("num_batches_tracked"):
            continue
        got, ref_value = value.numpy(), want[key].numpy()
        if key.endswith(("running_mean", "running_var")):
            # flax's batch_stats: the global batch's statistics (one rank's
            # rows' would miss by their sampling spread, ~1e-3 here)
            np.testing.assert_allclose(got, ref_value, atol=2e-5, rtol=1e-5, err_msg=key)
            continue
        if key not in first["grads"]:  # frozen nets, input normalization buffers
            np.testing.assert_array_equal(got, before[key].numpy(), err_msg=key)
            np.testing.assert_array_equal(ref_value, before[key].numpy(), err_msg=key)
            continue
        # JAX's 1e-4 on every weight whose gradient has one sign on both
        # sides (the two updates then differ by ~lr 1e-8 / |g|); a gradient
        # element that is float32 noise may have either sign, and Adam's
        # first step moves its weight by +-lr, so those within 2 lr, and
        # they are at most 1% of the weights
        g, rg = first["grads"][key].numpy(), ref[key].numpy()
        same = np.sign(g) == np.sign(rg)
        assert np.all(np.abs(got - ref_value)[same] <= 1e-4), key
        assert np.all(np.abs(got - ref_value) <= 2 * LR + 1e-6), key
        same_sign += int(same.sum())
        total += same.size
        moved += int(np.any(got != before[key].numpy()))
    assert same_sign >= 0.99 * total, (same_sign, total)
    assert moved == len(trained)


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_jax_step(name, setup, two_ranks):
    check_against_jax(*setup[name], two_ranks[name])


def test_every_rank_draws_the_single_step_augmentation(setup, two_ranks):
    """JAX draws one box, flip and jitter per global batch; every rank
    seeds its generator from the same (epoch, step), so each draws what
    the single-process step draws, and the two-rank step equals that
    step: the loss within 1e-5 and the running statistics within 2e-5
    (the same sums, grouped by rank), the gradients within float32
    rounding."""
    case = setup["augment"][2]
    single = ddp_check.single_step(case)
    ranks = two_ranks["augment"]
    assert [name for name, _ in single["draws"]] == ["CropAndResize", "HorizontalFlip",
                                                     "ColorJitter"]
    assert single["draws"][1][1] is True and single["draws"][2][1][0] is True
    distances = ddp_check.compare(single, ranks)
    assert distances["draws_equal"] and distances["replicas"] == 0.0
    assert distances["metrics_equal_across_ranks"] and distances["grad_keys_equal"]
    assert distances["loss"] <= 1e-5, distances
    assert distances["stat"] <= 2e-5, distances
    # the gradients: a rank that augmented otherwise would hold other
    # images, O(1) off; here they sit within float32 rounding of the single
    # step's, whose own median distance from a float64 step of the same
    # augmented batch is ~1e-3 (largest ~2e-3, varying with the thread count)
    assert distances["grad_median"] <= 1e-3, distances
    assert distances["grad"] <= 1e-2, distances


def test_rank_rows_give_each_rank_its_share_of_every_microbatch():
    assert rank_rows(8, 2, 0).tolist() == [0, 1, 2, 3]
    assert rank_rows(8, 2, 1).tolist() == [4, 5, 6, 7]
    # k = 2: global microbatches [0..3] and [4..7], each rank two rows of each
    assert rank_rows(8, 2, 0, 2).tolist() == [0, 1, 4, 5]
    assert rank_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]
    rows = np.concatenate([rank_rows(12, 3, r, 2) for r in range(3)])
    assert sorted(rows.tolist()) == list(range(12))
    with pytest.raises(ValueError, match="divide"):
        rank_rows(6, 2, 0, 2)


def test_make_mesh_shapes():
    mesh = make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    assert make_mesh({"data": 1, "spatial": 1}, device="cpu").world_size == 1
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"data": 2}, device="cpu")
    # the spatial axis is ported (test_torch_spatial.py): its product must
    # still match the ranks; a model axis is not ported
    with pytest.raises(ValueError, match="needs 8 devices, have 1"):
        make_mesh({"data": 4, "spatial": 2}, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        make_mesh({"data": 1, "model": 2}, device="cpu")


def test_loaders_give_each_rank_its_share_of_every_microbatch():
    """Two ranks of 2 rows with grad_accum_steps=2 on the order 0..15: the
    ranks' strided slices side by side make the global batches [0, 2, 1,
    3], [4, 6, 5, 7], ...; its microbatches [0, 2] and [1, 3]; rank 0 holds
    rows 0 of each, rank 1 rows 1, so each rank's i-th microbatch is its
    share of the global i-th. Without microbatches each rank keeps its
    strided slice."""
    order = np.arange(16)
    rank0, rank1 = (_microbatch_share(order, r, 2, 2, 2) for r in (0, 1))
    assert rank0.tolist() == [0, 1, 4, 5, 8, 9, 12, 13]
    assert rank1.tolist() == [2, 3, 6, 7, 10, 11, 14, 15]
    for step in range(4):
        glob = np.concatenate([order[0::2][2 * step: 2 * step + 2],
                               order[1::2][2 * step: 2 * step + 2]])
        for rank, rows in ((0, rank0), (1, rank1)):
            assert rows[2 * step: 2 * step + 2].tolist() == \
                glob[rank_rows(4, 2, rank, 2)].tolist()


def test_outside_a_group_the_process_is_rank_zero_of_one():
    assert (process_index(), process_count(), is_main_process()) == (0, 1, True)
    x = torch.arange(6.0).reshape(3, 2)
    assert np.array_equal(local_view(x), x.numpy())
    assert make_multihost_mesh(device="cpu").world_size == 1
