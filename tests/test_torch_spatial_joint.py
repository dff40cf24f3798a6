"""The port's joint step on the height-sharded ``("data", "spatial")`` mesh
(``xpt_mde_tpu_torch.parallel.spatial``) against the JAX package's.

Gloo ranks on the CPU (``tools/ddp_check.py``, spawned, meeting through a
``file://`` rendezvous in a temporary directory) each hold a band of the
image rows of their data index's samples. The model is the joint one at
the CPU's size: EfficientNetB0 + PoseNetImproved beside PWC-Net, the
flownet frozen (``frozen_nets=("flownet",)``, as the plan's joint rows
freeze it), at 64x128, batch 4, Adam 1e-4, from the same weights on both
sides (``convert.py``):

- on ``{"data": 1, "spatial": 2}``, under the cmb recipe ``{"cmbL1": 5,
  "cmbSSIM": 0.5, "smoothe": 20}`` and under its md2cmb form, held to the
  JAX package's single-device ``make_train_step`` and to its
  ``make_parallel_train_step`` on a ``{"data": 1, "spatial": 2}`` mesh
  over two of conftest's CPU devices, by ``tests/test_parallel.py``'s
  rules: the loss and each term within rtol 1e-4, each parameter within
  1e-4, the flownet bit-unchanged. Widened as ``test_torch_spatial.py``
  widens them, to float32's rounding of Adam's first +-lr move: a weight
  whose two gradients differ in sign (float32 noise) within 2 lr + 1e-6,
  at least 99% of the weights of one sign; each BatchNorm running
  statistic within 2e-5 (atol) + 1e-5 (rtol);
- the cmb mask (``static < flow``) and md2cmb's outlier test (``static >
  2 flow``) are hard comparisons, so a pixel whose two errors tie within
  float32's rounding may fall on either side in the two packages: as
  ``tests/test_torch_joint.py`` does, the near-tie pixels are found from
  a float64 forward of the same weights (each pixel's gap 4 times the sum
  of the float32 errors of the compared errors there), each is allowed
  its whole contribution to its term on top of the rtol, and they must be
  under 1e-4 of the pixels;
- the same cmb step on ``{"data": 2, "spatial": 2}`` over four ranks,
  against JAX's single-device step;
- the cmb step and the md2 recipe's rigid step on two bands against one
  process by ``ddp_check.within_tolerance(spatial=True, joint=True)``
  (``chip_smoke.py`` phase 30's float32 rule);
- the joint eval and predict steps on the mesh against one process (the
  losses within rtol 1e-5 and atol 1e-6; the depths, poses and flows come
  back whole, within 1e-5 of the largest value);
- a flow row, then a joint row that restores the flownet from the flow
  row's checkpoint and freezes it, of ``train_by_plan`` on the mesh
  against one process (each weight within 2 steps of 2 lr, each net's
  median within 1e-6, the flownet bit-equal to the flow row's), then
  ``predict_by_plan`` on the joint checkpoint (within 1e-4).

The cmb, md2 and md2cmb terms on their own, bands against the whole map,
are cases of ``tools/spatial_check.py``, which ``tests/test_torch_spatial.py``
runs.
"""

import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_joint import _error_maps, _tie_allowance
from test_torch_parallel import LR, _batch, jax_and_port_case
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.parallel import make_mesh as j_make_mesh
from xpt_mde_tpu.parallel import make_parallel_train_step as j_make_parallel_train_step
from xpt_mde_tpu.parallel import replicate_state as j_replicate_state
from xpt_mde_tpu.parallel import shard_batch as j_shard_batch
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.config import FLOW_NET, SCALE_WEIGHT_T1, Config, TrainStage
from xpt_mde_tpu_torch.config import TestStage as PlanTestStage
from xpt_mde_tpu_torch.convert import flax_params_to_torch, flax_to_state_dict
from xpt_mde_tpu_torch.evaluate.evaluate_main import predict_by_plan
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.parallel import make_mesh
from xpt_mde_tpu_torch.parallel.sharding import shard_batch
from xpt_mde_tpu_torch.tools import ddp_check
from xpt_mde_tpu_torch.training import make_eval_step, make_predict_step
from xpt_mde_tpu_torch.training.train_step import decode_image_features
from xpt_mde_tpu_torch.training.trainer import train_by_plan
from xpt_mde_tpu_torch.utils.precision import full_f32

SPATIAL = {"data": 1, "spatial": 2}
GRID = {"data": 2, "spatial": 2}
NETS = {"depth": "EfficientNetB0", "camera": "PoseNetImproved", "flow": "PWCNet"}
RECIPES = {"cmb": dict(ddp_check.JOINT_RECIPE), "md2cmb": dict(ddp_check.MD2CMB_RECIPE)}
# LOSS_RIGID_MD2 without the right views' terms
MD2_RECIPE = {"md2L1": 0.5, "md2SSIM": 0.5, "smoothe": 1.0}
FROZEN = {"frozen_nets": ("flownet",)}
LOSS_RTOL, PARAM_ATOL, STAT_ATOL = 1e-4, 1e-4, 2e-5
TIE_SHARE = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _plan_cfg(root, shape) -> Config:
    """A flow row, then a joint row (the flownet restored from the flow
    row's checkpoint and frozen), of 2 steps each (8 snippets, a global
    batch of 4) at 64x128, and the joint nets' test-split prediction. No
    row keeps an "ep{NN}" checkpoint beside its "latest" one (they would
    double the ~0.5 GB that each of the two plans writes)."""
    world = math.prod(shape.values())
    return Config(stereo=False, per_replica_batch=4 // world, mesh_shape=shape,
                  datapath=str(root), ckpt_name="spj", pretrained_weight=False,
                  compute_dtype="float32", loader_workers=1,
                  training_plan=[TrainStage(FLOW_NET, "synthetic", 1, 1e-4,
                                            dict(ddp_check.FLOW_RECIPE), SCALE_WEIGHT_T1,
                                            save_ckpt=False),
                                 TrainStage(NETS, "synthetic", 1, 1e-4, RECIPES["cmb"],
                                            SCALE_WEIGHT_T1, save_ckpt=False)],
                  test_plan=[PlanTestStage(NETS, "synthetic", ["depth", "pose"], "spj")])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model and weights (test_torch_parallel.py's fill) and the
    port's step cases, on test_torch_parallel.py's batch (synthetic,
    uint8, 64x128, batch 4)."""
    keys, batch = _batch()
    jmodel, variables, cmb = jax_and_port_case(keys, batch, NETS, RECIPES["cmb"],
                                               dict(FROZEN, mesh_shape=SPATIAL))
    roots = {}
    for name in ("one", "mesh"):
        roots[name] = tmp_path_factory.mktemp(f"joint_plan_{name}")
        chip_smoke.write_synthetic_shards(roots[name] / "shards", 64, 128,
                                          {"train": 8, "test": 4})
    return {"jmodel": jmodel, "variables": variables,
            "cases": {"cmb": cmb, "md2cmb": dataclasses.replace(cmb, recipe=RECIPES["md2cmb"])},
            "grid": dataclasses.replace(cmb, mesh_shape=GRID),
            "md2": dataclasses.replace(ddp_check.b0_case(), recipe=MD2_RECIPE,
                                       mesh_shape=SPATIAL),
            "roots": roots}


def _spawned(setup, two_dir, four_dir) -> dict:
    """Every two-rank check in one gloo group, then the four-rank step."""
    cases = setup["cases"]
    tasks = [(ddp_check.rank_steps, ([cases["cmb"], cases["md2cmb"], setup["md2"]],)),
             (ddp_check.rank_eval_predict, (cases["cmb"],)),
             (ddp_check.rank_spatial_plan, (_plan_cfg(setup["roots"]["mesh"], SPATIAL),))]
    two = ddp_check.run_ranks(ddp_check.rank_tasks, (tasks,), 2, "cpu", workdir=two_dir)
    four = ddp_check.ddp_steps([setup["grid"]], 4, "cpu", workdir=four_dir)[0]
    steps, eval_predict, plan = zip(*two)
    return {"cmb": [s[0] for s in steps], "md2cmb": [s[1] for s in steps],
            "md2": [s[2] for s in steps], "eval_predict": eval_predict, "plan": plan,
            "grid": four}


def _one_process(setup) -> dict:
    """The port's one-process references: the near-tie allowances, the cmb
    and md2 steps, and the plan (its root)."""
    out = {"ties": _tie_allowances(setup["cases"]["cmb"]),
           "single": {"cmb": ddp_check.single_step(setup["cases"]["cmb"]),
                      "md2": ddp_check.single_step(setup["md2"])}}
    cfg = _plan_cfg(setup["roots"]["one"], {"data": 1})
    train_by_plan(cfg, device="cpu")
    predict_by_plan(cfg, device="cpu")
    out["plan"] = setup["roots"]["one"]
    return out


@pytest.fixture(scope="module")
def references(setup, tmp_path_factory):
    """In a thread, the ranks' results (spawned processes) and then the
    port's one-process references; meanwhile in this thread JAX's steps
    (their compiles take most of the module's time)."""
    out = {}

    def spawn():
        try:
            out["ranks"] = _spawned(setup, tmp_path_factory.mktemp("jranks2"),
                                    tmp_path_factory.mktemp("jranks4"))
            out.update(_one_process(setup))
        except BaseException as exc:  # raised in the test's thread below
            out["error"] = exc

    waiter = threading.Thread(target=spawn)
    waiter.start()
    try:
        jmodel, variables = setup["jmodel"], setup["variables"]
        out["jax"] = {(name, side): _jax_step(jmodel, variables, case, shape)
                      for name, case in setup["cases"].items()
                      for side, shape in (("single", None), ("spatial", SPATIAL))}
    finally:
        waiter.join()
    if "error" in out:
        raise out["error"]
    return out


@pytest.fixture(scope="module")
def ranks(references):
    return references["ranks"]


def _jax_step(jmodel, variables, case, shape=None):
    """JAX's joint step of ``case`` (optimizer and step both freezing the
    flownet, as its trainer builds them): on one device, or over a mesh of
    ``shape`` on the first of conftest's CPU devices. (metrics, gradients
    of the trained nets from Adam's first moment, new variables)."""
    frozen = list(case.frozen_nets)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=j_optimizer_factory("adam_constant", LR, frozen_nets=frozen))
    loss = j_loss_factory(case.keys, case.recipe, SCALE_WEIGHT_T1, stereo=False,
                          batch_size=case.global_batch)
    feats = {k: jnp.asarray(v) for k, v in case.batch.items()}
    if shape is None:
        new, metrics = j_make_train_step(jmodel, loss, frozen_nets=frozen)(
            state, feats, jax.random.PRNGKey(0))
    else:
        mesh = j_make_mesh(shape, devices=jax.devices()[:math.prod(shape.values())])
        sharded = j_shard_batch(feats, mesh)
        assert sharded["image5d"].sharding.spec == ("data", None, "spatial")
        new, metrics = j_make_parallel_train_step(jmodel, loss, mesh, frozen_nets=frozen)(
            j_replicate_state(state, mesh), sharded, jax.random.PRNGKey(0))
    mu = new.opt_state.inner_states["train"].inner_state[0].mu
    grads = {net: jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, mu[net])
             for net in mu if net not in frozen}
    for net in frozen:
        grads[net] = jax.tree_util.tree_map(np.zeros_like, variables["params"][net])
    return ({k: float(v) for k, v in metrics.items()}, grads,
            jax.tree_util.tree_map(np.asarray, {"params": new.params,
                                                "batch_stats": new.batch_stats}))


def _md2cmb_tie_allowance(method, augm, augm64, scale_weights):
    """md2cmb's counterpart of ``_tie_allowance``: a source's pixel whose
    static error lies within its gap of twice the flow error may flip its
    outlier mark, which moves that pixel's minimum over the sources by at
    most its largest static error and the batch-global kept count by one
    (every sample's term then by its share of one count). The per-sample
    bound ([batch]) and the share of such pixels."""
    flow, statics = _error_maps(method, augm)
    flow64, statics64 = _error_maps(method, augm64)
    flow_err = (flow.double() - flow64).abs()
    allowance, ties, total = 0.0, 0, 0
    for weight, static, static64 in zip(scale_weights, statics, statics64):
        gap = 4 * (2 * flow_err + (static.double() - static64).abs())
        near = ((static - 2 * flow).abs() <= gap) & (static > 0)  # [B, N, H, W, C]
        mins = torch.amin(static + (static > 2 * flow).to(static.dtype) * 1000.0, dim=1)
        keep = (mins < 1000.0).to(static.dtype)
        count = float(keep.sum())
        term = torch.sum(mins * keep, dim=(1, 2, 3)) / count
        flips = near.any(dim=1)
        moved = torch.sum(torch.amax(static, dim=1) * flips, dim=(1, 2, 3)) / (count - 1)
        allowance = allowance + weight * (moved + term * float(flips.sum()) / (count - 1))
        ties += int(near.sum())
        total += near.numel()
    return allowance, ties / total


def _tie_allowances(case) -> dict:
    """{recipe: {metric: the most its value can move where the near-tie
    pixels flip}} for each joint recipe at ``case``'s weights and batch,
    from the port's float32 and float64 train-mode forwards (the same
    inputs the step's loss sees)."""
    augms = []
    with full_f32(), torch.no_grad():
        for dtype in (torch.float32, torch.float64):
            model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()
            model.load_state_dict(case.state)
            model.to(dtype).train()
            feats = decode_image_features({k: torch.from_numpy(v) for k, v in case.batch.items()})
            feats = {k: v.to(dtype) for k, v in feats.items()}
            loss = loss_factory(case.keys, RECIPES["cmb"], SCALE_WEIGHT_T1, stereo=False,
                                batch_size=case.global_batch)
            augms.append(loss.append_data(feats, model(feats)))
    out = {}
    for name, recipe in RECIPES.items():
        allowance = {}
        for term in (k for k in recipe if k != "smoothe"):
            method = "SSIM" if term.endswith("SSIM") else "L1"
            if name == "cmb":
                per_sample, share = _tie_allowance(method, augms[0], SCALE_WEIGHT_T1,
                                                   augm64=augms[1])
            else:
                per_sample, share = _md2cmb_tie_allowance(method, *augms, SCALE_WEIGHT_T1)
            assert share < TIE_SHARE, (term, share)
            allowance[f"loss/{term}"] = float(per_sample.sum()) / case.global_batch
        allowance["loss"] = sum(recipe[k[5:]] * v for k, v in allowance.items())
        out[name] = allowance
    return out


def hold_joint_to_jax(ranks, jax_result, case, allowance) -> None:
    """The ranks' joint step against one JAX step, by the module's rules."""
    jmetrics, jgrads, jnew = jax_result
    first = ranks[0]
    for other in ranks[1:]:
        assert other["metrics"] == first["metrics"]
        for key, value in first["state"].items():
            assert torch.equal(other["state"][key], value), key
    for key in ["loss"] + [f"loss/{k}" for k in case.recipe]:
        got, want = first["metrics"][key], jmetrics[key]
        assert abs(got - want) <= LOSS_RTOL * abs(want) + allowance.get(key, 0.0), (key, got,
                                                                                    want)
    model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()
    ref = flax_params_to_torch(jgrads, model)
    want_state = flax_to_state_dict(jnew, model)
    trained = {n for n, _ in model.named_parameters() if not n.startswith("flownet.")}
    assert set(first["grads"]) == trained
    same_sign = total = 0
    for key, value in first["state"].items():
        if key.endswith("num_batches_tracked"):
            continue
        got, ref_value = value.numpy(), want_state[key].numpy()
        if key.startswith("flownet."):  # frozen on every rank and in JAX: bit-unchanged
            for rank in ranks:
                assert torch.equal(rank["state"][key], case.state[key]), key
            np.testing.assert_array_equal(ref_value, case.state[key].numpy(), err_msg=key)
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, ref_value, atol=STAT_ATOL, rtol=1e-5, err_msg=key)
            continue
        if key not in first["grads"]:  # the input normalization buffers
            np.testing.assert_array_equal(got, ref_value, err_msg=key)
            continue
        same = np.sign(first["grads"][key].numpy()) == np.sign(ref[key].numpy())
        assert np.all(np.abs(got - ref_value)[same] <= PARAM_ATOL), key
        assert np.all(np.abs(got - ref_value) <= 2 * LR + 1e-6), key
        same_sign += int(same.sum())
        total += same.size
    assert same_sign >= 0.99 * total, (same_sign, total)


@pytest.mark.parametrize("jax_side", ["single", "spatial"])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_two_band_joint_step_matches_jax(recipe, jax_side, setup, ranks, references):
    """The joint step on ``{"data": 1, "spatial": 2}`` against JAX's
    single-device step and its step on a ``{"data": 1, "spatial": 2}``
    mesh; both ranks moved halos, gathered maps (for the full-resolution
    terms' resizes too) and summed means."""
    case = setup["cases"][recipe]
    hold_joint_to_jax(ranks[recipe], references["jax"][(recipe, jax_side)], case,
                      references["ties"][recipe])
    for rank in ranks[recipe]:
        band = rank["band"]
        assert band["halo_bytes"] > 0 and band["gather_bytes"] > 0 and band["sum_bytes"] > 0
        assert band["resize_bytes"] > 0  # the full-resolution terms' resizes


def test_two_by_two_joint_mesh_matches_jax(setup, ranks, references):
    """Four ranks on ``{"data": 2, "spatial": 2}``: two samples a data
    index, each in two bands, md2cmb's count and BatchNorm's statistics
    over the whole mesh."""
    hold_joint_to_jax(ranks["grid"], references["jax"][("cmb", "single")], setup["grid"],
                      references["ties"]["cmb"])


@pytest.mark.parametrize("name", ["cmb", "md2"])
def test_two_band_step_within_the_one_process_rule(name, ranks, references):
    """The cmb step and the md2 recipe's rigid step on two bands against
    the port's one-process step by ddp_check's spatial rule (the joint
    one for the cmb terms' near-ties): the rule ``chip_smoke.py`` phase 30
    holds the card's two-band steps to."""
    distances = ddp_check.compare(references["single"][name], ranks[name])
    assert ddp_check.within_tolerance(distances, spatial=True, joint=name == "cmb"), distances
    assert distances["frozen"] == 0.0


def test_joint_eval_and_predict_on_the_mesh_match_one_process(setup, ranks):
    """The eval metrics and the predictions of the two-band steps against
    one process's: the depths, the poses and the flows come back whole, the
    same on both ranks."""
    case = setup["cases"]["cmb"]
    model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()
    model.load_state_dict(case.state)
    loss = ddp_check._build(case, torch.device("cpu"))[1]
    feats = shard_batch(case.batch, make_mesh(device="cpu"))
    metrics = make_eval_step(model, loss)(feats)
    preds = make_predict_step(model)(feats)
    for rank in ranks["eval_predict"]:
        assert set(rank["metrics"]) == set(metrics)
        for key, value in metrics.items():
            np.testing.assert_allclose(rank["metrics"][key], float(value), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        for key in ("depth_ms", "flow_ms"):
            assert len(rank["preds"][key]) == len(preds[key]) == 4, key
            for got, want in zip(rank["preds"][key], preds[key]):
                assert got.shape == tuple(want.shape), key
                np.testing.assert_allclose(got, want.numpy(), rtol=1e-5,
                                           atol=1e-5 * float(want.abs().max()), err_msg=key)
        np.testing.assert_allclose(rank["preds"]["pose"], preds["pose"].numpy(), rtol=1e-5,
                                   atol=1e-6)
    first, second = ranks["eval_predict"]
    for key in ("depth_ms", "flow_ms"):
        assert all(np.array_equal(a, b) for a, b in zip(first["preds"][key],
                                                        second["preds"][key])), key


def test_flow_then_joint_plan_rows_on_the_mesh_match_one_process(setup, ranks, references):
    """A flow row, then a joint row, of 2 steps each on ``{"data": 1,
    "spatial": 2}``: both ranks end each row with one state, rank 0 alone
    writes, the joint row kept the flow row's flownet bit for bit, its
    checkpoints match one process's, and so does ``predict_by_plan``'s npz
    on the mesh."""
    plan = ranks["plan"]
    assert plan[0]["writes"] == [{"snapshot_config": 1, "save": 2, "save_log": 2}]
    assert plan[1]["writes"] == [{}]
    for row in range(2):
        for key, value in plan[0]["states"][row].items():
            assert torch.equal(plan[1]["states"][row][key], value), (row, key)
    for key, value in plan[0]["states"][0].items():  # the flow row's flownet
        assert torch.equal(plan[0]["states"][1][key], value), key
    one = references["plan"] / "checkpts" / "spj"
    mesh = setup["roots"]["mesh"] / "checkpts" / "spj"
    for name in ("flownet_latest.pt", "depthnet_latest.pt", "posenet_latest.pt"):
        a = torch.load(one / name, map_location="cpu", weights_only=True)
        b = torch.load(mesh / name, map_location="cpu", weights_only=True)
        assert a.keys() == b.keys(), name
        # Adam moves a weight by at most lr a step, whatever a noise-level
        # gradient's sign; most of a net's weights agree to rounding (not
        # each tensor's: the projection BatchNorms' biases have gradients
        # of float noise, whose sign moves them by +-lr either way)
        diffs = [(b[key] - value).abs().reshape(-1) for key, value in a.items()]
        for key, diff in zip(a, diffs):
            assert float(diff.max()) <= 2 * 2 * 1e-4 + 1e-6, (name, key)
        assert float(torch.cat(diffs).median()) <= 1e-6, name
    got = dict(np.load(setup["roots"]["mesh"] / "prediction" / "spj" / "synthetic_latest.npz"))
    want = dict(np.load(references["plan"] / "prediction" / "spj" / "synthetic_latest.npz"))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-4, err_msg=key)
