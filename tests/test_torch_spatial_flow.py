"""The port's flow stage on the height-sharded ``("data", "spatial")`` mesh
(``xpt_mde_tpu_torch.parallel.spatial``) against the JAX package's.

Gloo ranks on the CPU (``tools/ddp_check.py``, spawned, meeting through a
``file://`` rendezvous in a temporary directory) each hold a band of the
image rows of their data index's samples:

- PWC-Net alone at the JAX test's 64x128 (``tests/test_parallel.py``,
  ``test_flow_parallel_on_2d_mesh_matches_single_device``), batch 4, the
  flow stage's recipe ``{"flowL2": 1, "flow_reg": 4e-7}`` at
  ``SCALE_WEIGHT_T1``, ``regularize_net="flownet"``, Adam 1e-4, on
  ``{"data": 1, "spatial": 2}``, held to JAX's single-device
  ``make_train_step`` and to its ``make_parallel_train_step`` on a
  ``{"data": 1, "spatial": 2}`` mesh over two of conftest's CPU devices,
  from the same weights (``convert.py``), by the JAX test's rules: the
  loss within rtol 1e-4, each term within rtol 1e-3 and atol 1e-6, every
  parameter within 2.5e-4;
- the same step on ``{"data": 2, "spatial": 2}`` over four ranks;
- the flow eval and predict steps on the mesh against one process (the
  flows come back whole), a flow row of ``train_by_plan`` on the mesh
  against one process, and ``flow_reg``'s gradient on two ranks against
  one process's;
- the plain twins of K2, K3 and K4 on a band of rows (``row_offset``)
  against the whole frame's rows, on both of ``spatial.correlation_rows``'
  routes.

The flow stage's band modules (the transposed conv, the dilated convs,
the cost volume on both routes, the feature warp, the flow coordinates,
flowL2 and flow_reg) are cases of ``tools/spatial_check.py``, which
``tests/test_torch_spatial.py`` runs.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_parallel import LR, jax_and_port_case
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.parallel import make_mesh as j_make_mesh
from xpt_mde_tpu.parallel import make_parallel_train_step as j_make_parallel_train_step
from xpt_mde_tpu.parallel import replicate_state as j_replicate_state
from xpt_mde_tpu.parallel import shard_batch as j_shard_batch
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.config import FLOW_NET, SCALE_WEIGHT_T1, Config, TrainStage
from xpt_mde_tpu_torch.convert import flax_to_state_dict
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.ops.correlation import (correlation_cost_plain,
                                               correlation_grad_cl_plain,
                                               correlation_grad_cr_plain)
from xpt_mde_tpu_torch.parallel import make_mesh
from xpt_mde_tpu_torch.parallel.sharding import shard_batch
from xpt_mde_tpu_torch.tools import ddp_check
from xpt_mde_tpu_torch.training import make_eval_step, make_predict_step
from xpt_mde_tpu_torch.training.trainer import train_by_plan

import chip_smoke

SPATIAL = {"data": 1, "spatial": 2}
GRID = {"data": 2, "spatial": 2}
RECIPE = dict(ddp_check.FLOW_RECIPE)
FLOW = {"regularize_net": "flownet"}
# tests/test_parallel.py's flow rules
LOSS_RTOL, TERM_RTOL, TERM_ATOL, PARAM_ATOL = 1e-4, 1e-3, 1e-6, 2.5e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _plan_cfg(root, shape) -> Config:
    """One flow row of 2 steps (8 snippets, a global batch of 4) at 64x128
    (PWC-Net's six levels need a frame of 64 rows)."""
    world = math.prod(shape.values())
    return Config(stereo=False, per_replica_batch=4 // world, mesh_shape=shape,
                  datapath=str(root), ckpt_name="spf", pretrained_weight=False,
                  compute_dtype="float32", loader_workers=1,
                  training_plan=[TrainStage(FLOW_NET, "synthetic", 1, 1e-4, RECIPE,
                                            SCALE_WEIGHT_T1)], test_plan=[])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX model and weights and the port's step cases, from
    ``ddp_check.flow_case``'s batch (synthetic, uint8, 64x128, batch 4)."""
    base = ddp_check.flow_case()
    flow = jax_and_port_case(base.keys, base.batch, FLOW_NET, RECIPE,
                             dict(FLOW, mesh_shape=SPATIAL))
    case = flow[2]
    roots = {}
    for name in ("one", "mesh"):
        roots[name] = tmp_path_factory.mktemp(f"flow_plan_{name}")
        chip_smoke.write_synthetic_shards(roots[name] / "shards", 64, 128, {"train": 8})
    return {"flow": flow,
            "grid": ddp_check.StepCase(FLOW_NET, case.keys, RECIPE, case.batch, state=case.state,
                                       lr=LR, mesh_shape=GRID, **FLOW),
            # the regularizer alone: its gradient, which every rank's weights share
            "reg": ddp_check.StepCase(FLOW_NET, case.keys, {"flow_reg": 1.0}, case.batch,
                                      state=case.state, lr=LR, mesh_shape=SPATIAL, **FLOW),
            "roots": roots}


def _spawned(setup, two_dir, four_dir) -> dict:
    """Every two-rank check in one gloo group, then the four-rank step."""
    tasks = [(ddp_check.rank_steps, ([setup["flow"][2], setup["reg"]],)),
             (ddp_check.rank_eval_predict, (setup["flow"][2],)),
             (ddp_check.rank_spatial_plan, (_plan_cfg(setup["roots"]["mesh"], SPATIAL),))]
    two = ddp_check.run_ranks(ddp_check.rank_tasks, (tasks,), 2, "cpu", workdir=two_dir)
    four = ddp_check.ddp_steps([setup["grid"]], 4, "cpu", workdir=four_dir)[0]
    steps, eval_predict, plan = zip(*two)
    return {"flow": [s[0] for s in steps], "reg": [s[1] for s in steps],
            "eval_predict": eval_predict, "plan": plan, "grid": four}


@pytest.fixture(scope="module")
def references(setup, tmp_path_factory):
    """The ranks' results (spawned processes, waited for in a thread) and,
    meanwhile in this process, the references: JAX's steps, the port's
    one-process regularizer step and its one-process plan."""
    out = {}

    def spawn():
        try:
            out["ranks"] = _spawned(setup, tmp_path_factory.mktemp("franks2"),
                                    tmp_path_factory.mktemp("franks4"))
        except BaseException as exc:  # raised in the test's thread below
            out["error"] = exc

    waiter = threading.Thread(target=spawn)
    waiter.start()
    try:
        jmodel, variables, case = setup["flow"]
        out["jax"] = {"single": _jax_step(jmodel, variables, case),
                      "spatial": _jax_step(jmodel, variables, case, SPATIAL)}
        out["reg"] = ddp_check.single_step(setup["reg"])
        cfg = _plan_cfg(setup["roots"]["one"], {"data": 1})
        train_by_plan(cfg, device="cpu")
        out["plan"] = setup["roots"]["one"]
    finally:
        waiter.join()
    if "error" in out:
        raise out["error"]
    return out


def _jax_step(jmodel, variables, case, shape=None):
    """JAX's flow step of ``case`` (``regularize_net="flownet"``): on one
    device, or over a mesh of ``shape`` on the first of conftest's CPU
    devices. (metrics, new variables)."""
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              tx=j_optimizer_factory("adam_constant", LR))
    loss = j_loss_factory(case.keys, case.recipe, SCALE_WEIGHT_T1, stereo=False,
                          batch_size=case.global_batch)
    feats = {k: jnp.asarray(v) for k, v in case.batch.items()}
    if shape is None:
        new, metrics = j_make_train_step(jmodel, loss, regularize_net="flownet")(
            state, feats, jax.random.PRNGKey(0))
    else:
        mesh = j_make_mesh(shape, devices=jax.devices()[:math.prod(shape.values())])
        sharded = j_shard_batch(feats, mesh)
        assert sharded["image5d"].sharding.spec == ("data", None, "spatial")
        new, metrics = j_make_parallel_train_step(jmodel, loss, mesh, regularize_net="flownet")(
            j_replicate_state(state, mesh), sharded, jax.random.PRNGKey(0))
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, {"params": new.params}))


@pytest.fixture(scope="module")
def ranks(references):
    return references["ranks"]


def hold_flow_to_jax(ranks, jax_result, case) -> None:
    """The ranks' step against one JAX step: replicas equal; the loss
    within rtol 1e-4, each term within rtol 1e-3 and atol 1e-6, every
    parameter within 2.5e-4 (Adam's first step moves a weight by +-lr, and
    the sums' order can flip a noise-level gradient's sign:
    tests/test_parallel.py's rules)."""
    jmetrics, jnew = jax_result
    first = ranks[0]
    for other in ranks[1:]:
        assert other["metrics"] == first["metrics"]
        for key, value in first["state"].items():
            assert torch.equal(other["state"][key], value), key
    np.testing.assert_allclose(first["metrics"]["loss"], jmetrics["loss"], rtol=LOSS_RTOL)
    for key in [f"loss/{k}" for k in case.recipe]:
        np.testing.assert_allclose(first["metrics"][key], jmetrics[key], rtol=TERM_RTOL,
                                   atol=TERM_ATOL, err_msg=key)
    model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()
    want = flax_to_state_dict(jnew, model)
    for key, value in first["state"].items():
        diff = float(np.abs(value.numpy() - want[key].numpy()).max())
        assert diff < PARAM_ATOL, (key, diff)


@pytest.mark.parametrize("jax_side", ["single", "spatial"])
def test_two_band_flow_step_matches_jax(jax_side, setup, ranks, references):
    """PWC-Net's flow step on ``{"data": 1, "spatial": 2}`` against JAX's
    single-device step and its step on a ``{"data": 1, "spatial": 2}``
    mesh; both ranks moved halos and gathered maps."""
    hold_flow_to_jax(ranks["flow"], references["jax"][jax_side], setup["flow"][2])
    for rank in ranks["flow"]:
        band = rank["band"]
        assert band["halo_bytes"] > 0 and band["gather_bytes"] > 0


def test_two_by_two_flow_mesh_matches_jax(setup, ranks, references):
    """Four ranks on ``{"data": 2, "spatial": 2}``: two samples a data
    index, each in two bands."""
    hold_flow_to_jax(ranks["grid"], references["jax"]["single"], setup["grid"])


def test_flow_reg_gradient_on_two_ranks_matches_one_process(ranks, references):
    """The regularizer alone: every rank holds the flownet's weights
    whole, the group's first rank alone counts it, and the step's sum over
    the mesh gives one process's gradient (without that, twice it)."""
    single = references["reg"]
    for rank in ranks["reg"]:
        np.testing.assert_allclose(rank["metrics"]["loss/flow_reg"],
                                   single["metrics"]["loss/flow_reg"], rtol=1e-6)
        assert rank["grads"].keys() == single["grads"].keys()
        for key, grad in single["grads"].items():
            np.testing.assert_allclose(rank["grads"][key].numpy(), grad.numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=key)


def test_flow_eval_and_predict_on_the_mesh_match_one_process(setup, ranks):
    """The eval metrics and the predicted flows of the two-band steps
    against one process's: every flow comes back whole, the same on both
    ranks."""
    case = setup["flow"][2]
    model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()
    model.load_state_dict(case.state)
    loss = ddp_check._build(case, torch.device("cpu"))[1]
    feats = shard_batch(case.batch, make_mesh(device="cpu"))
    metrics = make_eval_step(model, loss)(feats)
    preds = make_predict_step(model)(feats)
    for rank in ranks["eval_predict"]:
        for key, value in metrics.items():
            np.testing.assert_allclose(rank["metrics"][key], float(value), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        assert len(rank["preds"]["flow_ms"]) == len(preds["flow_ms"]) == 4
        for got, want in zip(rank["preds"]["flow_ms"], preds["flow_ms"]):
            assert got.shape == tuple(want.shape)
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
    first, second = (rank["preds"]["flow_ms"] for rank in ranks["eval_predict"])
    assert all(np.array_equal(a, b) for a, b in zip(first, second))


def test_flow_plan_row_on_the_mesh_matches_one_process(setup, ranks, references):
    """One flow row of 2 steps on ``{"data": 1, "spatial": 2}``: both ranks
    end the row with one state, rank 0 alone writes, and its flownet
    checkpoint matches one process's."""
    plan = ranks["plan"]
    assert plan[0]["writes"] == [{"snapshot_config": 1, "save": 2, "save_log": 1}]
    assert plan[1]["writes"] == [{}]
    for key, value in plan[0]["states"][0].items():
        assert torch.equal(plan[1]["states"][0][key], value), key
    one = references["plan"] / "checkpts" / "spf" / "flownet_latest.pt"
    mesh = setup["roots"]["mesh"] / "checkpts" / "spf" / "flownet_latest.pt"
    a = torch.load(one, map_location="cpu", weights_only=True)
    b = torch.load(mesh, map_location="cpu", weights_only=True)
    assert a.keys() == b.keys()
    for key, value in a.items():
        diff = (b[key] - value).abs()
        # Adam moves a weight by at most lr a step, whatever a noise-level
        # gradient's sign; most weights agree to rounding
        assert float(diff.max()) <= 2 * 2 * 1e-4 + 1e-6, key
        assert float(diff.median()) <= 1e-6, key


def _whole_and_band(seed, channels, height, width, md, stride):
    rng = np.random.RandomState(seed)
    n2 = len(range(-md, md + 1, stride)) ** 2
    cl, cr = (torch.from_numpy(rng.uniform(-1, 1, (2, channels, height, width))
                               .astype(np.float32)) for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((2, n2, height, width)).astype(np.float32))
    return cl, cr, g


@pytest.mark.parametrize("md,stride", [(4, 1), (4, 2), (8, 2), (12, 4), (2, 3)])
@pytest.mark.parametrize("first,rows", [(0, 4), (4, 4), (8, 4), (2, 7)])
@pytest.mark.parametrize("route", ["halo", "gathered"])
def test_band_correlation_twins_equal_the_whole_frame_rows(md, stride, first, rows, route):
    """K2's, K3's and K4's plain twins on ``rows`` rows of a 12-row frame
    from row ``first`` give the whole frame's rows bit for bit: against
    cr's halo of md rows (zeros beyond the frame, row offset md) or the
    whole cr (row offset ``first``); K4's band dcr over cr's rows is the
    band's share, which the halo's or the gather's backward sums. The
    autograd of the band cost volume equals the two gradient twins.

    32 columns: K2's twin sums the channels with ``torch.sum`` over a
    non-inner axis, which torch's CPU kernel splits over the outputs in
    blocks of columns; below 32 columns a band's blocks and the frame's
    differ, and so may the last bit of a sum (K3's and K4's twins add the
    displacements elementwise, in one order at any shape)."""
    height = 12
    cl, cr, g = _whole_and_band(first * 31 + md, 5, height, 32, md, stride)
    out = correlation_cost_plain(cl, cr, md, stride)
    dcl = correlation_grad_cl_plain(g, cr, md, stride)
    band = slice(first, first + rows)
    if route == "halo":
        # cr's rows first - md .. first + rows - 1 + md, zeros outside the frame
        top, bottom = max(0, md - first), max(0, first + rows + md - height)
        cr_rows = F.pad(cr, (0, 0, top, bottom))[:, :, first - md + top:
                                                 first + rows + md + top]
        offset = md
    else:
        cr_rows, offset = cr, first
    got = correlation_cost_plain(cl[:, :, band], cr_rows, md, stride, offset)
    np.testing.assert_array_equal(got.numpy(), out[:, :, band].numpy())
    got_dcl = correlation_grad_cl_plain(g[:, :, band], cr_rows, md, stride, offset)
    np.testing.assert_array_equal(got_dcl.numpy(), dcl[:, :, band].numpy())
    # K4: the band's share of dcr, on cr's rows; the bands' shares sum to
    # the whole frame's dcr
    got_dcr = correlation_grad_cr_plain(g[:, :, band], cl[:, :, band], md, stride, offset,
                                        cr_rows.shape[2])
    assert got_dcr.shape == cr_rows.shape
    g_band = torch.zeros_like(g)
    g_band[:, :, band] = g[:, :, band]
    share = correlation_grad_cr_plain(g_band, cl, md, stride)
    if route == "halo":
        # the halo's rows in the frame (those beyond it are zeros whose
        # gradient the halo's backward drops)
        lo, hi = max(0, first - md), min(height, first + rows + md)
        np.testing.assert_array_equal(got_dcr[:, :, lo - first + md: hi - first + md].numpy(),
                                      share[:, :, lo:hi].numpy())
    else:
        np.testing.assert_array_equal(got_dcr.numpy(), share.numpy())
    # the autograd of the band's cost volume: the two twins, up to the
    # order of the float32 sums
    leaves = [cl[:, :, band].clone().requires_grad_(), cr_rows.clone().requires_grad_()]
    auto = torch.autograd.grad(correlation_cost_plain(*leaves, md, stride, offset), leaves,
                               g[:, :, band])
    for got_grad, twin in zip(auto, (got_dcl, got_dcr)):
        np.testing.assert_allclose(got_grad.numpy(), twin.numpy(), rtol=0,
                                   atol=1e-6 * float(twin.abs().max()))


def test_band_correlation_twins_with_no_row_in_the_frame():
    """A band whose every displaced row lies outside cr's rows: zeros."""
    cl, cr, g = _whole_and_band(1, 3, 4, 6, 2, 1)
    assert not correlation_cost_plain(cl, cr[:, :, :2], 2, 1, 9).any()
    assert not correlation_grad_cl_plain(g, cr[:, :, :2], 2, 1, 9).any()
    dcr = correlation_grad_cr_plain(g, cl, 2, 1, 9, 2)
    assert dcr.shape == (2, 3, 2, 6) and not dcr.any()
