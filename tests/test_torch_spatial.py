"""The port's height-sharded ``("data", "spatial")`` mesh
(``xpt_mde_tpu_torch.parallel.spatial``) against the JAX package's.

Gloo ranks on the CPU (``tools/ddp_check.py``, spawned, meeting through a
``file://`` rendezvous in a temporary directory) each hold a band of the
image rows of their data index's samples:

- the rigid slice: EfficientNetB0 + PoseNetImproved at 64x128, batch 4,
  the rigid recipe, on ``{"data": 1, "spatial": 2}``, held to the JAX
  package's ``make_parallel_train_step`` on a ``{"data": 1, "spatial":
  2}`` mesh over two of conftest's eight CPU devices and to its
  single-device ``make_train_step``, from the same weights
  (``convert.py``): the loss within JAX's rtol 1e-4 and the parameters
  within its 1e-4 (``tests/test_parallel.py``), each BatchNorm running
  statistic within 2e-5, the gradients by ``test_torch_zoo_step.py``'s
  float64 rule;
- the JAX test's own shape (``tests/test_parallel.py``): DepthNetBasic +
  PoseNetBasic at 16x32, batch 8, ``{"L1": 1}``, whose maps below 4 rows
  are gathered and computed whole by both ranks;
- a 2-D ``{"data": 2, "spatial": 2}`` mesh on four ranks;
- the eval and predict steps on the mesh against the one-process steps,
  and a one-row plan (``train_by_plan``, then ``predict_by_plan`` on the
  mesh) against one process;
- each band module, forward and backward, its bands gathered against the
  whole map (``tools/spatial_check.py``: the rigid path's and, since the
  flow stage runs on the mesh, PWC-Net's), and K1's and K1-bwd's plain
  twins on a band of target rows; the joint step's full-resolution loss
  terms (cmb, md2, md2cmb) on bands; ``check_spatial`` admitting the
  rigid path, the flow stage and the joint step and refusing the rest
  (the flow stage's steps are ``tests/test_torch_spatial_flow.py``'s, the
  joint step's ``tests/test_torch_spatial_joint.py``'s).
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_parallel import (BATCH, LR, NETS_B0, RIGID, _batch, grads_by_float64,
                                 jax_and_port_case)
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.parallel import make_mesh as j_make_mesh
from xpt_mde_tpu.parallel import make_parallel_train_step as j_make_parallel_train_step
from xpt_mde_tpu.parallel import replicate_state as j_replicate_state
from xpt_mde_tpu.parallel import shard_batch as j_shard_batch
from xpt_mde_tpu.training import optimizer_factory as j_optimizer_factory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_train_step as j_make_train_step
from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1, Config, TrainStage
from xpt_mde_tpu_torch.config import TestStage as PlanTestStage
from xpt_mde_tpu_torch.convert import flax_params_to_torch, flax_to_state_dict
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.ops.camera import pixel_grid, reproject_pixel_coords
from xpt_mde_tpu_torch.ops.warp import bilinear_sample_plain, warp_coord_grad_plain
from xpt_mde_tpu_torch.parallel import Mesh, make_mesh, make_multihost_mesh
from xpt_mde_tpu_torch.parallel.sharding import feature_sharding, shard_batch
from xpt_mde_tpu_torch.tools import ddp_check, spatial_check
from xpt_mde_tpu_torch.training import make_eval_step, make_predict_step
from xpt_mde_tpu_torch.training.trainer import train_by_plan
from xpt_mde_tpu_torch.evaluate.evaluate_main import predict_by_plan

SPATIAL = {"data": 1, "spatial": 2}
GRID = {"data": 2, "spatial": 2}
NETS_BASIC = {"depth": "DepthNetBasic", "camera": "PoseNetBasic"}
BASIC_SCALES = (4.0, 0.0, 0.0, 0.0)
PLAN_RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
MODULE_CASES = list(spatial_check.MAP_CASES) + list(spatial_check.LOSS_CASES)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _basic_batch():
    """The JAX test's batch: 8 float snippets at 16x32."""
    data = SyntheticDataset(batch_size=8, height=16, width=32, num_batches=1)
    return data.config_keys(), next(iter(data))


def _plan_cfg(root, shape) -> Config:
    """One rigid row of 2 steps (8 snippets, a global batch of 4) at 32x64,
    and its test-split prediction."""
    world = math.prod(shape.values())
    return Config(stereo=False, per_replica_batch=4 // world, mesh_shape=shape,
                  datapath=str(root), ckpt_name="sp", pretrained_weight=False,
                  compute_dtype="float32", loader_workers=1,
                  training_plan=[TrainStage(NETS_BASIC, "synthetic", 1, 1e-4, PLAN_RECIPE,
                                            SCALE_WEIGHT_T1)],
                  test_plan=[PlanTestStage(NETS_BASIC, "synthetic", ["depth", "pose"], "sp")])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    keys, batch = _batch()
    b0 = jax_and_port_case(keys, batch, NETS_B0, RIGID, {"mesh_shape": SPATIAL})
    grid = ddp_check.StepCase(NETS_B0, keys, RIGID, batch, state=b0[2].state, lr=LR,
                              mesh_shape=GRID)
    bkeys, bbatch = _basic_batch()
    basic = jax_and_port_case(bkeys, bbatch, NETS_BASIC, {"L1": 1.0},
                              {"mesh_shape": SPATIAL, "scale_weights": BASIC_SCALES})
    roots = {}
    for name in ("one", "mesh"):
        roots[name] = tmp_path_factory.mktemp(f"plan_{name}")
        chip_smoke.write_synthetic_shards(roots[name] / "shards", 32, 64,
                                          {"train": 8, "test": 4})
    return {"b0": b0, "grid": grid, "basic": basic, "roots": roots}


def _spawned(setup, two_dir, four_dir) -> dict:
    """Every two-rank check in one gloo group, then the four-rank step."""
    tasks = [(spatial_check.rank_modules, (MODULE_CASES,)),
             (spatial_check.rank_modules, (list(spatial_check.MAP_CASES), 0, torch.bfloat16)),
             (ddp_check.rank_steps, ([setup["b0"][2], setup["basic"][2]],)),
             (ddp_check.rank_eval_predict, (setup["b0"][2],)),
             (ddp_check.rank_spatial_plan, (_plan_cfg(setup["roots"]["mesh"], SPATIAL),))]
    two = ddp_check.run_ranks(ddp_check.rank_tasks, (tasks,), 2, "cpu", workdir=two_dir)
    four = ddp_check.ddp_steps([setup["grid"]], 4, "cpu", workdir=four_dir)[0]
    modules, modules_bf16, steps, eval_predict, plan = zip(*two)
    return {"modules": modules[0], "modules_bf16": modules_bf16[0], "b0": [s[0] for s in steps],
            "basic": [s[1] for s in steps], "eval_predict": eval_predict, "plan": plan,
            "grid": four}


@pytest.fixture(scope="module")
def references(setup, tmp_path_factory):
    """The ranks' results (spawned processes, waited for in a thread) and,
    meanwhile in this process, the references: JAX's steps, the port's
    float64 step and its one-process plan."""
    out = {}

    def spawn():
        try:
            out["ranks"] = _spawned(setup, tmp_path_factory.mktemp("ranks2"),
                                    tmp_path_factory.mktemp("ranks4"))
        except BaseException as exc:  # raised in the test's thread below
            out["error"] = exc

    waiter = threading.Thread(target=spawn)
    waiter.start()
    try:
        out["jax"] = _jax_steps(setup)
        out["grads64"] = ddp_check.single_step(setup["b0"][2], dtype=torch.float64)["grads"]
        out["plan"] = _one_process_plan(setup)
    finally:
        waiter.join()
    if "error" in out:
        raise out["error"]
    return out


@pytest.fixture(scope="module")
def ranks(references):
    return references["ranks"]


@pytest.fixture(scope="module")
def jax_steps(references):
    return references["jax"]


@pytest.fixture(scope="module")
def b0_grads64(references):
    return references["grads64"]


@pytest.fixture(scope="module")
def one_process_plan(references):
    return references["plan"]


def _jax_step(jmodel, variables, case, scale_weights, shape=None):
    """JAX's step of ``case``: on one device, or over a mesh of ``shape``
    on the first of conftest's CPU devices. (metrics, gradients from Adam's
    first moment, new variables)."""
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables.get("batch_stats", {}),
                              tx=j_optimizer_factory("adam_constant", LR))
    loss = j_loss_factory(case.keys, case.recipe, scale_weights, stereo=False,
                          batch_size=case.global_batch)
    feats = {k: jnp.asarray(v) for k, v in case.batch.items()}
    if shape is None:
        new, metrics = j_make_train_step(jmodel, loss)(state, feats, jax.random.PRNGKey(0))
    else:
        mesh = j_make_mesh(shape, devices=jax.devices()[:math.prod(shape.values())])
        sharded = j_shard_batch(feats, mesh)
        assert sharded["image5d"].sharding.spec == ("data", None, "spatial")
        new, metrics = j_make_parallel_train_step(jmodel, loss, mesh)(
            j_replicate_state(state, mesh), sharded, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, new.opt_state[0].mu)
    return ({k: float(v) for k, v in metrics.items()}, grads,
            jax.tree_util.tree_map(np.asarray, {"params": new.params,
                                                "batch_stats": new.batch_stats}))


def _jax_steps(setup) -> dict:
    jmodel, variables, case = setup["b0"]
    bmodel, bvariables, bcase = setup["basic"]
    return {"b0 single": _jax_step(jmodel, variables, case, SCALE_WEIGHT_T1),
            "b0 spatial": _jax_step(jmodel, variables, case, SCALE_WEIGHT_T1, SPATIAL),
            "basic single": _jax_step(bmodel, bvariables, bcase, BASIC_SCALES),
            "basic spatial": _jax_step(bmodel, bvariables, bcase, BASIC_SCALES, SPATIAL)}


def hold_to_jax(ranks, jax_result, case, grads64=None) -> None:
    """The ranks' step against one JAX step: replicas equal, the loss terms
    within rtol 1e-4, each running statistic within 2e-5, each parameter
    within 1e-4 where both gradients have one sign (Adam's first step moves
    a weight by +-lr whatever a noise-level gradient's sign: every weight
    within 2 lr, 99% of them of one sign); with ``grads64`` the gradients
    by the float64 rule."""
    jmetrics, jgrads, jnew = jax_result
    first = ranks[0]
    model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()
    for other in ranks[1:]:
        assert other["metrics"] == first["metrics"]
        for key, value in first["state"].items():
            assert torch.equal(other["state"][key], value), key
    for key in ["loss"] + [f"loss/{k}" for k in case.recipe]:
        np.testing.assert_allclose(first["metrics"][key], jmetrics[key], rtol=1e-4,
                                   err_msg=key)
    ref = flax_params_to_torch(jgrads, model)
    if grads64 is not None:
        grads_by_float64(first["grads"], ref, grads64)
    want = flax_to_state_dict(jnew, model)
    same_sign = total = 0
    for key, value in first["state"].items():
        if key.endswith("num_batches_tracked"):
            continue
        got, ref_value = value.numpy(), want[key].numpy()
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, ref_value, atol=2e-5, rtol=1e-5, err_msg=key)
            continue
        if key not in first["grads"]:
            np.testing.assert_array_equal(got, ref_value, err_msg=key)
            continue
        same = np.sign(first["grads"][key].numpy()) == np.sign(ref[key].numpy())
        assert np.all(np.abs(got - ref_value)[same] <= 1e-4), key
        assert np.all(np.abs(got - ref_value) <= 2 * LR + 1e-6), key
        same_sign += int(same.sum())
        total += same.size
    assert same_sign >= 0.99 * total, (same_sign, total)


@pytest.mark.parametrize("jax_side", ["single", "spatial"])
def test_spatial_rigid_step_matches_jax(jax_side, setup, ranks, jax_steps, b0_grads64):
    """Two ranks on ``{"data": 1, "spatial": 2}`` against JAX's
    single-device step and its step on a ``{"data": 1, "spatial": 2}``
    mesh, each rank's spatial collectives having moved halos, gathered
    maps and summed means. The gradients' float64 rule takes JAX's
    single-device step as its reference (its median distance from float64,
    ~7e-3 here, is the rule's scale); JAX's spatial step sits ~1.05e-2 from
    float64, past the rule's bound for a reference, so against it the loss,
    the statistics and the parameters are held."""
    hold_to_jax(ranks["b0"], jax_steps[f"b0 {jax_side}"], setup["b0"][2],
                b0_grads64 if jax_side == "single" else None)
    for rank in ranks["b0"]:
        band = rank["band"]
        assert band["halo_bytes"] > 0 and band["gather_bytes"] > 0 and band["sum_bytes"] > 0


@pytest.mark.parametrize("jax_side", ["single", "spatial"])
def test_jax_test_shape_gathers_the_small_maps(jax_side, setup, ranks, jax_steps):
    """The JAX test's DepthNetBasic + PoseNetBasic at 16x32 on S = 2: the
    maps of fewer than 4 rows are held whole by both ranks."""
    hold_to_jax(ranks["basic"], jax_steps[f"basic {jax_side}"], setup["basic"][2])


def test_two_by_two_mesh_matches_jax(setup, ranks, jax_steps, b0_grads64):
    """Four ranks on ``{"data": 2, "spatial": 2}``: two rows a data index,
    each in two bands."""
    hold_to_jax(ranks["grid"], jax_steps["b0 single"], setup["grid"], b0_grads64)


def test_eval_and_predict_on_the_mesh_match_one_process(setup, ranks):
    case = setup["b0"][2]
    model = ModelFactory(case.keys, case.nets, stereo=False, device="cpu").get_model()
    model.load_state_dict(case.state)
    loss = ddp_check._build(case, torch.device("cpu"))[1]
    feats = shard_batch(case.batch, make_mesh(device="cpu"))
    metrics = make_eval_step(model, loss)(feats)
    preds = make_predict_step(model)(feats)
    for rank in ranks["eval_predict"]:
        for key, value in metrics.items():
            # the losses: the bands' shares summed; eval-mode BatchNorm, so
            # float32's rounding of the same sums grouped by band
            np.testing.assert_allclose(rank["metrics"][key], float(value), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        for key in ("depth_ms", "debug_out"):
            for got, want in zip(rank["preds"][key], preds[key]):
                assert got.shape == tuple(want.shape), key
                np.testing.assert_allclose(got, want.numpy(), rtol=1e-5,
                                           atol=1e-5 * float(want.abs().max()), err_msg=key)
        np.testing.assert_allclose(rank["preds"]["pose"], preds["pose"].numpy(), rtol=1e-5,
                                   atol=1e-6)
    first, second = (rank["preds"]["depth_ms"] for rank in ranks["eval_predict"])
    assert all(np.array_equal(a, b) for a, b in zip(first, second))


def _one_process_plan(setup):
    cfg = _plan_cfg(setup["roots"]["one"], {"data": 1})
    train_by_plan(cfg, device="cpu")
    predict_by_plan(cfg, device="cpu")
    return setup["roots"]["one"]


def test_plan_on_the_mesh_checkpoints_and_predicts_what_one_process_does(
        setup, ranks, one_process_plan):
    """One rigid row of 2 steps on ``{"data": 1, "spatial": 2}``: both
    ranks end the row with one state, rank 0 alone writes, and its
    checkpoints and the mesh's prediction npz match one process's."""
    plan = ranks["plan"]
    assert plan[0]["writes"] == [{"snapshot_config": 1, "save": 2, "save_log": 1}]
    assert plan[1]["writes"] == [{}]
    for key, value in plan[0]["states"][0].items():
        assert torch.equal(plan[1]["states"][0][key], value), key
    one = one_process_plan / "checkpts" / "sp"
    mesh = setup["roots"]["mesh"] / "checkpts" / "sp"
    for name in ("depthnet_latest.pt", "posenet_latest.pt"):
        a = torch.load(one / name, map_location="cpu", weights_only=True)
        b = torch.load(mesh / name, map_location="cpu", weights_only=True)
        for key, value in a.items():
            diff = (b[key] - value).abs()
            # Adam moves a weight by at most lr a step, whatever a
            # noise-level gradient's sign; most weights agree to rounding
            assert float(diff.max()) <= 2 * 1e-4 + 1e-6, (name, key)
            assert float(diff.median()) <= 1e-6, (name, key)
    got = dict(np.load(setup["roots"]["mesh"] / "prediction" / "sp" / "synthetic_latest.npz"))
    want = dict(np.load(one_process_plan / "prediction" / "sp" / "synthetic_latest.npz"))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("name", MODULE_CASES)
def test_band_module_matches_the_whole_map(name, ranks):
    """The bands of the module's output, and its input's and parameters'
    gradients summed over the ranks, against the one-process module: the
    same sums grouped by band, so the largest difference at most 4e-6 of
    the largest value (``spatial_check.FLOAT32_RTOL``)."""
    errors = spatial_check.errors(ranks["modules"][name])
    assert max(errors.values()) <= spatial_check.FLOAT32_RTOL == 4e-6, errors


@pytest.mark.parametrize("name", list(spatial_check.MAP_CASES))
def test_band_module_matches_the_whole_map_in_bfloat16(name, ranks):
    """The map modules computing in bfloat16 (a bf16 step's), bands
    against the whole map as above, within ``spatial_check.BF16_RTOL``
    (2^-5) of the largest value: what ``chip_smoke.py`` phase 30 holds on
    the card."""
    errors = spatial_check.errors(ranks["modules_bf16"][name])
    assert max(errors.values()) <= spatial_check.BF16_RTOL, errors


@pytest.mark.parametrize("first", [0, 4])
def test_plain_warp_twins_on_a_band_of_target_rows(first):
    """K1's and K1-bwd's plain twins on 4 target rows of an 8-row frame
    give that band's rows of the whole warp, bit for bit: the coordinates
    are global, the neighbours clipped to the source."""
    rng = np.random.RandomState(first)
    image = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 8, 10, 3)).astype(np.float32))
    depth = torch.from_numpy(rng.uniform(1, 10, (2, 8, 10, 1)).astype(np.float32))
    depth[0, 1, 2] = 0.0
    pose = torch.eye(4).repeat(2, 3, 1, 1)
    pose[..., 0, 3] = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32))
    intrinsic = torch.tensor([[8.0, 0, 5], [0, 8.0, 4], [0, 0, 1]]).repeat(2, 1, 1)
    coords = reproject_pixel_coords(depth, pose, intrinsic)
    band_depth = depth[:, first: first + 4]
    band_coords = reproject_pixel_coords(band_depth, pose, intrinsic,
                                         pixel_grid(4, 10, first_row=first))
    np.testing.assert_array_equal(band_coords.numpy(), coords.reshape(2, 3, 2, 8, 10)[
        :, :, :, first: first + 4].reshape(2, 3, 2, 40).numpy())
    out = bilinear_sample_plain(image, coords, depth)
    band = bilinear_sample_plain(image, band_coords, band_depth)
    assert band.shape == (2, 3, 4, 10, 3)
    np.testing.assert_array_equal(band.numpy(), out[:, :, first: first + 4].numpy())
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    grad = warp_coord_grad_plain(image, coords, depth, g)
    band_grad = warp_coord_grad_plain(image, band_coords, band_depth,
                                      g[:, :, first: first + 4].contiguous())
    np.testing.assert_array_equal(band_grad.numpy(), grad.reshape(2, 3, 2, 8, 10)[
        :, :, :, first: first + 4].reshape(2, 3, 2, 40).numpy())


def test_mesh_shapes_and_feature_sharding_by_name():
    """``make_mesh`` over one process: the data mesh, a product that does
    not match raises; ``feature_sharding`` splits the height of the
    image-like features by NAME, and pose_gt and stereo_T_LR stay data-only
    whatever their rank (tests/test_parallel.py's rule)."""
    assert make_mesh(device="cpu").axis_names == ("data",)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(SPATIAL, device="cpu")
    mesh = Mesh(None, 0, 8, torch.device("cpu"), spatial=8)
    assert mesh.shape == {"data": 1, "spatial": 8} and mesh.axis_names == ("data", "spatial")
    assert (Mesh(None, 5, 8, torch.device("cpu"), spatial=2).data_index,
            Mesh(None, 5, 8, torch.device("cpu"), spatial=2).spatial_index) == (2, 1)
    assert feature_sharding(mesh, 5, "image5d") == ("data", None, "spatial")
    assert feature_sharding(mesh, 4, "depth_gt") == ("data", "spatial")
    assert feature_sharding(mesh, 4, "pose_gt") == ("data",)
    assert feature_sharding(mesh, 3, "stereo_T_LR") == ("data",)
    assert feature_sharding(make_mesh(device="cpu"), 5, "image5d") == ("data",)


def test_multihost_mesh_keeps_the_trailing_axes_on_one_host(monkeypatch):
    """JAX's rule (``parallel/multihost.py``): the axes after the first must
    divide one host's processes, so a sample's bands never cross hosts."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="must divide the per-host process count 1"):
        make_multihost_mesh(SPATIAL, device="cpu")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_multihost_mesh(SPATIAL, device="cpu")


def test_flow_rows_on_a_spatial_mesh_raise():
    """``check_spatial`` admits the rigid path (the md2 terms too), the flow
    stage (PWC-Net alone, flowL2 and flow_reg) and the joint step (PWC-Net
    frozen beside the depth and pose nets, the cmb, md2 and md2cmb terms;
    its eval and predict steps), and still raises, naming ROADMAP queue 1
    item 4, for a stereo recipe's terms, the moa terms, another backbone
    and ``PoseNetPreTrained``; and for a flownet that a joint train step
    would train."""
    from types import SimpleNamespace

    from xpt_mde_tpu_torch.config import FLOW_NET
    from xpt_mde_tpu_torch.parallel.sharding import check_spatial

    def recipe(*terms):
        return SimpleNamespace(loss_objects=dict.fromkeys(terms))

    keys = ["image", "intrinsic"]
    flow = ModelFactory(keys, FLOW_NET, stereo=False, device="cpu").get_model()
    rigid = ModelFactory(keys, NETS_BASIC, stereo=False, device="cpu").get_model()
    joint = ModelFactory(keys, dict(NETS_BASIC, **FLOW_NET), stereo=False,
                         device="cpu").get_model()
    other_backbone = ModelFactory(keys, {"depth": "MobileNetV2", "camera": "PoseNetBasic"},
                                  stereo=False, device="cpu").get_model()
    pose_backbone = ModelFactory(keys, {"depth": "DepthNetBasic", "camera": "MobileNetV2"},
                                 stereo=False, device="cpu").get_model()
    frozen = {"flownet"}
    check_spatial(flow)
    check_spatial(flow, recipe("flowL2", "flow_reg"))
    check_spatial(rigid, recipe("L1", "SSIM", "smoothe"))
    check_spatial(rigid, recipe("md2L1", "md2SSIM", "smoothe"), frozen_nets=set())
    check_spatial(joint)
    for terms in (("cmbL1", "cmbSSIM", "smoothe"), ("md2cmbL1", "md2cmbSSIM", "smoothe"),
                  ("md2L1", "md2SSIM", "smoothe"), ()):
        check_spatial(joint, recipe(*terms))
        check_spatial(joint, recipe(*terms), frozen_nets=frozen)
    for model, terms in ((rigid, ("L1", "L1_R", "stereoL1", "stereoPose")),
                         (joint, ("cmbL1", "cmbL1_R")), (flow, ("flowL2", "flowL2_R")),
                         (flow, ("flowL2", "cmbL1")), (rigid, ("moaSSIM",)),
                         (joint, ("cmbL1", "moaL1")), (other_backbone, ("L1",)),
                         (pose_backbone, ("L1",))):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 4"):
            check_spatial(model, recipe(*terms))
    with pytest.raises(NotImplementedError, match="freezes it"):
        check_spatial(joint, recipe("cmbL1"), frozen_nets=set())
