"""The port's plan driver on the CPU: ``train_by_plan`` over a rigid, a
flow and a joint row (EfficientNetB0 + PoseNetImproved, PWCNet, then the
three with the flownet frozen) at 64x128, batch 2, 2 steps a row, on
synthetic shards read by the native loader; the checkpoints' hand-off
between rows, resume, and the logger's history.csv against the JAX
package's. Comparisons are exact (bit for bit, or text for text).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from xpt_mde_tpu.training.logger import TrainingLogger as JTrainingLogger
from xpt_mde_tpu_torch.config import (AUGMENT_PROBS, SCALE_WEIGHT_T1, Config, TrainStage)
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.parallel import Mesh, make_mesh
from xpt_mde_tpu_torch.training import optimizer_factory
from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager, snapshot_config
from xpt_mde_tpu_torch.training.logger import TrainingLogger
from xpt_mde_tpu_torch.training.trainer import default_dataset_factory, train_by_plan
from xpt_mde_tpu_torch.utils.util_class import WrongInputError

RIGID = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
FLOW = {"flow": "PWCNet"}
JOINT = dict(RIGID, **FLOW)
PLAN = [TrainStage(RIGID, "synthetic", 1, 1e-4, {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0},
                   SCALE_WEIGHT_T1),
        TrainStage(FLOW, "synthetic", 1, 1e-4, {"flowL2": 1.0, "flow_reg": 4e-7},
                   SCALE_WEIGHT_T1),
        TrainStage(JOINT, "synthetic", 1, 1e-4, {"cmbL1": 5.0, "cmbSSIM": 0.5, "smoothe": 20.0},
                   SCALE_WEIGHT_T1)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # these steps are heavy: two intra-op threads keep the test workers
    # that run beside this module from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _cfg(root, plan, **kw) -> Config:
    return Config(stereo=False, per_replica_batch=2, datapath=str(root), ckpt_name="t",
                  pretrained_weight=False, augment_probs=AUGMENT_PROBS, training_plan=plan,
                  compute_dtype="float32", **kw)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.fixture(scope="module")
def plan_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("plan")
    chip_smoke.write_synthetic_shards(root / "shards", 64, 128,
                                      {"train": 4, "val": 2, "test": 2})
    cfg = _cfg(root, PLAN)
    train_by_plan(cfg, device="cpu")
    return cfg, Path(cfg.datapath_ckp) / cfg.ckpt_name


def test_plan_trains_every_row(plan_run):
    _, ckpt = plan_run
    history = (ckpt / "history.csv").read_text().strip().splitlines()
    assert [line.split(",")[0] for line in history[1:]] == ["0", "1", "2"]
    for name in ("depthnet_ep01", "posenet_ep01", "flownet_ep02", "depthnet_ep03",
                 "posenet_ep03", "flownet_ep03", "trainstate_ep01", "trainstate_ep02",
                 "trainstate_ep03", "depthnet_latest", "posenet_latest", "flownet_latest"):
        assert (ckpt / f"{name}.pt").is_file(), name
    # the joint row trains the depth and pose nets it took from the rigid row
    assert not _equal(_load(ckpt / "depthnet_ep03.pt"), _load(ckpt / "depthnet_ep01.pt"))
    assert not _equal(_load(ckpt / "posenet_ep03.pt"), _load(ckpt / "posenet_ep01.pt"))
    assert (ckpt / "mean_result.csv").is_file() and (ckpt / "scales.txt").is_file()


def test_joint_row_keeps_the_flow_rows_flownet(plan_run):
    _, ckpt = plan_run
    flow_row = _load(ckpt / "flownet_ep02.pt")
    assert _equal(_load(ckpt / "flownet_ep03.pt"), flow_row)
    assert _equal(_load(ckpt / "flownet_latest.pt"), flow_row)
    assert _equal(_load(ckpt / "trainstate_ep03.pt")["nets"]["flownet"], flow_row)


def test_finished_rows_are_skipped(plan_run, capsys):
    cfg, ckpt = plan_run
    before = {p.name: p.stat().st_mtime_ns for p in ckpt.iterdir()}
    train_by_plan(cfg, device="cpu")
    assert capsys.readouterr().out.count("already done") == len(PLAN)
    assert {p.name: p.stat().st_mtime_ns for p in ckpt.iterdir()} == before


def test_restore_full_is_stage_scoped(plan_run):
    _, ckpt = plan_run
    manager = CheckpointManager(ckpt)
    model = ModelFactory(["image", "intrinsic"], JOINT, stereo=False, device="cpu").get_model()
    optimizer = optimizer_factory("adam_constant", 1e-4, model, frozen_nets=["flownet"])
    assert manager.restore_full(model, optimizer, stage_idx=1) is None  # another row
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    assert _equal(model.state_dict(), fresh)  # nothing half loaded
    assert manager.restore_full(model, optimizer, stage_idx=2) == 2  # its own: 2 steps
    saved = _load(ckpt / "trainstate_latest.pt")
    assert _equal(optimizer.state_dict(), saved["optimizer"])
    for name in ("depthnet", "posenet", "flownet"):
        assert _equal(getattr(model, name).state_dict(), saved["nets"][name])
    # the per-net hand-off loads the nets a model shares with the files
    rigid = ModelFactory(["image", "intrinsic"], RIGID, stereo=False, device="cpu").get_model()
    assert manager.restore_params(rigid, "ep01")
    assert _equal(rigid.depthnet.state_dict(), _load(ckpt / "depthnet_ep01.pt"))
    # a full state whose nets do not fit is refused, not half loaded
    rigid_opt = optimizer_factory("adam_constant", 1e-4, rigid)
    assert manager.restore_full(rigid, rigid_opt, stage_idx=2) is None


def test_restore_params_skips_a_net_that_does_not_fit(tmp_path, capsys):
    model = ModelFactory(["image", "intrinsic"], RIGID, stereo=False, device="cpu").get_model()
    torch.save({"nope": torch.zeros(1)}, tmp_path / "posenet_latest.pt")
    before = {k: v.clone() for k, v in model.posenet.state_dict().items()}
    assert not CheckpointManager(tmp_path).restore_params(model)
    out = capsys.readouterr().out
    assert "no weights for depthnet" in out and "FAILED to load posenet" in out
    assert _equal(model.posenet.state_dict(), before)


def test_config_drift_and_unported_modes_raise(tmp_path):
    snapshot_config(tmp_path, _cfg(tmp_path, PLAN).to_json_dict())
    with pytest.raises(WrongInputError, match="depth_activation"):
        snapshot_config(tmp_path, _cfg(tmp_path, PLAN, depth_activation="Exponential")
                        .to_json_dict())
    # the data and spatial meshes are ported (test_torch_parallel.py,
    # test_torch_multihost.py, test_torch_spatial.py): a spatial mesh needs its
    # ranks; a model axis is not ported, and a global batch must divide by
    # the ranks
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(_cfg(tmp_path, PLAN, mesh_shape={"data": 1, "spatial": 2}).mesh_shape,
                  device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        make_mesh(_cfg(tmp_path, PLAN, mesh_shape={"data": 1, "model": 2}).mesh_shape,
                  device="cpu")
    with pytest.raises(ValueError, match="must divide by the world size"):
        train_by_plan(_cfg(tmp_path, PLAN), device="cpu",
                      mesh=Mesh(None, 0, 3, torch.device("cpu")))


class _Preempted(RuntimeError):
    pass


def _preempting_factory(cfg, budget):
    """The default shard loaders; the train loader dies after yielding
    ``budget`` batches (counted across epochs), as a preempted job would."""
    factory = default_dataset_factory(cfg)
    left = {"batches": budget}

    def make(name, split, batch_size):
        loader = factory(name, split, batch_size)
        if split != "train" or budget is None:
            return loader
        iter_from = loader.iter_from

        def dying_iter_from(start):
            for batch in iter_from(start):
                if left["batches"] <= 0:
                    raise _Preempted("simulated preemption")
                left["batches"] -= 1
                yield batch

        loader.iter_from = dying_iter_from
        return loader

    return make


def test_midway_resume_is_bit_exact(tmp_path):
    """A one-row plan of 2 epochs of 2 shuffled steps: a run killed in its
    second epoch resumes from its midway checkpoint and ends with the
    uninterrupted run's weights, optimizer state and history."""
    plan = [TrainStage(RIGID, "synthetic", 2, 1e-4, {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0},
                       SCALE_WEIGHT_T1)]
    runs = {}
    for label, every in (("ref", 0), ("pre", 1)):
        root = tmp_path / label
        chip_smoke.write_synthetic_shards(root / "shards", 32, 64, {"train": 4})
        runs[label] = _cfg(root, plan, ckpt_every_steps=every)
    train_by_plan(runs["ref"], _preempting_factory(runs["ref"], None), device="cpu")
    with pytest.raises(_Preempted):
        train_by_plan(runs["pre"], _preempting_factory(runs["pre"], 3), device="cpu")
    ckpt = Path(runs["pre"].datapath_ckp) / "t"
    meta = json.loads((ckpt / "midway.json").read_text())
    assert (meta["stage"], meta["epoch"], meta["steps_done"]) == (0, 1, 1)
    train_by_plan(runs["pre"], _preempting_factory(runs["pre"], None), device="cpu")
    assert not (ckpt / "midway.json").exists()
    ref_ckpt = Path(runs["ref"].datapath_ckp) / "t"
    got, want = _load(ckpt / "trainstate_latest.pt"), _load(ref_ckpt / "trainstate_latest.pt")
    assert got["step"] == want["step"] == 4
    assert _equal(got, want)
    rows = [(ckpt / "history.csv").read_text().splitlines(),
            (ref_ckpt / "history.csv").read_text().splitlines()]
    assert len(rows[0]) == len(rows[1]) == 3
    for ours, ref in zip(*rows):
        # the epoch's wall time differs; every mean is the same float
        ours, ref = ours.split(","), ref.split(",")
        sec = rows[1][0].split(",").index("train_sec_per_epoch")
        assert ours[:sec] + ours[sec + 1:] == ref[:sec] + ref[sec + 1:]


def test_history_csv_matches_the_jax_logger(tmp_path):
    """Epoch rows of a rigid, a flow and a joint row (the flow row brings
    new columns, the joint row more): the same history.csv and column
    guide text, and the same means."""
    rng = np.random.RandomState(0)
    rows = [({"loss": 1.0, "loss/L1": 0.5, "loss/SSIM": 0.25, "trj_err": 0.1},
             {"loss": 2.0, "loss/L1": 0.75}),
            ({"loss": 0.5, "loss/flowL2": 0.5, "loss/flow_reg": 3.0}, {}),
            ({"loss": 3.0, "loss/cmbL1": 0.25, "loss/cmbSSIM": rng.rand(),
              "sec_per_epoch": 1.5}, {"loss": rng.rand()})]
    ours, ref = TrainingLogger(tmp_path / "ours"), JTrainingLogger(tmp_path / "ref")
    for epoch, (train, val) in enumerate(rows):
        ours.save_log(epoch, train, val)
        ref.save_log(epoch, train, val)
    for name in ("history.csv", "how-to-read-columns.txt"):
        assert (tmp_path / "ours" / name).read_text() == (tmp_path / "ref" / name).read_text()
    means = [dict(line.split(",") for line in (tmp_path / d / "mean_result.csv")
                  .read_text().strip().splitlines()[1:]) for d in ("ours", "ref")]
    assert set(means[0]) == set(means[1])
    for key, value in means[1].items():
        np.testing.assert_allclose(float(means[0][key]), float(value), rtol=1e-15, err_msg=key)


def test_inspect_model_prints_like_jax(capsys):
    """Config.inspect_model's trace: the same lines as the JAX package's at
    the same three strided steps, from tensors."""
    from xpt_mde_tpu.training.trainer import inspect_model as j_inspect_model
    from xpt_mde_tpu_torch.training.trainer import inspect_model

    rng = np.random.RandomState(0)
    preds = {"depth_ms": [rng.rand(2, 8, 16, 1) * 10 for _ in range(4)],
             "flow_ms": [rng.randn(2, 4, 8, 16, 2)], "pose": rng.randn(2, 4, 6)}
    features = {"pose_gt": np.tile(np.eye(4), (2, 4, 1, 1))}
    t_preds = {"depth_ms": [torch.from_numpy(d) for d in preds["depth_ms"]],
               "flow_ms": [torch.from_numpy(preds["flow_ms"][0])],
               "pose": torch.from_numpy(preds["pose"])}
    for step in (0, 7, 10):
        ours = inspect_model(t_preds, {"pose_gt": torch.from_numpy(features["pose_gt"])},
                             step=step, steps_per_epoch=30)
        out = capsys.readouterr().out
        assert ours == j_inspect_model(preds, features, step=step, steps_per_epoch=30)
        assert out == capsys.readouterr().out
        assert ("depth0" in out) == ours


def test_inspect_model_prints_the_stereo_pose_like_jax(capsys):
    """With stereo predictions the trace adds the predicted stereo twists
    beside the extrinsic's translation, as the JAX package prints them."""
    from xpt_mde_tpu.training.trainer import inspect_model as j_inspect_model
    from xpt_mde_tpu_torch.training.trainer import inspect_model

    rng = np.random.RandomState(1)
    preds = {"pose": rng.randn(2, 4, 6), "pose_LR": rng.randn(2, 4, 6),
             "pose_RL": rng.randn(2, 4, 6)}
    t_lr = np.tile(np.eye(4), (2, 1, 1))
    t_lr[:, 0, 3] = 0.54
    features = {"pose_gt": np.tile(np.eye(4), (2, 4, 1, 1)), "stereo_T_LR": t_lr}
    assert inspect_model({k: torch.from_numpy(v) for k, v in preds.items()},
                         {k: torch.from_numpy(v) for k, v in features.items()},
                         step=0, steps_per_epoch=3)
    ours = capsys.readouterr().out
    assert j_inspect_model(preds, features, step=0, steps_per_epoch=3)
    assert ours == capsys.readouterr().out
    assert "T_LR_pr" in ours and "T_LR_gt" in ours
