"""The port's entry point on stereo shards, on the CPU: ``train_by_plan``
over a flow (``LOSS_FLOW``), a rigid (``LOSS_RIGID_T2``) and a joint row
(``LOSS_RIGID_COMB``, the flownet frozen) at EfficientNetB0 +
PoseNetImproved + PWCNet, 64x128, batch 2, 2 steps a row, on synthetic
stereo shards in the kitti_raw schema read by the native loader; then
``predict_by_plan`` and ``evaluate_by_plan``. And ``predict_by_plan`` on
a stereo test split against the JAX package's ``predict_by_plan`` from
the same weights, with ``Config.depth_upsample_interp`` set to another
value than the depth net's default, which neither package's predictions
follow.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from xpt_mde_tpu.config import Config as JConfig
from xpt_mde_tpu.config import TestStage as JTestStage
from xpt_mde_tpu.evaluate import evaluate_main as jeval
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu_torch.config import (LOSS_FLOW, LOSS_RIGID_COMB, LOSS_RIGID_T2,
                                      SCALE_WEIGHT_T1, Config, TestStage, TrainStage)
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.evaluate import evaluate_main as teval
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import optimizer_factory
from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager
from xpt_mde_tpu_torch.training.trainer import train_by_plan
from xpt_mde_tpu_torch.utils.precision import full_f32

RIGID = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
FLOW = {"flow": "PWCNet"}
JOINT = dict(RIGID, **FLOW)
PLAN = [TrainStage(FLOW, "kitti_raw", 1, 1e-4, LOSS_FLOW, SCALE_WEIGHT_T1),
        TrainStage(RIGID, "kitti_raw", 1, 1e-4, LOSS_RIGID_T2, SCALE_WEIGHT_T1),
        TrainStage(JOINT, "kitti_raw", 1, 1e-4, LOSS_RIGID_COMB, SCALE_WEIGHT_T1)]
HEIGHT, WIDTH = 64, 128


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # these steps are heavy: two intra-op threads keep the test workers
    # that run beside this module from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_stereo_plan_trains_predicts_and_evaluates(tmp_path, capsys):
    chip_smoke.write_stereo_shards(tmp_path / "shards", HEIGHT, WIDTH,
                                   {"train": 4, "val": 2, "test": 4})
    cfg = Config(per_replica_batch=2, datapath=str(tmp_path), ckpt_name="st",
                 pretrained_weight=False, inspect_model=True, training_plan=PLAN,
                 compute_dtype="float32",
                 test_plan=[TestStage(JOINT, "kitti_raw", ["depth", "pose"], "st")])
    assert cfg.stereo  # the JAX default, kept
    train_by_plan(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "T_LR_pr" in out and "T_LR_gt" in out  # inspect_model's stereo lines
    ckpt = Path(cfg.datapath_ckp) / "st"
    history = (ckpt / "history.csv").read_text().strip().splitlines()
    header = history[0].split(",")
    rows = [dict(zip(header, line.split(","))) for line in history[1:]]
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]
    # every stereo term of the recipes was trained and logged, finite
    for name in list(LOSS_FLOW) + list(LOSS_RIGID_T2) + list(LOSS_RIGID_COMB):
        values = [float(r[f"train_loss_{name}"]) for r in rows if r.get(f"train_loss_{name}")]
        assert values and all(np.isfinite(values)), name
    # the joint row starts from the flow row's flownet and keeps it
    flow_row = _load(ckpt / "flownet_ep01.pt")
    for name in ("flownet_ep03.pt", "flownet_latest.pt"):
        stored = _load(ckpt / name)
        assert set(stored) == set(flow_row)
        assert all(torch.equal(stored[k], flow_row[k]) for k in stored), name
    rigid_row = _load(ckpt / "depthnet_ep02.pt")
    assert not all(torch.equal(v, rigid_row[k]) for k, v in _load(ckpt / "depthnet_ep03.pt")
                   .items())

    teval.predict_by_plan(cfg, device="cpu")
    teval.evaluate_by_plan(cfg)
    npz = dict(np.load(Path(cfg.datapath_prd) / "st" / "kitti_raw_latest.npz"))
    # the JAX package's npz keys and layout: the left views only
    assert sorted(npz) == ["depth", "depth_gt", "image", "intrinsic", "pose", "pose_gt"]
    assert npz["depth"].shape == (4, HEIGHT, WIDTH, 1) and npz["pose"].shape == (4, 4, 6)
    summary = (Path(cfg.datapath_evl) / "st" / "summary_kitti_raw_latest.csv").read_text()
    values = dict(line.split(",") for line in summary.strip().splitlines()[1:])
    assert {"abs_rel", "a1", "trj_abs_err", "rot_err"} <= set(values)
    assert all(np.isfinite(float(v)) for v in values.values())


def _fill(shapes, seed):
    rng = np.random.RandomState(seed)

    def fill(path, sd):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*sd.shape) / np.sqrt(np.prod(sd.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean", "input_mean"):
            return (rng.randn(*sd.shape) * 0.05).astype(np.float32)
        return rng.uniform(0.5, 1.5, sd.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_stereo_predict_by_plan_matches_jax(tmp_path):
    """Both packages' predict_by_plan over one stereo test split, from
    checkpoints of the same weights (msgpack for JAX, state dicts for the
    port), with depth_upsample_interp="bilinear" in the Config: the npz
    files agree (rtol 1e-4, atol 1e-5 on predictions, as
    test_torch_evaluate.py; inputs bit for bit), then their evaluations."""
    chip_smoke.write_stereo_shards(tmp_path / "shards", HEIGHT, WIDTH, {"test": 5})
    keys = ["image", "intrinsic", "depth_gt", "pose_gt", "image_R", "intrinsic_R",
            "stereo_T_LR"]
    interp = "bilinear"
    with full_f32():
        jmodel = JModelFactory(keys, RIGID).get_model()
        example = {"image5d": jnp.zeros((2, 5, HEIGHT, WIDTH, 3)),
                   "image5d_R": jnp.zeros((2, 5, HEIGHT, WIDTH, 3)),
                   "intrinsic": jnp.tile(jnp.eye(3), (2, 1, 1)),
                   "stereo_T_LR": jnp.tile(jnp.eye(4), (2, 1, 1))}
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), example)),
                          5)
        state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=variables["batch_stats"], tx=optax.identity())
        JCheckpointManager(tmp_path / "checkpts" / "jrun").save(state, "latest")
        jcfg = JConfig(per_replica_batch=2, datapath=str(tmp_path), depth_upsample_interp=interp,
                       compute_dtype="float32",  # the parity mode
                       test_plan=[JTestStage(RIGID, "kitti_raw", ["depth", "pose"], "jrun")])
        jeval.predict_by_plan(jcfg)

        model = ModelFactory(keys, RIGID, device="cpu").get_model()
        load_flax_variables(model, variables)
        CheckpointManager(tmp_path / "checkpts" / "run").save(
            model, optimizer_factory("adam_constant", 1e-4, model), "latest")
        cfg = Config(per_replica_batch=2, datapath=str(tmp_path), depth_upsample_interp=interp,
                     compute_dtype="float32",
                     test_plan=[TestStage(RIGID, "kitti_raw", ["depth", "pose"], "run")])
        teval.predict_by_plan(cfg, device="cpu")
    ref = dict(np.load(tmp_path / "prediction" / "jrun" / "kitti_raw_latest.npz"))
    got = dict(np.load(tmp_path / "prediction" / "run" / "kitti_raw_latest.npz"))
    assert sorted(got) == sorted(ref)
    assert got["depth"].shape == (4, HEIGHT, WIDTH, 1)  # 2 whole batches of 5 snippets
    for key in ("depth", "pose"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-4, atol=1e-5, err_msg=key)
    for key in ("image", "depth_gt", "pose_gt", "intrinsic"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # a depth net built with the Config's interpolation predicts otherwise
    bilinear = ModelFactory(keys, RIGID, upsample_interp=interp, device="cpu").get_model()
    load_flax_variables(bilinear, variables)
    with torch.no_grad(), full_f32():
        feats = {"image5d": torch.from_numpy(got["image"][:2, None].repeat(5, 1)) * (2 / 255)
                 - 1.0}
        other = bilinear.eval()(feats)["depth_ms"][0].numpy()
        nearest = model.eval()(feats)["depth_ms"][0].numpy()
    assert np.abs(other - nearest).max() > 1e-3
    teval.evaluate_by_plan(cfg)
    jeval.evaluate_npz(tmp_path / "prediction" / "jrun" / "kitti_raw_latest.npz",
                       tmp_path / "jax_eval", "kitti_raw_latest")
    ours = (tmp_path / "evaluation" / "run" / "summary_kitti_raw_latest.csv").read_text()
    theirs = (tmp_path / "jax_eval" / "summary_kitti_raw_latest.csv").read_text()
    assert ours.splitlines()[0] == theirs.splitlines()[0]
    for a, b in zip(ours.strip().splitlines()[1:], theirs.strip().splitlines()[1:]):
        name, value = a.split(",")
        assert b.split(",")[0] == name
        np.testing.assert_allclose(float(value), float(b.split(",")[1]), rtol=1e-3, atol=1e-5,
                                   err_msg=name)
