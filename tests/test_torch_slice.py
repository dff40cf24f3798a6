"""The port's rigid predict and eval steps against the JAX package, and the
guards that keep the port free of JAX. (The train step's parity is in
test_torch_train.py.)

The slice runs at EfficientNetB0 + PoseNetImproved, batch 2, 64x128 on a
SyntheticDataset batch, with the same weights on both sides: the flax
variable tree is filled from a seeded numpy RandomState and converted by
``xpt_mde_tpu_torch.convert``. Tolerances: rtol 1e-4 (atol 1e-5) on
depth, disparity, pose and losses -- float32 on both sides through ~80
layers summed in another order; the synthesized views inside the losses
add the ~1e-5 reprojection error of test_torch_warp.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from xpt_mde_tpu.config import RIGID_NET, SCALE_WEIGHT_T1
from xpt_mde_tpu.data import SyntheticDataset
from xpt_mde_tpu.losses import loss_factory as j_loss_factory
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training import metrics as jm
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_eval_step as j_make_eval_step
from xpt_mde_tpu.training.train_step import make_predict_step as j_make_predict_step
from xpt_mde_tpu.utils import se3 as jse3
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.losses import loss_factory
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import make_eval_step, make_predict_step
from xpt_mde_tpu_torch.training import metrics as tm
from xpt_mde_tpu_torch.utils.precision import full_f32

REPO = Path(__file__).resolve().parents[1]
NETS_B0 = {"depth": "EfficientNetB0", "camera": RIGID_NET["camera"]}
RECIPE = {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0}
BATCH, HEIGHT, WIDTH = 2, 64, 128


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # four intra-op threads: the workers beside this module share the
    # cores, and the CPU's summation order stays the same on any host
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_tf32():
    # parity is checked in full float32: TF32 off for cuBLAS and cuDNN
    with full_f32():
        yield


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


@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
def test_rigid_predict_and_eval_match_jax(image_dtype):
    dataset = SyntheticDataset(batch_size=BATCH, height=HEIGHT, width=WIDTH,
                               num_batches=1, seed=3)
    keys = dataset.config_keys()
    batch = next(iter(dataset))
    if image_dtype == "uint8":  # exercises decode_image_features on both sides
        batch["image5d"] = np.round((batch["image5d"] + 1.0) * 127.5).astype(np.uint8)

    jmodel = JModelFactory(keys, NETS_B0, stereo=False).get_model()
    jfeats = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _fill(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jfeats)), seed=5)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.identity())
    jloss = j_loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False,
                           batch_size=BATCH)
    ref_preds = j_make_predict_step(jmodel)(state, jfeats)
    ref_metrics = j_make_eval_step(jmodel, jloss)(state, jfeats)

    model = ModelFactory(keys, NETS_B0, stereo=False, device="cpu").get_model()
    load_flax_variables(model, variables)
    model.train()  # the steps must switch to BN running stats and back
    tloss = loss_factory(keys, RECIPE, SCALE_WEIGHT_T1, stereo=False, batch_size=BATCH)
    tfeats = {k: torch.from_numpy(v) for k, v in batch.items()}
    preds = make_predict_step(model)(tfeats)
    metrics = make_eval_step(model, tloss)(tfeats)
    assert model.training

    for key in ("depth_ms", "disp_ms"):
        assert len(preds[key]) == 4
        for i, (r, g) in enumerate(zip(ref_preds[key], preds[key])):
            assert tuple(g.shape) == (BATCH, HEIGHT >> i, WIDTH >> i, 1)
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(preds["pose"].numpy(), np.asarray(ref_preds["pose"]),
                               rtol=1e-4, atol=1e-5)
    assert set(metrics) == {k for k in ref_metrics}
    for key in ["loss"] + [f"loss/{k}" for k in RECIPE]:
        np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    # the quality metrics: AbsRel after mean scaling is a difference of
    # nearly equal numbers, hence the absolute bound
    for key in ("depth_abs_rel", "depth_center_mean", "trj_err", "trj_rel_err", "rot_err"):
        np.testing.assert_allclose(float(metrics[key]), float(ref_metrics[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_metrics_match_jax():
    rng = np.random.RandomState(8)
    twists = rng.uniform(-0.3, 0.3, (3, 4, 6)).astype(np.float32)
    true_twists = rng.uniform(-0.3, 0.3, (3, 4, 6)).astype(np.float32)
    true = np.array(jse3.twist_to_matrix(jnp.asarray(true_twists)))
    ref = jm.pose_metrics(jnp.asarray(twists), jnp.asarray(true))
    got = tm.pose_metrics(torch.from_numpy(twists), torch.from_numpy(true))
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=1e-5, atol=1e-6)
    pred = rng.uniform(0.5, 30.0, (3, 8, 10, 1)).astype(np.float32)
    gt = rng.uniform(-5.0, 90.0, (3, 8, 10, 1)).astype(np.float32)  # invalid GT too
    np.testing.assert_allclose(
        tm.depth_abs_rel(torch.from_numpy(pred), torch.from_numpy(gt)).numpy(),
        np.asarray(jm.depth_abs_rel(jnp.asarray(pred), jnp.asarray(gt))),
        rtol=1e-5, atol=1e-6)


def test_port_runs_with_jax_blocked():
    """The port must not need JAX: import every module of the port (the
    entry scripts and tools too) and chip_smoke, then run the rigid slice
    (predict, eval and an augmented train step), the flow slice (predict
    and a regularized train step), the entry point (a one-row plan on
    shards, from a pretrained backbone file, writing its panels; predict,
    evaluate, the debug evaluator and the depth comparison) and the
    learning chain's mini_plan and check_learns at a tiny size, with
    jax/flax/optax and the JAX package itself made unimportable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu"):
            sys.modules[name] = None
        import chip_smoke
        import xpt_mde_tpu_torch
        for info in pkgutil.walk_packages(xpt_mde_tpu_torch.__path__, "xpt_mde_tpu_torch."):
            importlib.import_module(info.name)
        shard_chain = ["data.depth_map", "data.image_ops", "data.example_maker",
                       "data.shard_maker", "data.list_static_frames", "data.readers",
                       "data.readers.reader_base", "data.readers.kitti_reader",
                       "data.readers.city_reader", "data.readers.driving_reader",
                       "data.readers.a2d2_reader", "data.readers.waymo_native",
                       "data.readers.waymo_reader", "data.readers.waymo_protos.dataset_pb2",
                       "scripts.create_shards_main"]
        assert all(f"xpt_mde_tpu_torch.{m}" in sys.modules for m in shard_chain)
        # the weight and diagnostics libraries load only where they are used
        lazy = ("tensorflow", "h5py", "cv2", "matplotlib", "msgpack")
        assert not [m for m in lazy if m in sys.modules], [m for m in lazy if m in sys.modules]
        import torch
        torch.set_num_threads(2)  # the test workers beside it share the cores
        from xpt_mde_tpu_torch.config import AUGMENT_PROBS, FLOW_NET, SCALE_WEIGHT_T1
        from xpt_mde_tpu_torch.data import SyntheticDataset
        from xpt_mde_tpu_torch.losses import loss_factory
        from xpt_mde_tpu_torch.models import ModelFactory
        from xpt_mde_tpu_torch.training import (augmentation_factory, make_eval_step,
                                                make_predict_step, make_train_step,
                                                optimizer_factory)
        ds = SyntheticDataset(batch_size=1, height=32, width=64, num_batches=1)
        keys = ds.config_keys()
        model = ModelFactory(keys, {"depth": "EfficientNetB0",
                                    "camera": "PoseNetImproved"}, stereo=False,
                             device="cpu").get_model()
        loss = loss_factory(keys, {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0},
                            SCALE_WEIGHT_T1, stereo=False, batch_size=1)
        feats = {k: torch.from_numpy(v) for k, v in next(iter(ds)).items()}
        preds = make_predict_step(model)(feats)
        metrics = make_eval_step(model, loss)(feats)
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        assert tuple(preds["depth_ms"][0].shape) == (1, 32, 64, 1)
        step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model),
                               augmenter=augmentation_factory(AUGMENT_PROBS))
        weight = model.posenet.Conv_0.Conv_0.weight.detach().clone()
        metrics = step(feats, torch.Generator().manual_seed(0))
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        assert not torch.equal(weight, model.posenet.Conv_0.Conv_0.weight)
        flow_ds = SyntheticDataset(batch_size=1, height=64, width=128, num_batches=1)
        flow_feats = {k: torch.from_numpy(v) for k, v in next(iter(flow_ds)).items()}
        flow_model = ModelFactory(keys, FLOW_NET, stereo=False, device="cpu").get_model()
        flow_ms = make_predict_step(flow_model)(flow_feats)["flow_ms"]
        assert [tuple(f.shape) for f in flow_ms] == [
            (1, 4, 64 >> s, 128 >> s, 2) for s in (2, 3, 4, 5)]
        flow_loss = loss_factory(keys, {"flowL2": 1.0, "flow_reg": 4e-7}, SCALE_WEIGHT_T1,
                                 stereo=False, batch_size=1)
        flow_step = make_train_step(flow_model, flow_loss,
                                    optimizer_factory("adam_constant", 1e-4, flow_model),
                                    regularize_net="flownet")
        metrics = flow_step(flow_feats)
        assert set(metrics) == {"loss", "loss/flowL2", "loss/flow_reg"}
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        # the entry point: shards, a one-row plan, predict, evaluate
        import tempfile
        from pathlib import Path
        from xpt_mde_tpu_torch.config import Config, TestStage, TrainStage
        from xpt_mde_tpu_torch.evaluate.evaluate_main import evaluate_by_plan, predict_by_plan
        from xpt_mde_tpu_torch.scripts import evaluate_main, train_main
        from xpt_mde_tpu_torch.training.trainer import train_by_plan
        assert train_main.load_user_config().compute_dtype == "bfloat16"  # Config()
        assert callable(train_main.main) and callable(evaluate_main.main)
        rigid = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
        with tempfile.TemporaryDirectory() as root:
            chip_smoke.write_synthetic_shards(Path(root) / "shards", 32, 64,
                                              {"train": 1, "test": 1})
            # a pretrained backbone file (the flax layout), which the row starts from
            import contextlib, io
            from xpt_mde_tpu_torch.convert import state_dict_to_flax
            from xpt_mde_tpu_torch.scripts import convert_backbone_weights
            seeded = ModelFactory(keys, rigid, stereo=False, device="cpu", seed=5).get_model()
            tree = state_dict_to_flax(seeded.depthnet.backbone)
            pre = convert_backbone_weights.write_pretrained(tree["params"], tree["batch_stats"],
                                                            root, "EfficientNetB0")
            cfg = Config(stereo=False, per_replica_batch=1, datapath=root,
                         compute_dtype="float32",
                         training_plan=[TrainStage(rigid, "synthetic", 1, 1e-4,
                                                   {"L1": 1.0}, SCALE_WEIGHT_T1)],
                         test_plan=[TestStage(rigid, "synthetic", ["depth"], "mde01")])
            assert cfg.pretrained_weight
            with contextlib.redirect_stdout(io.StringIO()) as log:
                train_by_plan(cfg, device="cpu")
            assert f"loaded pretrained backbone from {pre}" in log.getvalue(), log.getvalue()
            ckpt = Path(cfg.datapath_ckp) / cfg.ckpt_name
            assert (ckpt / "reconstruction" / "ep000_0.png").is_file()
            assert (ckpt / "history.png").is_file()
            predict_by_plan(cfg, device="cpu")
            evaluate_by_plan(cfg)
            summary = Path(root, "evaluation", "mde01", "summary_synthetic_latest.csv")
            assert "abs_rel" in summary.read_text()
            # the debug evaluator and the depth comparison from their scripts
            from xpt_mde_tpu_torch.scripts import compare_depth_main, evaluate_debug_main
            train_main.load_user_config = lambda: cfg
            evaluate_debug_main.main(device="cpu")
            compare_depth_main.main()
            debug = Path(root, "evaluation", "mde01", "debug_synthetic_latest")
            assert (debug / "debug_pose.csv").is_file() and list(debug.glob("worst_*/*.png"))
            assert Path(root, "evaluation", "mde01", "depth_compare_synthetic",
                        "compare_00000.png").is_file()
            # the learning chain: the mini plan's nets and evaluation on both
            # worlds, the results ledger, and the check's command line, which
            # refuses to run without a card
            import math
            from xpt_mde_tpu_torch.tools import check_learns
            from xpt_mde_tpu_torch.training import mini_plan as mp
            from xpt_mde_tpu_torch.utils import results
            cfg = mp.make_config(root, mp.miniature_plan(1, 1, 1), batch=1)
            for factory in (mp.synthetic_factory(1, 1), mp.planar_factory(1, 1)):
                init = mp.evaluate_checkpoint(cfg, mp.RIGID_NETS,
                                              factory("synthetic_small", "val", 1),
                                              restore=False, device="cpu")
                assert all(math.isfinite(v) for v in init.values()), init
            results.record("plan_learns", {"init_abs_rel": init["abs_rel"]}, "float32",
                           Path(root, "results.jsonl"))
            assert check_learns.main(["--check", "plan"]) == 1
        assert all(sys.modules.get(m) is None
                   for m in ("jax", "flax", "optax", "xpt_mde_tpu"))
        print("JAX-FREE OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "JAX-FREE OK" in proc.stdout


def test_shards_made_and_trained_with_jax_and_opencv_blocked():
    """The card machine's situation: with jax/flax/optax, the JAX package,
    OpenCV and PIL all unimportable, the port's ``create_shards_main``
    builds synthetic shards (its ``user_config`` given as a module), and a
    rigid row trains one step on them through ``train_by_plan`` on the
    CPU."""
    code = textwrap.dedent("""
        import sys, types
        for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu", "cv2", "PIL"):
            sys.modules[name] = None
        import tempfile
        from pathlib import Path
        import torch
        torch.set_num_threads(2)  # the test workers beside it share the cores
        from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1, Config, TrainStage
        from xpt_mde_tpu_torch.data.shard_io import ShardDataset
        from xpt_mde_tpu_torch.scripts import create_shards_main
        from xpt_mde_tpu_torch.training.trainer import train_by_plan
        rigid = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
        with tempfile.TemporaryDirectory() as root:
            user_config = types.ModuleType("xpt_mde_tpu_torch.scripts.user_config")
            user_config.cfg = Config(
                stereo=False, per_replica_batch=2, datapath=root, pretrained_weight=False,
                compute_dtype="float32", image_size_overrides={"synthetic": (32, 64)},
                training_plan=[TrainStage(rigid, "synthetic", 1, 1e-4,
                                          {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0},
                                          SCALE_WEIGHT_T1)])
            user_config.RAW_DATA_PATHS = {"synthetic": {"drives": 1, "num_frames": 6,
                                                        "height": 32, "width": 64}}
            sys.modules["xpt_mde_tpu_torch.scripts.user_config"] = user_config
            assert create_shards_main.main() == {"synthetic_train": "serial"}
            shards = Path(root, "shards")
            assert sorted(p.name for p in shards.iterdir()) == ["synthetic_train",
                                                                 "synthetic_val"]
            train = ShardDataset(shards / "synthetic_train")
            assert len(train) == 2 and train.read_example(0)["image"].shape == (5 * 32, 64, 3)
            train_by_plan(user_config.cfg, device="cpu")
            history = Path(root, "checkpts", "mde01", "history.csv").read_text()
            assert len(history.strip().splitlines()) == 2, history
        assert all(sys.modules.get(m) is None
                   for m in ("jax", "flax", "optax", "xpt_mde_tpu", "cv2", "PIL"))
        print("SHARDS WITHOUT JAX OR OPENCV OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SHARDS WITHOUT JAX OR OPENCV OK" in proc.stdout


def test_stereo_path_runs_with_jax_blocked():
    """The stereo path without JAX: an augmented stereo train step under
    the MS recipe, then a three-row stereo plan (flow, rigid and joint
    rows of the published stereo recipes) on stereo shards in the
    kitti_raw schema, predict and evaluate, at a tiny size, with
    jax/flax/optax and the JAX package made unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu"):
            sys.modules[name] = None
        import tempfile
        from pathlib import Path
        import torch
        torch.set_num_threads(2)  # the test workers beside it share the cores
        import chip_smoke
        from xpt_mde_tpu_torch.config import (AUGMENT_PROBS, LOSS_FLOW, LOSS_RIGID_COMB,
                                              LOSS_RIGID_T2, SCALE_WEIGHT_T1, Config,
                                              TestStage, TrainStage)
        from xpt_mde_tpu_torch.data import SyntheticDataset
        from xpt_mde_tpu_torch.evaluate.evaluate_main import evaluate_by_plan, predict_by_plan
        from xpt_mde_tpu_torch.losses import loss_factory
        from xpt_mde_tpu_torch.models import ModelFactory
        from xpt_mde_tpu_torch.tools import profile_steps
        from xpt_mde_tpu_torch.training import (augmentation_factory, make_train_step,
                                                optimizer_factory)
        from xpt_mde_tpu_torch.training.trainer import train_by_plan
        rigid = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
        ds = SyntheticDataset(batch_size=1, height=32, width=64, num_batches=1, stereo=True)
        keys = ds.config_keys()
        model = ModelFactory(keys, rigid, device="cpu").get_model()
        loss = loss_factory(keys, profile_steps.STEREO_RECIPE, SCALE_WEIGHT_T1, batch_size=1)
        step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model),
                               augmenter=augmentation_factory(AUGMENT_PROBS))
        feats = {k: torch.from_numpy(v) for k, v in next(iter(ds)).items()}
        metrics = step(feats, torch.Generator().manual_seed(0))
        assert {"loss/stereoL1", "loss/stereoSSIM", "loss/stereoPose", "loss/L1_R"} <= set(metrics)
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        joint = dict(rigid, flow="PWCNet")
        with tempfile.TemporaryDirectory() as root:
            chip_smoke.write_stereo_shards(Path(root) / "shards", 64, 128,
                                           {"train": 1, "test": 1})
            plan = [TrainStage({"flow": "PWCNet"}, "kitti_raw", 1, 1e-4, LOSS_FLOW,
                               SCALE_WEIGHT_T1),
                    TrainStage(rigid, "kitti_raw", 1, 1e-4, LOSS_RIGID_T2, SCALE_WEIGHT_T1),
                    TrainStage(joint, "kitti_raw", 1, 1e-4, LOSS_RIGID_COMB, SCALE_WEIGHT_T1)]
            cfg = Config(per_replica_batch=1, datapath=root, pretrained_weight=False,
                         compute_dtype="float32", training_plan=plan,
                         test_plan=[TestStage(joint, "kitti_raw", ["depth", "pose"], "mde01")])
            train_by_plan(cfg, device="cpu")
            predict_by_plan(cfg, device="cpu")
            evaluate_by_plan(cfg)
            summary = Path(root, "evaluation", "mde01", "summary_kitti_raw_latest.csv")
            assert "trj_abs_err" in summary.read_text()
        assert all(sys.modules.get(m) is None
                   for m in ("jax", "flax", "optax", "xpt_mde_tpu"))
        print("STEREO JAX-FREE OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "STEREO JAX-FREE OK" in proc.stdout


def test_bf16_path_runs_with_jax_blocked():
    """The default compute dtype without JAX: an augmented bfloat16 rigid
    train step and a bfloat16 flow train step (the bfloat16 cost volume on
    the CPU), then ``train_by_plan`` at the default ``Config()`` (bfloat16)
    over a flow and a joint row on shards, predict and evaluate: the
    parameters stay float32 and the predictions are float32, at a tiny
    size, with jax/flax/optax and the JAX package made unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu"):
            sys.modules[name] = None
        import tempfile
        from pathlib import Path
        import numpy as np
        import torch
        torch.set_num_threads(2)  # the test workers beside it share the cores
        import chip_smoke
        from xpt_mde_tpu_torch.config import (AUGMENT_PROBS, FLOW_NET, SCALE_WEIGHT_T1,
                                              Config, TestStage, TrainStage)
        from xpt_mde_tpu_torch.data import SyntheticDataset
        from xpt_mde_tpu_torch.evaluate.evaluate_main import evaluate_by_plan, predict_by_plan
        from xpt_mde_tpu_torch.losses import loss_factory
        from xpt_mde_tpu_torch.models import ModelFactory
        from xpt_mde_tpu_torch.training import (augmentation_factory, make_train_step,
                                                optimizer_factory)
        from xpt_mde_tpu_torch.training.trainer import train_by_plan
        assert Config().compute_dtype == "bfloat16"
        rigid = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
        ds = SyntheticDataset(batch_size=1, height=64, width=128, num_batches=1)
        keys = ds.config_keys()
        feats = {k: torch.from_numpy(v) for k, v in next(iter(ds)).items()}
        for nets, recipe, reg, aug in ((rigid, {"L1": 0.5, "SSIM": 0.5, "smoothe": 20.0},
                                        None, augmentation_factory(AUGMENT_PROBS)),
                                       (FLOW_NET, {"flowL2": 1.0, "flow_reg": 4e-7},
                                        "flownet", None)):
            model = ModelFactory(keys, nets, stereo=False, compute_dtype="bfloat16",
                                 device="cpu").get_model()
            loss = loss_factory(keys, recipe, SCALE_WEIGHT_T1, stereo=False, batch_size=1)
            step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model),
                                   augmenter=aug, regularize_net=reg)
            before = [p.detach().clone() for p in model.parameters()]
            metrics = step(feats, torch.Generator().manual_seed(0))
            assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
            assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
                       for p in model.parameters() if p.grad is not None)
            assert any(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
        joint = dict(rigid, **FLOW_NET)
        with tempfile.TemporaryDirectory() as root:
            chip_smoke.write_synthetic_shards(Path(root) / "shards", 64, 128,
                                              {"train": 1, "test": 1})
            plan = [TrainStage(FLOW_NET, "synthetic", 1, 1e-4, {"flowL2": 1.0},
                               SCALE_WEIGHT_T1),
                    TrainStage(joint, "synthetic", 1, 1e-4, {"cmbL1": 1.0, "smoothe": 1.0},
                               SCALE_WEIGHT_T1)]
            cfg = Config(stereo=False, per_replica_batch=1, datapath=root,
                         pretrained_weight=False, training_plan=plan,
                         test_plan=[TestStage(joint, "synthetic", ["depth", "pose"], "mde01")])
            train_by_plan(cfg, device="cpu")
            predict_by_plan(cfg, device="cpu")
            pred = np.load(Path(root, "prediction", "mde01", "synthetic_latest.npz"))
            assert pred["depth"].dtype == np.float32 and pred["pose"].dtype == np.float32
            evaluate_by_plan(cfg)
            summary = Path(root, "evaluation", "mde01", "summary_synthetic_latest.csv")
            assert "abs_rel" in summary.read_text()
        assert all(sys.modules.get(m) is None
                   for m in ("jax", "flax", "optax", "xpt_mde_tpu"))
        print("BF16 JAX-FREE OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "BF16 JAX-FREE OK" in proc.stdout


def test_zoo_runs_with_jax_blocked():
    """The model zoo without JAX: a bfloat16 stereo train step of an
    Xception depth net (its backbone checkpointed) and a MobileNetV2
    PoseNetPreTrained under LOSS_RIGID_MOA_WST, in two accumulated
    microbatches, at a tiny size, with jax/flax/optax and the JAX package
    made unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu"):
            sys.modules[name] = None
        import torch
        torch.set_num_threads(2)  # the test workers beside it share the cores
        from xpt_mde_tpu_torch.config import LOSS_RIGID_MOA_WST, SCALE_WEIGHT_T1
        from xpt_mde_tpu_torch.data import SyntheticDataset
        from xpt_mde_tpu_torch.losses import loss_factory
        from xpt_mde_tpu_torch.models import ModelFactory
        from xpt_mde_tpu_torch.training import make_train_step, optimizer_factory
        # 64x128: PoseNetPreTrained max-pools the stride-32 map 2x2
        ds = SyntheticDataset(batch_size=2, height=64, width=128, num_batches=1, stereo=True)
        keys = ds.config_keys()
        model = ModelFactory(keys, {"depth": "Xception", "camera": "MobileNetV2"},
                             compute_dtype="bfloat16", device="cpu",
                             remat_backbone=True).get_model()
        assert type(model.posenet).__name__ == "PoseNetPreTrained"
        loss = loss_factory(keys, LOSS_RIGID_MOA_WST, SCALE_WEIGHT_T1, batch_size=2)
        step = make_train_step(model, loss, optimizer_factory("adam_constant", 1e-4, model),
                               grad_accum_steps=2)
        before = [p.detach().clone() for p in model.parameters()]
        metrics = step({k: torch.from_numpy(v) for k, v in next(iter(ds)).items()})
        assert {"loss/moaL1", "loss/moaSSIM_R", "loss/stereoL1"} <= set(metrics)
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters())
                   if p.grad is not None)
        assert all(sys.modules.get(m) is None
                   for m in ("jax", "flax", "optax", "xpt_mde_tpu"))
        print("ZOO JAX-FREE OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ZOO JAX-FREE OK" in proc.stdout


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = chip_smoke.main()
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out


SCALE_OUT_DRIVER = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(2)  # the test workers beside it share the cores
from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1, Config, TestStage, TrainStage

NETS = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}


def cfg(root, world):
    return Config(stereo=False, per_replica_batch=4 // world, mesh_shape={"data": world},
                  datapath=root, ckpt_name="so", pretrained_weight=False,
                  compute_dtype="float32", loader_workers=1,
                  training_plan=[TrainStage(NETS, "synthetic", 1, 1e-4, {"L1": 1.0},
                                            SCALE_WEIGHT_T1)],
                  test_plan=[TestStage(NETS, "synthetic", ["depth"], "so")])


def serve_and_step(root):
    from xpt_mde_tpu_torch.scripts import export_serving_main
    from xpt_mde_tpu_torch.serving import load_predictor
    from xpt_mde_tpu_torch.tools import ddp_check

    written = export_serving_main.main(cfg(root, 1), device="cpu")
    assert [p.name for p in written] == ["serving_synthetic_latest"], written
    assert export_serving_main.main(cfg(root, 1), device="cpu") == []  # exists: skipped
    predictor = load_predictor(written[0])
    spec = predictor.meta["input_spec"]
    assert spec["image5d"]["dtype"] == "uint8" and spec["image5d"]["shape"][0] == 4
    feats = {k: np.zeros(v["shape"], v["dtype"]) for k, v in spec.items()}
    assert bool(torch.isfinite(predictor(feats)["depth_ms"][0]).all())
    case = ddp_check.b0_case(batch=4, height=64, width=128)
    distances = ddp_check.compare(ddp_check.single_step(case), ddp_check.ddp_steps(
        [case], 2, "cpu", workdir=root)[0])
    assert distances["loss"] <= 1e-5 and distances["replicas"] == 0.0, distances
    assert all(sys.modules.get(m) is None for m in ("jax", "flax", "optax", "xpt_mde_tpu"))
    print("SCALE-OUT JAX-FREE OK")


if __name__ == "__main__":
    if sys.argv[2] == "train":  # under torchrun
        from xpt_mde_tpu_torch.scripts import train_main
        train_main.main(cfg(sys.argv[1], 2), device_type="cpu")
        assert all(sys.modules.get(m) is None for m in ("jax", "xpt_mde_tpu"))
    else:
        serve_and_step(sys.argv[1])
"""


def test_scale_out_and_serving_run_with_jax_blocked(tmp_path):
    """``train_main`` under torchrun with two gloo ranks on the CPU (a
    one-row plan at 64x128, then predict_by_plan on rank 0), then
    ``export_serving_main`` from its checkpoint, the artifact loaded and
    run, and ``tools/ddp_check.py``'s two-rank step against one process,
    all with jax/flax/optax and the JAX package made unimportable."""
    chip_smoke.write_synthetic_shards(tmp_path / "shards", 64, 128,
                                      {"train": 8, "val": 4, "test": 4})
    driver = tmp_path / "driver.py"
    driver.write_text(SCALE_OUT_DRIVER)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node=2", str(driver), str(tmp_path), "train"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    ckpt = tmp_path / "checkpts" / "so"
    assert (ckpt / "history.csv").read_text().count("\n") == 2  # the header and epoch 0
    assert (tmp_path / "prediction" / "so" / "synthetic_latest.npz").exists()
    proc = subprocess.run([sys.executable, str(driver), str(tmp_path), "serve"], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    shutil.rmtree(tmp_path / "checkpts")  # ~0.3 GB of checkpoints
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SCALE-OUT JAX-FREE OK" in proc.stdout
