"""Diagnostics out of the port against the JAX package: the logger's loss
plot and reconstruction panels (``training/logger.py``), the debug
evaluator (``evaluate/evaluate_debug.py``), the viewers
(``evaluate/visualize.py``, ``data/viewer.py``) and the trainer writing
the panels each epoch.

The same numpy inputs go to both packages. Tolerances: whatever is
computed in numpy or OpenCV from the same arrays (flow images, titled
stacks, viewer panels, comparison and worst-frame pngs, the npz debug
CSVs) byte for byte; the model-driven debug quantities (float32 on both
sides, means over pixels) within rtol 1e-5, atol 1e-5, the geometry
tests' bound, with the integer columns and the worst-frame lists equal
wherever the scores are apart by more than that; the synthesized views
pixel by pixel within rtol 1e-5, atol 5e-5, as tests/test_torch_warp.py
holds synthesis: reprojected coordinates of 10-60 px carry ~1e-6
relative, and a random texture changes by up to 2 a pixel.
"""

import contextlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_logger import _fake_features_preds
from test_torch_evaluate import _fill, _predictions
from xpt_mde_tpu.data import SyntheticDataset as JSyntheticDataset
from xpt_mde_tpu.data import viewer as jviewer
from xpt_mde_tpu.evaluate import evaluate_debug as jdebug
from xpt_mde_tpu.evaluate import visualize as jvisualize
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training import logger as jlogger
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import make_predict_step as j_make_predict_step
from xpt_mde_tpu.utils import se3 as jse3
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.data import viewer as tviewer
from xpt_mde_tpu_torch.evaluate import evaluate_debug as tdebug
from xpt_mde_tpu_torch.evaluate import visualize as tvisualize
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import logger as tlogger
from xpt_mde_tpu_torch.training import make_predict_step

cv2 = pytest.importorskip("cv2")

TOL = dict(rtol=1e-5, atol=1e-5)
VIEW_TOL = dict(rtol=1e-5, atol=5e-5)
NETS = {"depth": "DepthNetBasic", "camera": "PoseNetImproved"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the test workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_flow_to_image_and_stack_are_the_jax_ones():
    flow = np.random.RandomState(0).uniform(-14, 14, (8, 16, 2)).astype(np.float32)
    flow[0, 0] = (10, 0)
    flow[1, 1] = (-10, 5)
    assert np.array_equal(tlogger.flow_to_image(flow), jlogger.flow_to_image(flow))
    rng = np.random.RandomState(1)
    views = {"a": rng.uniform(-1.2, 1.2, (16, 32, 3)).astype(np.float32),
             "flow": tlogger.flow_to_image(flow), "c": rng.uniform(-1, 1, (3, 8, 3))}
    ours, theirs = tlogger.stack_titled_images(views), jlogger.stack_titled_images(views)
    assert ours.dtype == np.uint8 and ours.shape[1] == 32
    assert ours.tobytes() == theirs.tobytes()


_JAX_VIEWS = {}


@pytest.mark.parametrize("kind", ["rigid", "joint and stereo"])
@pytest.mark.parametrize("as_tensors", [False, True])
def test_reconstruction_views_match_jax(kind, as_tensors):
    feats, preds = _fake_features_preds(stereo=kind != "rigid", flow=kind != "rigid")
    if "joint and stereo" not in _JAX_VIEWS:  # the JAX views run eagerly: once
        _JAX_VIEWS["joint and stereo"] = jlogger._reconstruction_views(
            *_fake_features_preds(stereo=True, flow=True))
    ref = _JAX_VIEWS["joint and stereo"]
    if kind == "rigid":  # the same inputs' first four views
        ref = {name: ref[name] for name in ("left_target", "target_depth", "source_0",
                                            "synthesized_from_src0")}
    if as_tensors:  # what the trainer passes
        feats = {k: torch.from_numpy(v) for k, v in feats.items()}
        preds = {k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                 else torch.from_numpy(v) for k, v in preds.items()}
    ours = tlogger._reconstruction_views(feats, preds)
    assert list(ours) == list(ref)
    for name, view in ref.items():
        assert ours[name].shape == view.shape and ours[name].dtype == np.float32, name
        np.testing.assert_allclose(ours[name], np.asarray(view), err_msg=name, **VIEW_TOL)


def test_reconstruction_samples_and_history_plot(tmp_path):
    feats, preds = _fake_features_preds(stereo=True, flow=True)
    for root, logger in ((tmp_path / "jax", jlogger.TrainingLogger(tmp_path / "jax")),
                         (tmp_path / "port", tlogger.TrainingLogger(tmp_path / "port"))):
        logger.save_reconstruction_samples(3, feats, preds, num=2)
        logger.save_log(0, {"loss": 1.0}, {})
        logger.save_log(1, {"loss": 0.9}, {"loss": 0.8})
    for i in range(2):
        ours = cv2.imread(str(tmp_path / "port" / "reconstruction" / f"ep003_{i}.png"))
        theirs = cv2.imread(str(tmp_path / "jax" / "reconstruction" / f"ep003_{i}.png"))
        assert ours.shape == theirs.shape == (8 * (12 + 32), 64, 3)
        # uint8 of views 1e-5 apart: a count rounds the other way at most
        assert np.abs(ours.astype(int) - theirs).max() <= 1
    plot = cv2.imread(str(tmp_path / "port" / "history.png"))
    assert plot.shape == (400, 640, 3)
    # a flow-only row has no depth: no panel, as in the JAX logger
    tlogger.TrainingLogger(tmp_path / "flow").save_reconstruction_samples(
        0, feats, {"flow_ms": preds["flow_ms"]})
    assert not (tmp_path / "flow" / "reconstruction").exists() or \
        not any((tmp_path / "flow" / "reconstruction").iterdir())


def test_npz_debug_and_viewers_are_the_jax_ones(tmp_path):
    npz = tmp_path / "pred.npz"
    results = _predictions(3, n=6)
    np.savez(npz, **results)
    ours = tdebug.evaluate_npz_debug(npz, tmp_path / "port" / "debug", worst_n=3)
    theirs = jdebug.evaluate_npz_debug(npz, tmp_path / "jax" / "debug", worst_n=3)
    assert ours["worst"] == theirs["worst"] and "abs_rel" in ours["worst"]
    assert ours["rows"] == theirs["rows"]
    tvisualize.compare_depths(npz, tmp_path / "port" / "cmp", stride=2,
                              external_disparities={"other": results["depth_gt"][..., 0]})
    jvisualize.compare_depths(npz, tmp_path / "jax" / "cmp", stride=2,
                              external_disparities={"other": results["depth_gt"][..., 0]})
    tdebug._dump_frames(results, [0, 5], tmp_path / "port" / "frames")
    jdebug._dump_frames(results, [0, 5], tmp_path / "jax" / "frames")
    ours_files, theirs_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert "debug/debug_metrics.csv" in ours_files and "cmp/compare_00004.png" in ours_files
    assert len([f for f in ours_files if f.startswith("debug/worst_abs_rel/")]) == 3
    assert ours_files == theirs_files
    no_depth = np.zeros_like(results["depth"][4])  # every disparity invalid
    assert tvisualize.colormap_disparity(no_depth).tobytes() == \
        jvisualize.colormap_disparity(no_depth).tobytes()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        assert tvisualize.visualize_point_cloud(npz) is None  # no open3d here
    assert "open3d not installed" in log.getvalue()


@pytest.mark.parametrize("decoded", [False, True])
def test_show_example_is_the_jax_one(tmp_path, decoded):
    rng = np.random.RandomState(4)
    example = {"image": rng.randint(0, 256, (5 * 16, 32, 3)).astype(np.uint8),
               "image_R": rng.randint(0, 256, (5 * 16, 32, 3)).astype(np.uint8),
               "depth_gt": rng.uniform(0, 70, (16, 32, 1)).astype(np.float32),
               "intrinsic": np.eye(3, dtype=np.float32),
               "pose_gt": jse3.twist_to_matrix_np(rng.uniform(-0.2, 0.2, (4, 6)))}
    example["depth_gt"][0, :5] = 0.0
    if decoded:  # a loader row: [S, H, W, 3] floats in [-1, 1]
        for key in ("image", "image_R"):
            example[key] = example[key].reshape(5, 16, 32, 3) / 127.5 - 1.0
    kwargs = dict(print_param=True, max_height=64, suffix="_x")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        ours = tviewer.show_example(example, save_dir=tmp_path / "port", **kwargs)
    theirs = jviewer.show_example(example, save_dir=tmp_path / "jax", **kwargs)
    assert list(ours) == list(theirs) == ["image_x", "image_R_x", "depth_x"]
    for name, panel in theirs.items():
        assert ours[name].tobytes() == panel.tobytes(), name
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    assert "pose" in log.getvalue()
    assert tviewer.apply_color_map(example["depth_gt"]).tobytes() == \
        jviewer.apply_color_map(example["depth_gt"]).tobytes()


def _same_worst(ours: dict, theirs: dict, rows: list, col: int):
    """The worst-frame lists agree wherever the scores decide them: a
    difference is allowed only between frames whose scores tie within TOL."""
    assert set(ours) == set(theirs)
    for key in theirs:
        if ours[key] == theirs[key]:
            continue
        score = {}
        for r in rows[key]:
            score[r[0]] = max(score.get(r[0], -np.inf), r[col[key]])
        for a, b in zip(ours[key], theirs[key]):
            assert np.isclose(score[a], score[b], **TOL), (key, a, b)


def _csv(path: Path):
    lines = path.read_text().strip().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split(",")] for ln in lines[1:]])


def test_model_driven_debug_evaluator_matches_jax(tmp_path):
    """evaluate_for_debug and inspect_batches on the same weights (the flax
    variables converted) and the same synthetic batches as
    tests/test_predict_evaluate.py runs the JAX package."""
    batches = list(JSyntheticDataset(batch_size=2, height=32, width=64, num_batches=2, seed=1))
    jmodel = JModelFactory(list(batches[0]), NETS, stereo=False,
                           compute_dtype="float32").get_model()
    jbatch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jbatch)), 7)
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables.get("batch_stats"), tx=optax.identity())
    j_predict = j_make_predict_step(jmodel)
    ref = jdebug.evaluate_for_debug(state, batches, j_predict, tmp_path / "jax", worst_n=2)

    model = ModelFactory(list(batches[0]), NETS, stereo=False, device="cpu").get_model()
    load_flax_variables(model, variables)
    predict = make_predict_step(model)
    out = tdebug.evaluate_for_debug(model, batches, predict, tmp_path / "port", worst_n=2)

    assert len(out["depth_rows"]) == 4 and len(out["pose_rows"]) == 16
    for table in ("depth_rows", "pose_rows"):
        ours, theirs = np.array(out[table]), np.array(ref[table])
        n_int = 2 if table == "pose_rows" else 1
        np.testing.assert_array_equal(ours[:, :n_int], theirs[:, :n_int])
        np.testing.assert_allclose(ours[:, n_int:], theirs[:, n_int:], **TOL)
    _same_worst(out["worst"], ref["worst"],
                {"smooth_loss": out["depth_rows"], "depth_err": out["depth_rows"],
                 "photo_loss": out["pose_rows"], "trj_err": out["pose_rows"],
                 "rot_err": out["pose_rows"]},
                {"smooth_loss": 1, "depth_err": 2, "photo_loss": 2, "trj_err": 3,
                 "rot_err": 5})
    for name in ("debug_depth.csv", "debug_pose.csv", "trajectory.csv"):
        (h_ours, v_ours), (h_ref, v_ref) = (_csv(tmp_path / "port" / name),
                                            _csv(tmp_path / "jax" / name))
        assert h_ours == h_ref and v_ours.shape == v_ref.shape, name
        n_int = 2 if "srcidx" in h_ref else 1
        np.testing.assert_array_equal(v_ours[:, :n_int], v_ref[:, :n_int])
        np.testing.assert_allclose(v_ours[:, n_int:], v_ref[:, n_int:], **TOL)
    for key, frames in out["worst"].items():
        pngs = sorted((tmp_path / "port" / f"worst_{key}").glob("frame_*.png"))
        assert [p.name for p in pngs] == sorted(f"frame_{f:05d}.png" for f in frames)
        panel = cv2.imread(str(pngs[0]))
        assert panel.shape == (5 * 32, 64, 3)  # target, GT-pose synthesis, synthesis, source, depth

    with contextlib.redirect_stdout(io.StringIO()):
        rows = tdebug.inspect_batches(model, batches, predict, max_batches=1)
        ref_rows = jdebug.inspect_batches(state, batches, j_predict, max_batches=1)
    assert list(rows[0]) == list(ref_rows[0])
    for key, value in ref_rows[0].items():
        np.testing.assert_allclose(rows[0][key], value, err_msg=key, **TOL)


def test_visualize_and_compare_scripts_read_the_test_plan(tmp_path, monkeypatch):
    from xpt_mde_tpu_torch.config import Config, TestStage
    from xpt_mde_tpu_torch.scripts import compare_depth_main, train_main, visualize_main

    rigid = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
    cfg = Config(datapath=str(tmp_path), test_plan=[TestStage(rigid, "synthetic", ["depth"], "a"),
                                                    TestStage(rigid, "synthetic", ["depth"], "b")])
    results = _predictions(5, n=3)
    (tmp_path / "prediction" / "a").mkdir(parents=True)
    np.savez(tmp_path / "prediction" / "a" / "synthetic_latest.npz", **results)
    np.save(tmp_path / "other.npy", results["depth_gt"][..., 0])
    cfg.external_disparities = {"other": str(tmp_path / "other.npy")}
    monkeypatch.setattr(train_main, "load_user_config", lambda: cfg)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        visualize_main.main()
        compare_depth_main.main()
    out = log.getvalue()
    assert "open3d not installed" in out and "no predictions" in out
    panel = cv2.imread(str(tmp_path / "evaluation" / "a" / "depth_compare_synthetic"
                           / "compare_00000.png"))
    assert panel.shape == (3 * 64, 128, 3)  # image, ours, the .npy method's disparity
