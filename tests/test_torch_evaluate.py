"""The port's evaluation: the Eigen depth metrics and snippet pose errors
(numpy copies of the JAX package's) against the reference goldens, the
npz evaluator against the JAX package's on the same predictions, chunked
against monolithic predictions, and ``predict_by_plan`` against the JAX
predict step at the same weights.

The copies compute the same float64 numpy as the originals: exact
equality where the code is the same, the goldens' own 1e-6 against the
reference. Predictions: rtol 1e-4, atol 1e-5, as test_torch_models.py
holds whole nets (float32 through ~100 layers in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from xpt_mde_tpu.data.shard_io import DatasetLoader as JDatasetLoader
from xpt_mde_tpu.data.shard_io import ShardDataset as JShardDataset
from xpt_mde_tpu.evaluate import evaluate_main as jeval
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training.train_step import TrainState
from xpt_mde_tpu.training.train_step import decode_image_features as j_decode
from xpt_mde_tpu.training.train_step import make_predict_step as j_make_predict_step
from xpt_mde_tpu.utils import se3 as jse3
from xpt_mde_tpu_torch.config import Config, TestStage
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.data import SyntheticDataset
from xpt_mde_tpu_torch.evaluate import evaluate_main as teval
from xpt_mde_tpu_torch.evaluate.depth_metrics import compute_depth_metrics, valid_depth_filter
from xpt_mde_tpu_torch.evaluate.pose_metrics import PoseMetric, twist_to_matrix_np
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import make_predict_step, optimizer_factory
from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager
from xpt_mde_tpu_torch.utils.precision import full_f32

GOLDEN = Path(__file__).parent / "fixtures" / "eval_golden.npz"
NETS = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
HEIGHT, WIDTH = 64, 128


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # these steps are heavy: two intra-op threads keep the test workers
    # that run beside this module from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("case", [0, 1, 2])
def test_depth_metrics_match_reference(golden, case):
    pred, gt = golden[f"depth{case}_pred"], golden[f"depth{case}_gt"]
    p, g = valid_depth_filter(pred.copy(), gt.copy())
    assert p.shape[0] == int(golden[f"depth{case}_nvalid"])
    metrics = np.asarray(compute_depth_metrics(p, g))
    assert np.allclose(metrics, golden[f"depth{case}_metrics"], atol=1e-6)
    # the caller's arrays are left alone
    np.testing.assert_array_equal(pred, golden[f"depth{case}_pred"])


def test_pose_errors_match_reference(golden):
    pm = PoseMetric().compute_pose_errors(golden["pose_pred"], golden["pose_true_mat"])
    assert np.allclose(pm.trj_abs_err, golden["pose_trj_abs_err"], atol=1e-6)
    assert np.allclose(pm.trj_rel_err, golden["pose_trj_rel_err"], atol=1e-6)
    assert np.allclose(pm.rot_err, golden["pose_rot_err"], atol=1e-6)


def test_twist_to_matrix_matches_reference_and_jax(golden):
    ours = twist_to_matrix_np(golden["se3_twists"])
    assert np.allclose(ours, golden["se3_matrices"], atol=1e-6)
    twists = np.random.RandomState(0).uniform(-0.5, 0.5, (7, 4, 6))
    twists[0, 0, 3:] = 0.0  # the small-angle branch
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(twist_to_matrix_np(twists.astype(dtype)),
                                      jse3.twist_to_matrix_np(twists.astype(dtype)))


def _predictions(seed, n=6):
    """An npz-shaped prediction split with some frames lacking GT."""
    rng = np.random.RandomState(seed)
    depth_gt = rng.uniform(2.0, 60.0, (n, HEIGHT, WIDTH, 1)).astype(np.float32)
    depth_gt[1] = 0.0  # no GT coverage: skipped
    depth_gt[2, ::2] = 0.0
    twists = rng.uniform(-0.2, 0.2, (n, 4, 6)).astype(np.float32)
    return {"image": rng.randint(0, 256, (n, HEIGHT, WIDTH, 3)).astype(np.uint8),
            "depth": (depth_gt * rng.uniform(0.5, 1.5, depth_gt.shape)).astype(np.float32)
            + 1.0,
            "depth_gt": depth_gt,
            "intrinsic": np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
            "pose": twists + rng.normal(0, 0.02, twists.shape).astype(np.float32),
            "pose_gt": jse3.twist_to_matrix_np(twists).astype(np.float32)}


def test_evaluate_npz_matches_jax(tmp_path):
    results = _predictions(1)
    teval.save_predictions(results, tmp_path / "pred", "split")
    ours = teval.evaluate_npz(tmp_path / "pred" / "split.npz", tmp_path / "ours", "split")
    ref = jeval.evaluate_npz(tmp_path / "pred" / "split.npz", tmp_path / "ref", "split")
    assert list(ours) == list(ref) and len(ours) == 10
    assert all(float(ours[k]) == float(ref[k]) for k in ref)
    for name in ("summary_split.csv", "depth_eval_split.csv", "pose_eval_split.csv"):
        assert (tmp_path / "ours" / name).read_text() == (tmp_path / "ref" / name).read_text()
    merged = teval.merge_eval_results(tmp_path)
    assert merged.read_text().count("summary_split") == 2 * len(ref)


@pytest.fixture(scope="module")
def model_and_data():
    data = SyntheticDataset(batch_size=2, height=HEIGHT, width=WIDTH, num_batches=3, seed=5)
    model = ModelFactory(data.config_keys(), NETS, stereo=False, device="cpu", seed=1).get_model()
    return model, data


def test_chunked_predictions_match_monolithic(model_and_data, tmp_path):
    model, data = model_and_data
    predict = make_predict_step(model)
    mono = teval.predict_dataset(model, data, predict)
    assert mono["depth"].shape == (6, HEIGHT, WIDTH, 1) and mono["pose"].shape == (6, 4, 6)
    paths = teval.predict_dataset_chunked(model, data, predict, tmp_path / "chunk", "split",
                                          flush_bytes=64 * 1024)
    assert len(paths) > 2 and paths[-1].name == "split.parts.json"
    assert teval.has_predictions(tmp_path / "chunk" / "split.npz")
    streamed = {}
    for part in teval.prediction_parts(tmp_path / "chunk" / "split.npz"):
        for key, value in part.items():
            streamed.setdefault(key, []).append(value)
    assert set(streamed) == set(mono)
    for key, value in mono.items():
        np.testing.assert_array_equal(np.concatenate(streamed[key]), value, err_msg=key)
    # the JAX package's evaluator reads the port's part series
    ours = teval.evaluate_npz(tmp_path / "chunk" / "split.npz", tmp_path / "e1", "split")
    ref = jeval.evaluate_npz(tmp_path / "chunk" / "split.npz", tmp_path / "e2", "split")
    assert all(float(ours[k]) == float(ref[k]) for k in ref)
    one = teval.predict_dataset_chunked(model, data, predict, tmp_path / "one", "split",
                                        flush_bytes=1 << 30)
    assert [p.name for p in one] == ["split.npz"]
    # without its marker a part series reads as absent; a missing part is loud
    marker = paths[-1]
    marker_text = marker.read_text()
    marker.unlink()
    assert not teval.has_predictions(tmp_path / "chunk" / "split.npz")
    marker.write_text(marker_text)
    paths[0].unlink()
    with pytest.raises(FileNotFoundError, match="corrupt"):
        teval.has_predictions(tmp_path / "chunk" / "split.npz")


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


def test_predict_by_plan_matches_jax(tmp_path, capsys):
    """The port's predict_by_plan over a test split of synthetic shards,
    from a checkpoint of converted weights, against the JAX predict step
    over the same shards; then evaluate_by_plan against the JAX
    evaluator on the same npz."""
    chip_smoke.write_synthetic_shards(tmp_path / "shards", HEIGHT, WIDTH, {"test": 5})
    keys = ["depth_gt", "image", "intrinsic", "pose_gt"]
    with full_f32():
        jmodel = JModelFactory(keys, NETS, stereo=False).get_model()
        loader = JDatasetLoader(JShardDataset(tmp_path / "shards" / "synthetic_test"), 2,
                                shuffle=False, raw_images=True)
        batches = [{k: jnp.asarray(v) for k, v in b.items()} for b in loader]
        variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                             batches[0])), 5)
        state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                                  batch_stats=variables["batch_stats"], tx=optax.identity())
        j_predict = j_make_predict_step(jmodel)
        ref = [j_predict(state, b) for b in batches]

        model = ModelFactory(keys, NETS, stereo=False, device="cpu").get_model()
        load_flax_variables(model, variables)
        CheckpointManager(tmp_path / "checkpts" / "run").save(
            model, optimizer_factory("adam_constant", 1e-4, model), "latest")
        cfg = Config(stereo=False, per_replica_batch=2, datapath=str(tmp_path),
                     compute_dtype="float32",
                     test_plan=[TestStage(NETS, "synthetic", ["depth", "pose"], "run"),
                                TestStage(NETS, "synthetic", ["depth"], "absent")])
        teval.predict_by_plan(cfg, device="cpu")
    assert "no weights for absent, skip" in capsys.readouterr().out
    got = dict(np.load(tmp_path / "prediction" / "run" / "synthetic_latest.npz"))
    assert sorted(got) == ["depth", "depth_gt", "image", "intrinsic", "pose", "pose_gt"]
    assert got["depth"].shape == (4, HEIGHT, WIDTH, 1)  # 2 whole batches of 5 snippets
    np.testing.assert_allclose(got["depth"], np.concatenate(
        [np.asarray(r["depth_ms"][0]) for r in ref]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["pose"], np.concatenate(
        [np.asarray(r["pose"]) for r in ref]), rtol=1e-4, atol=1e-5)
    for key in ("depth_gt", "pose_gt", "intrinsic"):
        np.testing.assert_array_equal(got[key], np.concatenate(
            [np.asarray(b[key]) for b in batches]), err_msg=key)
    image = np.concatenate([np.asarray(j_decode(b)["image5d"][:, -1]) for b in batches])
    np.testing.assert_array_equal(got["image"],
                                  ((np.clip(image, -1, 1) + 1) / 2 * 255).astype(np.uint8))
    teval.evaluate_by_plan(cfg)
    ours = (tmp_path / "evaluation" / "run" / "summary_synthetic_latest.csv").read_text()
    jeval.evaluate_npz(tmp_path / "prediction" / "run" / "synthetic_latest.npz",
                       tmp_path / "jax_eval", "synthetic_latest")
    assert ours == (tmp_path / "jax_eval" / "summary_synthetic_latest.csv").read_text()
    assert "trj_abs_err" in (tmp_path / "evaluation" / "merged_result.csv").read_text()
    # a second pass finds the predictions and the evaluation and skips them
    teval.predict_by_plan(cfg, device="cpu")
    teval.evaluate_by_plan(cfg)
    out = capsys.readouterr().out
    assert "exists, skip" in out
