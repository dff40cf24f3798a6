"""The port's serving artifacts (``xpt_mde_tpu_torch.serving``) against the
JAX package: the three cases of ``tests/test_serving_export.py`` (the
round trip, a wrong shape raising ``ValueError``, a uint8 input decoded
inside the artifact), with the artifact's outputs held to JAX's
``model.apply`` on the same weights (``convert.py``) at JAX's tolerance,
1e-6; a PWC-Net artifact in float32 and bfloat16 held to the live predict
step; and an artifact loaded in a fresh interpreter with JAX and the
port's model code made unimportable.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _fill
from xpt_mde_tpu.models import ModelFactory as JModelFactory
from xpt_mde_tpu.training.train_step import decode_image_features as j_decode
from xpt_mde_tpu_torch.convert import load_flax_variables
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.serving import export_predictor, load_predictor
from xpt_mde_tpu_torch.training import make_predict_step

REPO = Path(__file__).resolve().parents[1]
B, S, H, W = 1, 5, 32, 64
NETS = {"depth": "DepthNetBasic", "camera": "PoseNetBasic"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """The JAX model, its variables (test_torch_train.py's fill) and the
    port's model with the same weights."""
    feats = {"image5d": jnp.asarray(
        np.random.RandomState(0).rand(B, S, H, W, 3).astype(np.float32) * 2 - 1)}
    jmodel = JModelFactory(["image", "intrinsic"], NETS, stereo=False).get_model()
    variables = _fill(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), feats,
                                                         train=False)), 5)
    model = ModelFactory(["image", "intrinsic"], NETS, stereo=False, device="cpu").get_model()
    load_flax_variables(model, variables)
    apply = jax.jit(lambda f: jmodel.apply(variables, f, train=False))
    return apply, model, {k: np.asarray(v) for k, v in feats.items()}


@pytest.fixture(scope="module")
def artifact(models, tmp_path_factory):
    """The float artifact of ``models``' port model (DepthNetBasic's
    weights make it ~130 MB: exported once, removed after the module)."""
    _, model, feats = models
    out = tmp_path_factory.mktemp("serving") / "art"
    yield export_predictor(model, feats, out, description="test predictor")
    shutil.rmtree(out)


def _close_to_jax(got, want):
    for i in range(4):
        np.testing.assert_allclose(got["depth_ms"][i].numpy(), np.asarray(want["depth_ms"][i]),
                                   atol=1e-6, rtol=1e-6, err_msg=f"depth_ms[{i}]")
    np.testing.assert_allclose(got["pose"].numpy(), np.asarray(want["pose"]), atol=1e-6,
                               rtol=1e-6)


def test_export_roundtrip(models, artifact):
    apply, model, feats = models
    out = artifact
    assert (out / "predict.pt2").exists() and (out / "meta.json").exists()
    predictor = load_predictor(out)
    assert predictor.meta["description"] == "test predictor"
    assert predictor.meta["input_spec"]["image5d"] == {"shape": [B, S, H, W, 3],
                                                       "dtype": "float32"}
    assert predictor.meta["device"] == "cpu"
    assert predictor.meta["compute_dtype"] == "float32"
    assert predictor.meta["torch_version"] == torch.__version__
    _close_to_jax(predictor(feats), apply({k: jnp.asarray(v) for k, v in feats.items()}))
    assert model.training  # the model's mode is restored after the trace


def test_export_rejects_wrong_shape(models, artifact):
    _, _, feats = models
    predictor = load_predictor(artifact)
    with pytest.raises(ValueError):
        predictor({"image5d": np.zeros((B, S, H, 2 * W, 3), np.float32)})
    with pytest.raises(ValueError):
        predictor({"image5d": np.zeros((B, S, H, W, 3), np.float64)})
    with pytest.raises(ValueError):
        predictor({"image": feats["image5d"]})


def test_export_uint8_input_decodes_in_artifact(models, tmp_path):
    apply, model, _ = models
    raw = {"image5d": np.random.RandomState(1).randint(0, 256, (B, S, H, W, 3)).astype(np.uint8)}
    out = export_predictor(model, raw, tmp_path / "art_u8")
    predictor = load_predictor(out)
    assert predictor.meta["input_spec"]["image5d"]["dtype"] == "uint8"
    _close_to_jax(predictor(raw), apply(j_decode({"image5d": jnp.asarray(raw["image5d"])})))
    shutil.rmtree(out)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_flow_artifact_matches_the_live_predict_step(compute_dtype, tmp_path):
    """PWC-Net at 64x128 from a uint8 batch: on the CPU the cost volume is
    the plain version in both, so the artifact gives the live step's bits."""
    model = ModelFactory(["image", "intrinsic"], {"flow": "PWCNet"}, stereo=False,
                         compute_dtype=compute_dtype, device="cpu").get_model()
    raw = {"image5d": torch.from_numpy(
        np.random.RandomState(2).randint(0, 256, (1, S, 64, 128, 3)).astype(np.uint8))}
    predictor = load_predictor(export_predictor(model, raw, tmp_path / "flow"))
    assert predictor.meta["compute_dtype"] == compute_dtype
    got, want = predictor(raw), make_predict_step(model)(raw)
    assert set(got) == set(want) == {"flow_ms"}
    for a, b in zip(got["flow_ms"], want["flow_ms"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_artifact_loads_without_jax_or_the_model_code(models, artifact, tmp_path):
    _, model, feats = models
    out = artifact
    np.save(tmp_path / "feats.npy", feats["image5d"])
    want = make_predict_step(model)({k: torch.from_numpy(v) for k, v in feats.items()})
    np.save(tmp_path / "pose.npy", want["pose"].numpy())
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "xpt_mde_tpu",
                     "xpt_mde_tpu_torch.models", "xpt_mde_tpu_torch.training"):
            sys.modules[name] = None
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from xpt_mde_tpu_torch.serving import load_predictor
        predictor = load_predictor({str(out)!r})
        got = predictor({{"image5d": np.load({str(tmp_path / 'feats.npy')!r})}})
        assert np.array_equal(got["pose"].numpy(), np.load({str(tmp_path / 'pose.npy')!r}))
        assert all(sys.modules.get(m) is None for m in
                   ("jax", "xpt_mde_tpu", "xpt_mde_tpu_torch.models"))
        print("SERVING JAX-FREE OK", {json.dumps(list(feats))!r})
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVING JAX-FREE OK" in proc.stdout
