"""Pretrained backbone weights in the port: the flax checkpoint codec
(``utils/flax_msgpack.py``) against ``flax.serialization``, the keras
converter (``models/backbones/convert_keras.py``) against the JAX
package's, the port's twin of ``scripts/convert_backbone_weights.py``,
``convert.state_dict_to_flax``, ``training/checkpoint.py::
load_pretrained_backbone`` and ``train_by_plan`` starting from the file.

The keras models are built with ``weights=None`` (nothing is downloaded),
at the small inputs of ``tests/test_backbone_conversion.py``. Tolerances:
the codec and the converter exactly (bytes, ``np.array_equal``); the
loaded EfficientNetB0 against keras's taps within 2e-3 max abs, the bound
``tests/test_keras_conversion.py`` holds flax to; loaded weights bit for
bit.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import flax.serialization as fs
import numpy as np
import pytest
import torch

import chip_smoke
from xpt_mde_tpu.models.backbones import convert_keras as jck
from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1, Config, TrainStage
from xpt_mde_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.models.backbones import backbone_factory
from xpt_mde_tpu_torch.models.backbones import convert_keras as tck
from xpt_mde_tpu_torch.scripts import convert_backbone_weights as tscript
from xpt_mde_tpu_torch.training.checkpoint import load_pretrained_backbone
from xpt_mde_tpu_torch.training.trainer import train_by_plan
from xpt_mde_tpu_torch.utils.flax_msgpack import MAX_CHUNK_SIZE, from_bytes, to_bytes
from xpt_mde_tpu_torch.utils.precision import full_f32

tf = pytest.importorskip("tensorflow")

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 128
# net -> keras input shape, as tests/test_backbone_conversion.py builds them
SHAPES = {"EfficientNetB0": (H, W, 3), "ResNet50V2": (H, W, 3), "MobileNetV2": (H, W, 3),
          "VGG16": (H, W, 3), "DenseNet121": (H, W, 3), "Xception": (96 + 6, 160 + 6, 3),
          "NASNetMobile": (H + 2, W + 2, 3)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the test workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


_KERAS = {}


def keras_model(name):
    """The keras backbone of ``name``, random weights from seed 0, built
    once; EfficientNet's Normalization pinned to the imagenet statistics so
    that its converted input_mean/input_var are not trivial."""
    if name not in _KERAS:
        tf.keras.utils.set_random_seed(0)
        model = getattr(tf.keras.applications, name)(include_top=False, weights=None,
                                                     input_shape=SHAPES[name])
        for layer in model.layers:
            if type(layer).__name__ == "Normalization":
                layer.set_weights([np.array([0.485, 0.456, 0.406], np.float32),
                                   np.array([0.229 ** 2, 0.224 ** 2, 0.225 ** 2], np.float32),
                                   np.array(0, np.int64)])
                layer.finalize_state()
        _KERAS[name] = model
    return _KERAS[name]


def assert_same_tree(ours, theirs, path=""):
    """Same keys in the same order, equal leaves of the same dtype."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict), path
        assert list(ours) == list(theirs), path
        for key in theirs:
            assert_same_tree(ours[key], theirs[key], f"{path}/{key}")
    elif isinstance(theirs, tuple):  # (params, batch_stats)
        assert isinstance(ours, tuple) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_tree(a, b, f"{path}[{i}]")
    else:
        assert type(ours) is type(theirs), (path, type(ours), type(theirs))
        assert np.asarray(ours).dtype == np.asarray(theirs).dtype, path
        assert np.array_equal(ours, theirs), path


def pretrained_file(path: Path, name: str) -> Path:
    params, stats = jck.convert_backbone(keras_model(name), name)
    path.mkdir(parents=True, exist_ok=True)
    out = path / f"{name}.msgpack"
    out.write_bytes(fs.to_bytes({"params": params, "batch_stats": stats}))
    return out


@pytest.mark.parametrize("name", ["EfficientNetB0", "MobileNetV2"])
def test_codec_matches_flax(name):
    params, stats = jck.convert_backbone(keras_model(name), name)
    tree = {"params": params, "batch_stats": stats}
    flax_bytes = fs.to_bytes(tree)
    assert to_bytes(tree) == flax_bytes
    assert_same_tree(from_bytes(flax_bytes), fs.msgpack_restore(flax_bytes))


def test_codec_scalars_and_the_chunk_limit():
    tree = {"a": np.float32(1.5), "b": {"c": np.arange(6, dtype=np.int64).reshape(2, 3),
                                        "d": 3.25, "e": -70000, "f": 2 ** 40, "g": None,
                                        "h": True, "i": "x" * 40, "j": np.int8(-3)},
            "k": np.zeros((0, 4), np.float16), "l": np.ones((300,), np.float64)}
    flax_bytes = fs.to_bytes(tree)
    assert to_bytes(tree) == flax_bytes
    assert_same_tree(from_bytes(flax_bytes), fs.msgpack_restore(flax_bytes))
    huge = np.broadcast_to(np.float32(0), (MAX_CHUNK_SIZE // 4 + 1,))  # no memory behind it
    with pytest.raises(ValueError, match="2\\*\\*30"):
        to_bytes({"w": huge})
    with pytest.raises(TypeError):
        to_bytes({"w": [1, 2]})  # flax writes lists as dicts: outside the subset


@pytest.mark.parametrize("name", list(SHAPES))
def test_converter_matches_jax(name):
    model = keras_model(name)
    assert_same_tree(tck.convert_backbone(model, name), jck.convert_backbone(model, name))
    kw = jck._keras_weight_dict(model)
    assert_same_tree(tck._keras_weight_dict(model), kw)
    # an H5 file names keras-3 depthwise kernels "depthwise_kernel"
    for layer in model.layers:
        if type(layer).__name__ == "DepthwiseConv2D":
            kw[layer.name] = {"depthwise_kernel": kw[layer.name]["kernel"]}
    order = [layer.name for layer in model.layers]
    assert_same_tree(tck.convert_backbone_kw(kw, order, name),
                     jck.convert_backbone_kw(kw, order, name))
    assert tck._autoname_map(order) == jck._autoname_map(order)


def test_loaded_efficientnet_matches_keras_taps():
    model = keras_model("EfficientNetB0")
    x_raw = np.random.RandomState(0).uniform(0, 255, (1, H, W, 3)).astype(np.float32)
    taps = {}
    for layer in model.layers:  # the last layer of stages 1, 2, 3, 5 and 7
        if layer.name.startswith("block") and layer.name.endswith(("_add", "project_bn")):
            taps[int(layer.name[5])] = layer
    keras_taps = tf.keras.Model(model.input, [taps[i].output for i in (1, 2, 3, 5, 7)])(x_raw)

    ours = backbone_factory("EfficientNetB0")
    ours.to_empty(device="cpu")
    tck.load_into_variables(ours, *tck.convert_backbone(model, "EfficientNetB0"))
    with full_f32(), torch.no_grad():
        out = ours.eval()(torch.from_numpy(x_raw).permute(0, 3, 1, 2))
    assert len(out) == 5
    for i, (got, ref) in enumerate(zip(out, keras_taps)):
        got, ref = got.permute(0, 2, 3, 1).numpy(), np.asarray(ref)
        assert got.shape == ref.shape, i
        assert np.abs(got - ref).max() < 2e-3, f"tap {i}: {np.abs(got - ref).max()}"


def test_load_pretrained_backbone(tmp_path):
    path = pretrained_file(tmp_path, "EfficientNetB0")
    model = ModelFactory(["image"], {"depth": "EfficientNetB0"}, stereo=False,
                         device="cpu").get_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrained_backbone(model, path)
    want = flax_to_state_dict(fs.msgpack_restore(path.read_bytes()), model.depthnet.backbone)
    got = model.depthnet.backbone.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    # the decoder is left alone
    for key, value in model.state_dict().items():
        if not key.startswith("depthnet.backbone."):
            assert torch.equal(value, before[key]), key
    # written back in the flax layout, the loaded backbone is the file
    assert to_bytes(state_dict_to_flax(model.depthnet.backbone)) == path.read_bytes()

    # another backbone's file loads nothing
    loaded = {k: v.clone() for k, v in model.state_dict().items()}
    other = pretrained_file(tmp_path / "other", "MobileNetV2")
    assert not load_pretrained_backbone(model, other)
    assert all(torch.equal(v, loaded[k]) for k, v in model.state_dict().items())
    assert not load_pretrained_backbone(model, tmp_path / "missing.msgpack")
    pose_only = ModelFactory(["image"], {"camera": "PoseNetBasic"}, stereo=False,
                             device="cpu").get_model()
    assert not load_pretrained_backbone(pose_only, path)  # no depth-net backbone


def test_state_dict_to_flax_inverts_the_converter():
    model = ModelFactory(["image"], {"depth": "MobileNetV2", "flow": "PWCNet"}, stereo=False,
                         device="cpu", seed=3).get_model()
    with torch.no_grad():  # statistics that are not the identity's
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.uniform_(0.5, 1.5)
    tree = state_dict_to_flax(model)
    back = flax_to_state_dict(tree, model)
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(back[key], value), key
    assert tree["params"]["flownet"]["FlowPredictor_0"]["ConvTranspose_0"]["kernel"].shape == \
        tuple(np.array(model.flownet.FlowPredictor_0.ConvTranspose_0.weight.shape)[[2, 3, 0, 1]])


def _load_script(path: Path):
    spec = importlib.util.spec_from_file_location("jax_convert_backbone_weights", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_convert_script_writes_the_jax_scripts_bytes(tmp_path, monkeypatch):
    jscript = _load_script(ROOT / "scripts" / "convert_backbone_weights.py")
    # both scripts get the one keras model (built once, as keras would load it)
    model, built = keras_model("EfficientNetB0"), []

    def build_keras(**kwargs):
        built.append(kwargs)
        return model

    monkeypatch.setattr(tf.keras.applications, "EfficientNetB0", build_keras)
    jax_file = jscript.convert("EfficientNetB0", tmp_path / "jax", weights=None)
    with contextlib.redirect_stdout(io.StringIO()):
        port_file = tscript.convert("EfficientNetB0", tmp_path / "port", weights=None)
    assert built == [{"include_top": False, "weights": None}] * 2
    assert port_file == tmp_path / "port" / "pretrained" / "EfficientNetB0.msgpack"
    assert port_file.read_bytes() == Path(jax_file).read_bytes()
    model = ModelFactory(["image"], {"depth": "EfficientNetB0"}, stereo=False,
                         device="cpu").get_model()
    assert load_pretrained_backbone(model, jax_file)
    assert load_pretrained_backbone(model, port_file)


def test_train_by_plan_starts_from_the_file(tmp_path):
    nets = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
    path = pretrained_file(tmp_path / "pretrained", "EfficientNetB0")
    chip_smoke.write_synthetic_shards(tmp_path / "shards", 32, 64, {"train": 2})
    # a zero learning rate: the backbone's weights after the row are the
    # ones it started from (its BatchNorm statistics move in train mode)
    cfg = Config(stereo=False, per_replica_batch=2, datapath=str(tmp_path), ckpt_name="pre",
                 compute_dtype="float32", augment_probs={},
                 training_plan=[TrainStage(nets, "synthetic", 1, 0.0, {"L1": 1.0},
                                           SCALE_WEIGHT_T1)])
    assert cfg.pretrained_weight
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        train_by_plan(cfg, device="cpu")
    assert f"[ckpt] loaded pretrained backbone from {path}" in log.getvalue()
    saved = torch.load(tmp_path / "checkpts" / "pre" / "depthnet_latest.pt", weights_only=True)
    backbone = {k[len("backbone."):]: v for k, v in saved.items() if k.startswith("backbone.")}
    ref = ModelFactory(["image"], nets, stereo=False, device="cpu").get_model()
    want = flax_to_state_dict(fs.msgpack_restore(path.read_bytes()), ref.depthnet.backbone)
    params = dict(ref.depthnet.backbone.named_parameters())
    for key in params:
        assert torch.equal(backbone[key], want[key]), key
