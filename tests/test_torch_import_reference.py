"""The reference-checkpoint import of the port
(``training/import_reference.py``, ``scripts/import_reference_ckpt.py``)
against the JAX package's.

The H5 fixtures are made as ``tests/test_import_reference.py`` makes
them: keras's legacy ``save_weights`` layout written with h5py, from the
reference's tf.keras twins (PoseNetImproved, DepthNetBasic), from random
arrays named and shaped after the JAX PWC-Net, and from a keras
EfficientNetB0 beside a random ``dp_*`` decoder (DepthNetPretrained).

Tolerances: the H5 reading and the converted trees exactly; the port's
``{net}_{suffix}.pt`` bit for bit the JAX package's import mapped through
``convert.py``; a forward of the imported nets within rtol 1e-5, atol
1e-5 of the JAX nets' on the JAX import, and within 2e-5 of the tf.keras
twin, the bound the JAX test holds itself to.
"""

import contextlib
import io
from pathlib import Path

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xpt_mde_tpu.config import Config as JConfig
from xpt_mde_tpu.models.backbones import backbone_factory as j_backbone_factory
from xpt_mde_tpu.models.depth_net import DepthNetBasic as JDepthNetBasic
from xpt_mde_tpu.models.depth_net import DepthNetPretrained as JDepthNetPretrained
from xpt_mde_tpu.models.flow_net import PWCNet as JPWCNet
from xpt_mde_tpu.models.layers import activation_factory as j_activation_factory
from xpt_mde_tpu.models.pose_net import PoseNetImproved as JPoseNetImproved
from xpt_mde_tpu.training import import_reference as jimp
from xpt_mde_tpu_torch.config import Config
from xpt_mde_tpu_torch.convert import flax_to_state_dict
from xpt_mde_tpu_torch.models import ModelFactory
from xpt_mde_tpu_torch.training import import_reference as timp
from xpt_mde_tpu_torch.training.checkpoint import CheckpointManager
from xpt_mde_tpu_torch.utils.precision import full_f32

tf = pytest.importorskip("tensorflow")

from test_import_reference import (_dump_models_legacy_h5, _tf_depthnet_basic,  # noqa: E402
                                   _tf_posenet_improved, keras_model_to_legacy_h5,
                                   write_legacy_h5)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # two intra-op threads: the test workers beside this module share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def assert_same_tree(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and list(ours) == list(theirs), path
        for key in theirs:
            assert_same_tree(ours[key], theirs[key], f"{path}/{key}")
    elif isinstance(theirs, (tuple, list)):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_tree(a, b, f"{path}[{i}]")
    else:
        assert np.asarray(ours).dtype == np.asarray(theirs).dtype, path
        assert np.array_equal(ours, theirs), path


def assert_state_equal(state: dict, want: dict):
    assert set(state) == set(want)
    for key, value in want.items():
        assert torch.equal(state[key], value), key


def test_deconv_kernel_and_reader_are_the_jax_ones(tmp_path):
    kernel = np.random.RandomState(0).randn(4, 4, 3, 5).astype(np.float32)
    assert np.array_equal(timp.deconv_kernel(kernel), jimp.deconv_kernel(kernel))
    rng = np.random.RandomState(1)
    layers = [("a", {"a/kernel:0": rng.randn(3, 3, 2, 4), "a/bias:0": rng.randn(4)}),
              ("model", {"model/inner/gamma:0": rng.randn(4), "model/inner/beta:0": rng.randn(4)}),
              ("conv2d_3", {"conv2d_3/kernel:0": rng.randn(1, 1, 4, 4)})]
    write_legacy_h5(tmp_path / "w.h5", layers)
    assert_same_tree(timp.read_keras_h5(tmp_path / "w.h5"), jimp.read_keras_h5(tmp_path / "w.h5"))


def test_posenet_import_matches_jax(tmp_path):
    snippet, h, w = 5, 32, 64
    tf.keras.utils.set_random_seed(1)
    twin = _tf_posenet_improved(snippet, h, w)
    src = tmp_path / "ref"
    src.mkdir()
    keras_model_to_legacy_h5(twin, src / "posenet_latest.h5")
    _, kw = timp.read_keras_h5(src / "posenet_latest.h5")
    for variant in ("PoseNetImproved", "PoseNetDeep", "PoseNetBasic"):
        if variant == "PoseNetImproved":
            assert_same_tree(timp.posenet_params(kw, variant), jimp.posenet_params(kw, variant))
        else:  # the twin has only PoseNetImproved's layers: both refuse alike
            with pytest.raises(KeyError):
                jimp.posenet_params(kw, variant)
            with pytest.raises(KeyError):
                timp.posenet_params(kw, variant)

    nets = {"camera": "PoseNetImproved"}
    with contextlib.redirect_stdout(io.StringIO()):
        assert jimp.import_reference_checkpoint(src, tmp_path / "jax", JConfig(), nets) == \
            ["posenet"]
        assert timp.import_reference_checkpoint(src, tmp_path / "port", Config(), nets) == \
            ["posenet"]
    model = ModelFactory(["image"], nets, stereo=False, device="cpu").get_model()
    jparams = fs.msgpack_restore((tmp_path / "jax" / "posenet_latest.msgpack").read_bytes())
    want = flax_to_state_dict({"params": jparams}, model.posenet)
    assert_state_equal(torch.load(tmp_path / "port" / "posenet_latest.pt", weights_only=True),
                       want)
    # the port's CheckpointManager loads the import unchanged
    with contextlib.redirect_stdout(io.StringIO()):
        assert CheckpointManager(tmp_path / "port").restore_params(model)

    image5d = np.random.RandomState(2).uniform(-1, 1, (1, snippet, h, w, 3)).astype(np.float32)
    ref = np.asarray(JPoseNetImproved().apply({"params": jparams}, jnp.asarray(image5d))["pose"])
    with full_f32(), torch.no_grad():
        ours = model.posenet.eval()(torch.from_numpy(image5d))["pose"].numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, np.asarray(twin(image5d)), atol=2e-5)


def test_depthnet_basic_import_matches_jax(tmp_path):
    snippet, h, w = 3, 128, 256
    tf.keras.utils.set_random_seed(3)
    twin = _tf_depthnet_basic(snippet, h, w)
    h5 = tmp_path / "depthnet_latest.h5"
    keras_model_to_legacy_h5(twin, h5)
    nets = {"depth": "DepthNetBasic"}
    ours_tree = timp.convert_net_h5(h5, "depthnet", nets)
    jparams, jstats = jimp.convert_net_h5(h5, "depthnet", nets)
    assert_same_tree(ours_tree, (jparams, jstats))
    assert jstats == {}
    with contextlib.redirect_stdout(io.StringIO()):
        assert timp.import_reference_checkpoint(tmp_path, tmp_path / "port", Config(), nets) == \
            ["depthnet"]
    model = ModelFactory(["image"], nets, stereo=False, device="cpu").get_model()
    state = torch.load(tmp_path / "port" / "depthnet_latest.pt", weights_only=True)
    assert_state_equal(state, flax_to_state_dict({"params": jparams}, model.depthnet))
    model.depthnet.load_state_dict(state)

    image5d = np.random.RandomState(4).uniform(-1, 1, (1, snippet, h, w, 3)).astype(np.float32)
    ref = jax.jit(JDepthNetBasic(j_activation_factory("InverseSigmoid")).apply)(
        {"params": jparams}, jnp.asarray(image5d))["depth_ms"]
    with full_f32(), torch.no_grad():
        ours = model.depthnet.eval()(torch.from_numpy(image5d))["depth_ms"]
    depth_tf = twin(image5d)
    for i, (got, want, keras) in enumerate(zip(ours, ref, depth_tf)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"scale {i}", **TOL)
        # the JAX test's own bound against the tf.keras twin
        np.testing.assert_allclose(got.numpy(), np.asarray(keras), rtol=2e-4, atol=2e-4)


def test_flownet_import_matches_jax(tmp_path):
    template = jax.eval_shape(lambda: JPWCNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 128, 3))))["params"]
    rng = np.random.RandomState(5)
    layers = []

    def add(name, leaf, transpose=False):
        kernel = leaf["kernel"].shape
        if transpose:
            kernel = kernel[:2] + (kernel[3], kernel[2])
        layers.append((name, {f"{name}/kernel:0": rng.randn(*kernel).astype(np.float32),
                              f"{name}/bias:0": rng.randn(*leaf["bias"].shape).astype(np.float32)}))

    for sfx, enc in (("_l", "encoder_l"), ("_r", "encoder_r")):
        names = [f"pwc_conv{lv}{ab}{sfx}" for lv in range(1, 7) for ab in "abc"]
        for i, name in enumerate(names):
            add(name, template[enc][f"Conv_{i}"]["Conv_0"])
    d32_names = ["conv2d"] + [f"conv2d_{i}" for i in range(1, 5)]
    for i, (p, d32) in enumerate(zip(["pwc_flow6_", "pwc_flow5_", "pwc_flow4_", "pwc_flow3_",
                                      "pwc_flow2_"], d32_names)):
        fp = template[f"FlowPredictor_{i}"]
        for j, tail in enumerate(["c1", "c2", "c3", "c4"]):
            add(p + tail, fp[f"Conv_{j}"]["Conv_0"])
        add(d32, fp["Conv_4"]["Conv_0"])
        add(p + "out", fp["Conv_5"]["Conv_0"])
        if i < 4:
            add(p + "ct1", fp["ConvTranspose_0"], transpose=True)
            add(p + "ct2", fp["ConvTranspose_1"], transpose=True)
    for i in range(7):
        add(f"pwc_context_{i + 1}", template["ContextNetwork_0"][f"Conv_{i}"]["Conv_0"])
    write_legacy_h5(tmp_path / "flownet_ep03.h5", layers)

    nets = {"flow": "PWCNet"}
    jparams, _ = jimp.convert_net_h5(tmp_path / "flownet_ep03.h5", "flownet", nets)
    assert_same_tree(timp.convert_net_h5(tmp_path / "flownet_ep03.h5", "flownet", nets),
                     (jparams, {}))
    with contextlib.redirect_stdout(io.StringIO()):
        assert timp.import_reference_checkpoint(tmp_path, tmp_path / "port", Config(), nets,
                                                suffix="ep03") == ["flownet"]
    model = ModelFactory(["image"], nets, stereo=False, device="cpu").get_model()
    assert_state_equal(torch.load(tmp_path / "port" / "flownet_ep03.pt", weights_only=True),
                       flax_to_state_dict({"params": jparams}, model.flownet))
    with pytest.raises(ValueError, match="PWCNet"):
        timp.convert_net_h5(tmp_path / "flownet_ep03.h5", "flownet", {"flow": "Other"})
    with pytest.raises(FileNotFoundError):
        timp.import_reference_checkpoint(tmp_path, tmp_path / "port", Config(), nets)


def test_depthnet_pretrained_import_matches_jax(tmp_path):
    """A DepthNetPretrained file: the keras EfficientNetB0's layers under
    their keras-applications names beside the reference decoder's dp_*
    layers (random, shaped after the JAX decoder)."""
    h, w = 64, 128
    tf.keras.utils.set_random_seed(11)
    ptmodel = tf.keras.applications.EfficientNetB0(include_top=False, weights=None,
                                                   input_shape=(h, w, 3))
    jmodel = JDepthNetPretrained(j_backbone_factory("EfficientNetB0", jnp.float32),
                                 j_activation_factory("InverseSigmoid"))
    decoder = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                 jnp.zeros((1, 3, h, w, 3))))["params"]
    decoder = decoder["DepthDecoder_0"]
    rng = np.random.RandomState(12)
    dec_layers = []
    scopes = {"UpconvBlock": ["dp_up4", "dp_up3", "dp_up2", "dp_up1", "dp_up0"],
              "ScaledDepthHead": ["dp_depth3", "dp_depth2", "dp_depth1", "dp_depth0"]}
    for module, sub in decoder.items():
        kind, idx = module.rsplit("_", 1)
        for conv, leaf in sub.items():
            name = scopes[kind][int(idx)] + (f"_conv{int(conv[-1]) + 1}"
                                             if kind == "UpconvBlock" else "_conv")
            leaf = leaf["Conv_0"]
            dec_layers.append((name, {
                f"{name}/kernel:0": rng.randn(*leaf["kernel"].shape).astype(np.float32),
                f"{name}/bias:0": rng.randn(*leaf["bias"].shape).astype(np.float32)}))
    _dump_models_legacy_h5(tmp_path / "depthnet_latest.h5", [ptmodel])
    import h5py

    with h5py.File(tmp_path / "depthnet_latest.h5", "a") as f:  # the decoder after the backbone
        names = list(f.attrs["layer_names"])
        for name, weights in dec_layers:
            grp = f.create_group(name)
            grp.attrs["weight_names"] = np.array([wn.encode() for wn in weights])
            for wname, arr in weights.items():
                grp.create_dataset(wname, data=arr)
            names.append(name.encode())
        f.attrs["layer_names"] = np.array(names)

    nets = {"depth": "EfficientNetB0", "camera": "PoseNetImproved"}
    jparams, jstats = jimp.convert_net_h5(tmp_path / "depthnet_latest.h5", "depthnet", nets)
    assert_same_tree(timp.convert_net_h5(tmp_path / "depthnet_latest.h5", "depthnet", nets),
                     (jparams, jstats))
    assert list(jstats) == ["backbone"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert timp.import_reference_checkpoint(tmp_path, tmp_path / "port", Config(), nets) == \
            ["depthnet"]
    model = ModelFactory(["image"], nets, stereo=False, device="cpu").get_model()
    assert_state_equal(torch.load(tmp_path / "port" / "depthnet_latest.pt", weights_only=True),
                       flax_to_state_dict({"params": jparams, "batch_stats": jstats},
                                          model.depthnet))
    assert not (tmp_path / "port" / "posenet_latest.pt").exists()  # no posenet file given


def test_import_script_reads_the_user_config(tmp_path, monkeypatch):
    from xpt_mde_tpu_torch.config import SCALE_WEIGHT_T1, TrainStage
    from xpt_mde_tpu_torch.scripts import import_reference_ckpt, train_main

    tf.keras.utils.set_random_seed(1)
    src = tmp_path / "ref"
    src.mkdir()
    keras_model_to_legacy_h5(_tf_posenet_improved(5, 32, 64), src / "posenet_ep02.h5")
    plan = [TrainStage({"camera": "PoseNetImproved"}, "kitti_raw", 1, 1e-4, {"L1": 1.0},
                       SCALE_WEIGHT_T1)]
    cfg = Config(datapath=str(tmp_path / "data"), ckpt_name="imported", training_plan=plan)
    cfg.import_src, cfg.import_suffix = str(src), "ep02"
    monkeypatch.setattr(train_main, "load_user_config", lambda: cfg)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        assert import_reference_ckpt.main() == 0
    assert (Path(cfg.datapath_ckp) / "imported" / "posenet_ep02.pt").is_file()
    assert "done: ['posenet']" in log.getvalue()
