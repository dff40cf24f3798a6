"""The port's copies of the reference's configuration and data input:
``config.py`` (constants, recipes, plans, ``Config``), ``utils/util_class.py``,
``data/shard_io.py`` and ``data/native_loader.py`` with its C++ reader.

Everything is compared exactly: field for field, defaults included
(``Config.compute_dtype`` is bfloat16 in both packages), and batches bit
for bit on shards that the JAX package's ``ShardMaker("synthetic")``
writes. The reference
batches come from the JAX package's numpy loader, which its own tests
hold equal to its native one (``test_data_pipeline.py``); building the
JAX package's native library here too would race with them.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from xpt_mde_tpu import config as jconfig
from xpt_mde_tpu.data.native_loader import PrefetchLoader as JPrefetchLoader
from xpt_mde_tpu.data import shard_io as jshard
from xpt_mde_tpu.data.shard_maker import ShardMaker
from xpt_mde_tpu.utils import util_class as jutil
from xpt_mde_tpu_torch import config
from xpt_mde_tpu_torch.data import example_batch
from xpt_mde_tpu_torch.data import native_loader
from xpt_mde_tpu_torch.data import shard_io
from xpt_mde_tpu_torch.utils import util_class

HEIGHT, WIDTH = 32, 64


@pytest.mark.parametrize("name", [
    "MIN_DEPTH", "MAX_DEPTH", "IMAGE_SIZES_SMALL", "IMAGE_SIZES_LARGE",
    "IMAGE_GRADIENT_FACTOR", "SMOOTHNESS_FACTOR", "SSIM_RATIO", "LOSS_RIGID_T1",
    "LOSS_RIGID_T2", "LOSS_RIGID_COMB", "LOSS_RIGID_MOA", "LOSS_RIGID_MOA_WST",
    "LOSS_RIGID_MD2", "JOINT_NET"])
def test_constant_matches_jax(name):
    assert getattr(config, name) == getattr(jconfig, name)


@pytest.mark.parametrize("cls", ["TrainStage", "TestStage", "Config"])
def test_dataclass_fields_match_jax(cls):
    ours, ref = getattr(config, cls), getattr(jconfig, cls)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


@pytest.mark.parametrize("plan", ["training_plan_28", "training_plan_30"])
def test_plans_match_jax(plan):
    ours, ref = getattr(config, plan)(), getattr(jconfig, plan)()
    assert [dataclasses.asdict(s) for s in ours] == [dataclasses.asdict(s) for s in ref]


def test_config_matches_jax():
    ours, ref = config.Config().to_json_dict(), jconfig.Config().to_json_dict()
    assert ours == ref
    assert ours["compute_dtype"] == "bfloat16"
    json.dumps(ours)  # serializable, as the drift check needs


def test_config_properties_match_jax():
    kwargs = dict(high_res=True, per_replica_batch=3, datapath="/data/x",
                  image_size_overrides={"synthetic": (40, 72)}, compute_dtype="float32")
    ours, ref = config.Config(**kwargs), jconfig.Config(**kwargs)
    assert ours.image_sizes == ref.image_sizes and ours.batch_size == ref.batch_size
    for code in ("H", "W", "HW", "WH", "HWC", "SHW", "SHWC", "BSHWC", "RSHWC"):
        assert ours.get_img_shape(code, "synthetic", 2) == ref.get_img_shape(code, "synthetic", 2)
    for sub in ("src", "shd", "ckp", "log", "prd", "evl"):
        assert getattr(ours, f"datapath_{sub}") == getattr(ref, f"datapath_{sub}")
    with pytest.raises(ValueError, match="Invalid shape code"):
        ours.get_img_shape("BHW")


def test_config_refuses_dtypes_other_than_float32_and_bfloat16():
    with pytest.raises(ValueError, match="compute_dtype"):
        config.Config(compute_dtype="float16")
    for dtype in ("bfloat16", "float32"):
        assert config.Config(compute_dtype=dtype).compute_dtype == dtype


def test_util_classes_behave_like_jax(tmp_path):
    for mod in (util_class, jutil):
        assert issubclass(mod.RecoverableSkip, Exception)
        assert issubclass(mod.WrongInputError, Exception)
        kept, dropped = tmp_path / mod.__name__ / "kept", tmp_path / mod.__name__ / "dropped"
        with mod.PathManager(kept) as pm:
            (kept / "a").write_text("x")
            pm.set_ok()
        with pytest.raises(KeyError):
            with mod.PathManager(dropped):
                (dropped / "a").write_text("x")
                raise KeyError("fail")
        assert kept.is_dir() and not dropped.exists()
        with mod.DurationTime() as timer:
            pass
        assert timer.duration >= 0.0


@pytest.fixture(scope="module")
def jax_shards(tmp_path_factory):
    """train (2 drives x 8 frames -> 16 snippets) and test splits written
    by the JAX package's ShardMaker, 5 snippets a shard file."""
    root = tmp_path_factory.mktemp("data")
    cfg = jconfig.Config(datapath=str(root), frames_per_shard=5, compute_dtype="float32",
                         image_size_overrides={"synthetic": (HEIGHT, WIDTH)})
    reader = {"height": HEIGHT, "width": WIDTH, "num_frames": 12, "drives": 2}
    return {split: ShardMaker(cfg, "synthetic", split, reader).make()
            for split in ("train", "test")}


def _batches(loader, epochs=2, start=0):
    out = []
    for _ in range(epochs):
        out += list(loader.iter_from(start))
    return out


def _assert_same(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_shard_dataset_reads_like_jax(jax_shards):
    ours, ref = shard_io.ShardDataset(jax_shards["train"]), jshard.ShardDataset(jax_shards["train"])
    assert len(ours) == len(ref) == 16 and ours.keys() == ref.keys()
    assert ours.record_nbytes == ref.record_nbytes
    for idx in (0, 4, 5, 15):
        _assert_same([ours.read_example(idx)], [ref.read_example(idx)])


@pytest.mark.parametrize("raw_images", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loaders_give_the_jax_batches(jax_shards, raw_images, shuffle):
    """The numpy and the native loader, from the start and from step 2,
    over two epochs (the shuffle order moves on per epoch)."""
    path = jax_shards["train"]
    kw = dict(snippet_len=5, shuffle=shuffle, seed=3, raw_images=raw_images)
    for start in (0, 2):
        ref = _batches(jshard.DatasetLoader(jshard.ShardDataset(path), 3, **kw), start=start)
        for ours in (shard_io.DatasetLoader(shard_io.ShardDataset(path), 3, **kw),
                     native_loader.NativeDatasetLoader(path, 3, num_threads=2, **kw)):
            _assert_same(_batches(ours, start=start), ref)


def test_example_batch_and_wrappers_match_jax(jax_shards):
    path = jax_shards["test"]
    ref = JPrefetchLoader(jshard.DatasetLoader(jshard.ShardDataset(path), 2, shuffle=False,
                                               raw_images=True))
    ours = native_loader.make_loader(path, 2, shuffle=False, raw_images=True)
    assert ours.kind == "native" and ours.steps_per_epoch == ref.steps_per_epoch
    _assert_same([example_batch(ours)], [ref.example_batch()])
    _assert_same(list(ours), list(ref))
    multi = native_loader.make_loader(path, 2, shuffle=False, raw_images=True, workers=3)
    assert isinstance(multi, native_loader.MultiWorkerLoader)
    _assert_same(list(multi.iter_from(1)), list(ref.iter_from(1)))


def test_native_reader_is_built_under_build(jax_shards):
    lib = native_loader.load_library()
    built = Path(lib._name)
    assert built.parent.parent == native_loader.BUILD_DIR
    assert not list(native_loader.SOURCE.parent.glob("*.so"))


def test_make_loader_falls_back_to_numpy(jax_shards, monkeypatch, capsys):
    def broken():
        raise RuntimeError("no g++")

    monkeypatch.setattr(native_loader, "load_library", broken)
    loader = native_loader.make_loader(jax_shards["test"], 2, shuffle=False)
    assert loader.kind == "numpy" and "numpy path" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        native_loader.make_loader(jax_shards["test"].parent / "absent", 2)


def test_chip_smoke_shards_have_the_jax_schema(jax_shards, tmp_path):
    chip_smoke.write_synthetic_shards(tmp_path, HEIGHT, WIDTH, {"train": 3, "test": 2})
    ref = json.loads((jax_shards["train"] / shard_io.CONFIG_NAME).read_text())
    for split, n in (("train", 3), ("test", 2)):
        ours = json.loads((tmp_path / f"synthetic_{split}" / shard_io.CONFIG_NAME).read_text())
        assert ours["schema"] == ref["schema"]
        assert (ours["length"], ours["split"], ours["imshape"]) == (n, split, ref["imshape"])
        batch = next(iter(jshard.DatasetLoader(
            jshard.ShardDataset(tmp_path / f"synthetic_{split}"), n, shuffle=False)))
        assert batch["image5d"].shape == (n, 5, HEIGHT, WIDTH, 3)
        assert np.all(np.abs(batch["image5d"]) <= 1.0)
