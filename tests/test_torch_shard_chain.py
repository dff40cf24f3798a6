"""The port's shard chain against the JAX package: ``image_ops`` against
OpenCV, ``depth_map``, ``SyntheticReader``, ``ExampleMaker`` (on the
checked-in KITTI sample and its golden arrays), ``ShardMaker``,
``generate_validation_shards`` and ``convert_to_shards``.

Tolerance: bit for bit everywhere. The port runs the JAX modules'
arithmetic in the same order, so every array is ``np.array_equal`` and
every shard file has the same bytes; ``image_ops`` computes OpenCV's
fixed-point uint8 results exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_data_pipeline import DATE, DRIVE, kitti_tree  # noqa: F401
from test_readers_fixtures import city_zips_big  # noqa: F401
from xpt_mde_tpu import config as jconfig
from xpt_mde_tpu.data import depth_map as jdepth
from xpt_mde_tpu.data import shard_maker as jshard_maker
from xpt_mde_tpu.data.example_maker import ExampleMaker as JExampleMaker
from xpt_mde_tpu.data.synthetic import SyntheticReader as JSyntheticReader
from xpt_mde_tpu_torch import config
from xpt_mde_tpu_torch.data import depth_map, image_ops, shard_maker
from xpt_mde_tpu_torch.data.example_maker import ExampleMaker
from xpt_mde_tpu_torch.data.shard_io import ShardDataset
from xpt_mde_tpu_torch.data.synthetic import SyntheticReader

FIXTURES = Path(__file__).parent / "fixtures"
KITTI_KEYS = ["image", "intrinsic", "depth_gt", "pose_gt", "image_R", "intrinsic_R",
              "stereo_T_LR"]
SHWC = (5, 32, 96, 3)


def _assert_same_example(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


def _assert_same_tree(got: Path, want: Path):
    """Every file under ``want`` has a twin under ``got`` with the same
    bytes, and no other file is there."""
    names = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    assert names
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


# --------------------------------------------------------------------------
# image_ops against OpenCV


RESIZES = [
    ((64, 128), (192, 384)),   # the synthetic reader's frames to Config()'s 128x384 aspect
    ((375, 1242), (32, 106)),  # a KITTI frame to a 32-high snippet
    ((375, 1242), (128, 424)),
    ((64, 128), (32, 64)),     # exactly 2x down: OpenCV's area path
    ((128, 512), (64, 256)),
    ((40, 60), (40, 60)),      # the identity
    ((33, 47), (66, 94)),      # 2x up
    ((10, 13), (23, 31)),
    ((100, 200), (37, 71)),
    ((128, 464), (32, 116)),   # a cropped Cityscapes frame
    ((40, 60), (40, 90)),      # one axis only
    ((7, 9), (3, 4)),
    ((1, 5), (3, 7)),
]


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("src_hw,dst_hw", RESIZES)
def test_resize_linear_matches_cv2(src_hw, dst_hw, channels):
    rng = np.random.RandomState(src_hw[0] * 1000 + dst_hw[1])
    shape = src_hw + ((channels,) if channels == 3 else ())
    image = rng.randint(0, 256, shape).astype(np.uint8)
    want = cv2.resize(image, (dst_hw[1], dst_hw[0]))
    got = image_ops.resize_linear(image, (dst_hw[1], dst_hw[0]))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got.astype(int) - want.astype(int)).max()


def test_resize_linear_matches_cv2_on_random_shapes():
    rng = np.random.RandomState(0)
    for _ in range(300):
        h, w = rng.randint(1, 60, 2)
        dh, dw = rng.randint(1, 120, 2)
        image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.resize(image, (int(dw), int(dh)))
        assert np.array_equal(image_ops.resize_linear(image, (int(dw), int(dh))), want), \
            ((h, w), (dh, dw))
    with pytest.raises(TypeError, match="uint8"):
        image_ops.resize_linear(np.zeros((4, 4), np.float32), (2, 2))


@pytest.mark.parametrize("shape", [(32, 96, 3), (160, 96, 3), (5, 7, 3), (2, 2, 3), (9, 11)])
def test_gaussian_blur3_matches_cv2(shape):
    image = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    once = cv2.GaussianBlur(image, (3, 3), 0)
    assert np.array_equal(image_ops.gaussian_blur3(image), once)
    # the static-sequence check blurs twice
    assert np.array_equal(image_ops.gaussian_blur3(image_ops.gaussian_blur3(image)),
                          cv2.GaussianBlur(once, (3, 3), 0))


# --------------------------------------------------------------------------
# depth maps


def _cloud(seed, n=400):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(-8, 8, n), rng.uniform(-2, 2, n),
                     rng.uniform(-1, 40, n)], 1)


def test_depth_map_functions_match_jax():
    k = np.array([[50, 0, 48], [0, 50, 16], [0, 0, 1]], np.float64)
    for seed in range(3):
        cloud = _cloud(seed)
        got = depth_map.point_cloud_to_depth_map(cloud, k, (32, 96))
        want = jdepth.point_cloud_to_depth_map(cloud, k, (32, 96))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(depth_map.depth_map_to_point_cloud(got, k),
                              jdepth.depth_map_to_point_cloud(want, k))
        for dst in ((16, 48), (11, 30), (64, 192)):
            assert np.array_equal(depth_map.resize_depth_map(got, (32, 96), dst),
                                  jdepth.resize_depth_map(want, (32, 96), dst))
    # behind the camera only: an empty map on both sides
    behind = _cloud(0) * [1, 1, -1]
    assert np.array_equal(depth_map.point_cloud_to_depth_map(behind, k, (8, 8)),
                          jdepth.point_cloud_to_depth_map(behind, k, (8, 8)))
    # the subsampling of maps over 1e6 pixels
    big = np.random.RandomState(5).uniform(0, 30, (1001, 1000)).astype(np.float32)
    assert np.array_equal(depth_map.depth_map_to_point_cloud(big, k),
                          jdepth.depth_map_to_point_cloud(big, k))


def test_depth_map_round_trip():
    """A sparse map (every third pixel) to points and back is the same map:
    each point lands on its pixel's centre, so its own pixel takes weight
    ~1 and its neighbours under 0.5."""
    k = np.array([[60, 0, 48], [0, 60, 16], [0, 0, 1]], np.float64)
    dense = np.random.RandomState(1).uniform(2, 60, (32, 96)).astype(np.float32)
    sparse = np.zeros_like(dense)
    sparse[1:-1:3, 1:-1:3] = dense[1:-1:3, 1:-1:3]
    cloud = depth_map.depth_map_to_point_cloud(sparse, k)
    assert cloud.shape == (int((sparse > 0).sum()), 3)
    back = depth_map.point_cloud_to_depth_map(cloud, k, (32, 96))
    np.testing.assert_allclose(back, sparse, rtol=1e-6)
    # the JAX package's round trip test on the port
    k2 = np.array([[50, 0, 48], [0, 50, 16], [0, 0, 1]], np.float64)
    depth = depth_map.point_cloud_to_depth_map(np.array([[0.0, 0.0, 10.0], [0.96, 0.4, 20.0]]),
                                               k2, (32, 96))
    assert np.isclose(depth[16, 48], 10.0) and np.isclose(depth[17, 50], 20.0)
    lone = depth_map.point_cloud_to_depth_map(np.array([[1.0, 0.5, 20.0]]), k2, (32, 96))
    assert lone.sum() == 0.0
    # the sparse-aware resize keeps a constant map's value where it has any
    half = depth_map.resize_depth_map(np.full((32, 96), 7.0, np.float32), (32, 96), (16, 48))
    assert half.shape == (16, 48, 1) and np.all(half == 7.0)


# --------------------------------------------------------------------------
# the synthetic reader


@pytest.mark.parametrize("options", [None, {"height": 32, "width": 48, "num_frames": 7,
                                            "drives": 3, "step_m": 0.8, "depth_m": 6.0}])
def test_synthetic_reader_matches_jax(options):
    ours, ref = SyntheticReader("train", options), JSyntheticReader("train", options)
    assert ours.list_drive_paths() == ref.list_drive_paths()
    for drive in ref.list_drive_paths():
        ours.init_drive(drive)
        ref.init_drive(drive)
        assert ours.frame_names == ref.frame_names and ours.num_frames_() == ref.num_frames_()
        assert list(ours.get_range_()) == list(ref.get_range_())
        for index in (0, 2, ref.num_frames_() - 1):
            for method in ("get_image", "get_pose", "get_point_cloud", "get_intrinsic"):
                got, want = getattr(ours, method)(index), getattr(ref, method)(index)
                assert got.dtype == want.dtype and np.array_equal(got, want), method
        assert ours.get_image(2, right=True) is None and ours.get_stereo_extrinsic() is None
        assert ours.index_to_id(3) == 3


# --------------------------------------------------------------------------
# ExampleMaker


@pytest.fixture(scope="module")
def kitti_mini_makers():
    pair = []
    for cls in (ExampleMaker, JExampleMaker):
        maker = cls("kitti_raw", "train", SHWC, KITTI_KEYS, FIXTURES / "kitti_mini")
        maker.init_reader(("2011_09_26", "0001"))
        pair.append(maker)
    return pair


def test_example_maker_matches_kitti_mini_golden(kitti_mini_makers):
    """The reader + maker chain on the checked-in KITTI sample equals the
    committed arrays bit for bit: decode, resize, crop, intrinsics, OXTS
    poses, LiDAR splatting, stereo extrinsics."""
    golden = dict(np.load(FIXTURES / "kitti_mini_golden.npz"))
    _assert_same_example(kitti_mini_makers[0].get_example(4), golden)


def test_example_maker_matches_jax_on_kitti_mini(kitti_mini_makers):
    ours, ref = kitti_mini_makers
    assert list(ours.get_range()) == list(ref.get_range())
    assert ours.max_frame_id == ref.max_frame_id and ours.num_frames() == ref.num_frames()
    for index in ref.get_range():
        assert ours.make_snippet_ids(index) == ref.make_snippet_ids(index)
        _assert_same_example(ours.get_example(index), ref.get_example(index))


def test_example_maker_helpers_match_jax():
    for raw, dst in (((375, 1242), (128, 512)), ((64, 128), (128, 384)), ((750, 2000), (192, 512)),
                     ((128, 512), (128, 512)), ((100, 100), (32, 96)), ((300, 100), (64, 64))):
        assert ExampleMaker.get_resize_shape(raw, dst) == JExampleMaker.get_resize_shape(raw, dst)
    k = np.array([[700.0, 0, 600], [0, 710, 180], [0, 0, 1]])
    assert np.array_equal(ExampleMaker.rescale_intrinsic(k, (375, 1242), (128, 424)),
                          JExampleMaker.rescale_intrinsic(k, (375, 1242), (128, 424)))
    for dataset in ("kitti_raw", "kitti_odom", "a2d2", "cityscapes", "driving_stereo",
                    "synthetic", "waymo"):
        ours = ExampleMaker(dataset, "train", SHWC, ["image"])
        ref = JExampleMaker(dataset, "train", SHWC, ["image"])
        for rsz in ((48, 96), (32, 128), (32, 96)):
            try:
                want = ref.get_crop_range(rsz)
            except ValueError:
                with pytest.raises(ValueError, match="crop"):
                    ours.get_crop_range(rsz)
                continue
            assert ours.get_crop_range(rsz) == want


def test_example_maker_skips_as_jax():
    """The static-sequence check and the Waymo motion check raise the
    port's RecoverableSkip where the JAX package's raise its own."""
    from xpt_mde_tpu_torch.utils.util_class import RecoverableSkip

    still = {"image": np.tile(np.random.RandomState(0).randint(0, 256, (32, 96, 3)),
                              (5, 1, 1)).astype(np.uint8)}
    for cls in (ExampleMaker, JExampleMaker):
        with pytest.raises(Exception, match="static sequence") as info:
            cls("kitti_raw", "train", SHWC, ["image"]).check_static_sequence(still)
        assert (info.type is RecoverableSkip) == (cls is ExampleMaker)
    for distance, message in ((0.1, "not moving"), (11.0, "scene change")):
        poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        poses[:, 0, 3] = [distance, 1.0, 2.0, 3.0] if distance < 1 else [1.0, 2.0, 3.0, distance]
        with pytest.raises(RecoverableSkip, match=message):
            ExampleMaker("waymo", "train", SHWC, ["pose_gt"]).verify_snippet({"pose_gt": poses})
        kept = ExampleMaker("kitti_raw", "train", SHWC, ["pose_gt"]).verify_snippet(
            {"pose_gt": poses})
        assert kept["pose_gt"] is poses


# --------------------------------------------------------------------------
# ShardMaker, validation shards, convert_to_shards


def _configs(root, **kwargs):
    return (config.Config(datapath=str(root / "port"), **kwargs),
            jconfig.Config(datapath=str(root / "jax"), **kwargs))


def test_synthetic_shards_match_jax(tmp_path):
    cfg, jcfg = _configs(tmp_path, image_size_overrides={"synthetic": (32, 96)},
                         validation_frames=5)
    maker = shard_maker.ShardMaker(cfg, "synthetic", "train", None)
    out = maker.make()
    want = jshard_maker.ShardMaker(jcfg, "synthetic", "train", None).make()
    _assert_same_tree(out, want)
    assert maker.build_mode == "serial"
    ex = ShardDataset(out).read_example(0)
    assert ex["image"].shape == (5 * 32, 96, 3) and ex["pose_gt"].shape == (4, 4, 4)
    assert np.allclose(ex["depth_gt"][ex["depth_gt"] > 0], 10.0, atol=0.5)
    # idempotent: a second make() skips
    again = shard_maker.ShardMaker(cfg, "synthetic", "train", None)
    assert again.make() == out and again.build_mode == "skipped"
    _assert_same_tree(shard_maker.generate_validation_shards(cfg, "synthetic"),
                      jshard_maker.generate_validation_shards(jcfg, "synthetic"))


def test_kitti_raw_shards_and_validation_match_jax(kitti_tree, tmp_path):  # noqa: F811
    cfg, jcfg = _configs(tmp_path, validation_frames=3,
                         image_size_overrides={"kitti_raw": (32, 96)})
    keys = ["image", "intrinsic", "depth_gt", "pose_gt", "image_R", "stereo_T_LR"]
    out = shard_maker.ShardMaker(cfg, "kitti_raw", "train", kitti_tree, data_keys=keys,
                                 drives=[(DATE, DRIVE)], frames_per_drive=5).make()
    want = jshard_maker.ShardMaker(jcfg, "kitti_raw", "train", kitti_tree, data_keys=keys,
                                   drives=[(DATE, DRIVE)], frames_per_drive=5).make()
    _assert_same_tree(out, want)
    # the drive has no frame in the Eigen test list: both builds refuse
    for maker in (shard_maker.ShardMaker(cfg, "kitti_raw", "test", kitti_tree,
                                         drives=[(DATE, DRIVE)]),
                  jshard_maker.ShardMaker(jcfg, "kitti_raw", "test", kitti_tree,
                                          drives=[(DATE, DRIVE)])):
        with pytest.raises(RuntimeError, match="no examples"):
            maker.make()
    _assert_same_tree(shard_maker.generate_validation_shards(cfg, "kitti_raw"),
                      jshard_maker.generate_validation_shards(jcfg, "kitti_raw"))
    assert len(ShardDataset(Path(cfg.datapath_shd) / "kitti_raw_val")) == 3


def test_cityscapes_shards_match_jax(city_zips_big, tmp_path):  # noqa: F811
    cfg, jcfg = _configs(tmp_path, image_size_overrides={"cityscapes": (32, 96)})
    drives = ["leftImg8bit_sequence/train/aachen/aachen"]
    keys = ["image", "intrinsic", "depth_gt", "image_R", "intrinsic_R", "stereo_T_LR"]
    out = shard_maker.ShardMaker(cfg, "cityscapes", "train", city_zips_big, data_keys=keys,
                                 drives=drives).make()
    want = jshard_maker.ShardMaker(jcfg, "cityscapes", "train", city_zips_big, data_keys=keys,
                                   drives=drives).make()
    _assert_same_tree(out, want)
    assert len(ShardDataset(out)) == 6


def test_parallel_build_matches_serial_and_jax(kitti_tree, tmp_path):  # noqa: F811
    """Drives over the spawn pool give the serial build's bytes (and the
    JAX package's); the pool really ran, and its workers loaded no torch
    (KITTI's reader decodes its PNGs with OpenCV; the synthetic drives
    load neither OpenCV nor PIL)."""
    outs = {}
    for mode, workers in (("serial", 0), ("pool", 2)):
        cfg = config.Config(datapath=str(tmp_path / mode), shard_build_workers=workers,
                            image_size_overrides={"kitti_raw": (32, 96)})
        maker = shard_maker.ShardMaker(cfg, "kitti_raw", "train", kitti_tree,
                                       data_keys=["image", "intrinsic"],
                                       drives=[(DATE, DRIVE), (DATE, DRIVE)])
        outs[mode] = maker.make()
        assert maker.build_mode == mode
    assert maker.worker_modules == {"cv2"}
    _assert_same_tree(outs["pool"], outs["serial"])
    assert len(list(outs["serial"].glob("*.vrec"))) >= 1
    jcfg = jconfig.Config(datapath=str(tmp_path / "jax"),
                          image_size_overrides={"kitti_raw": (32, 96)})
    _assert_same_tree(outs["pool"], jshard_maker.ShardMaker(
        jcfg, "kitti_raw", "train", kitti_tree, data_keys=["image", "intrinsic"],
        drives=[(DATE, DRIVE), (DATE, DRIVE)]).make())
    synthetic = {}
    for mode, workers in (("serial", 0), ("pool", 2)):
        cfg = config.Config(datapath=str(tmp_path / "synthetic" / mode),
                            shard_build_workers=workers,
                            image_size_overrides={"synthetic": (16, 48)})
        maker = shard_maker.ShardMaker(cfg, "synthetic", "train", {"height": 16, "width": 32})
        synthetic[mode] = maker.make()
        assert maker.build_mode == mode
    assert maker.worker_modules == set()
    _assert_same_tree(synthetic["pool"], synthetic["serial"])


def test_convert_to_shards_matches_jax(tmp_path):
    cfg, jcfg = _configs(tmp_path, image_size_overrides={"synthetic": (16, 48)},
                         validation_frames=4)
    paths = {"synthetic": {"drives": 2, "num_frames": 7, "height": 16, "width": 32}}
    modes = shard_maker.convert_to_shards(cfg, paths, {"synthetic": ["train", "test"]},
                                          frames_per_drive=2)
    jshard_maker.convert_to_shards(jcfg, paths, {"synthetic": ["train", "test"]},
                                   frames_per_drive=2)
    assert modes == {"synthetic_train": "serial", "synthetic_test": "serial"}
    _assert_same_tree(Path(cfg.datapath_shd), Path(jcfg.datapath_shd))
    # total_frame_limit stops after the drive that reaches it, as in JAX
    cfg, jcfg = _configs(tmp_path / "limit", image_size_overrides={"synthetic": (16, 48)})
    shard_maker.convert_to_shards(cfg, paths, total_frame_limit=2)
    jshard_maker.convert_to_shards(jcfg, paths, total_frame_limit=2)
    _assert_same_tree(Path(cfg.datapath_shd), Path(jcfg.datapath_shd))
    assert shard_maker.DEFAULT_DATA_KEYS == jshard_maker.DEFAULT_DATA_KEYS


def test_shard_chain_imports_neither_torch_nor_opencv():
    """The modules that build synthetic shards are host numpy: a fresh
    interpreter that imports them and builds a drive loads neither torch
    nor OpenCV nor PIL."""
    import subprocess
    import textwrap

    code = textwrap.dedent("""
        import sys, tempfile
        from xpt_mde_tpu_torch.config import Config
        from xpt_mde_tpu_torch.data import depth_map, example_maker, image_ops, shard_maker
        from xpt_mde_tpu_torch.data.readers import data_reader_factory, reader_base
        from xpt_mde_tpu_torch.data.synthetic import SyntheticReader
        with tempfile.TemporaryDirectory() as root:
            cfg = Config(datapath=root, image_size_overrides={"synthetic": (16, 48)})
            shard_maker.ShardMaker(cfg, "synthetic", "train", {"drives": 1}).make()
        print(sorted(m for m in ("torch", "cv2", "PIL", "jax", "xpt_mde_tpu") if m in sys.modules))
    """)
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
