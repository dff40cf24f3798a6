"""The port's dataset readers against the JAX package's, on the fixture
trees the JAX tests build (KITTI raw and odometry, Cityscapes, A2D2,
DrivingStereo) and on Waymo segments (the fake SDK of
``tests/fake_waymo.py`` and true wire-format files): drive lists, frame
ranges, images, intrinsics, poses, point clouds, depth and stereo
extrinsics; the examples and shards built from them; the KITTI split
lists the port keeps a copy of; the static-frame tool.

Tolerance: bit for bit. Both sides decode the same files with the same
libraries and run the same numpy arithmetic; the RGB -> BGR swaps the
port does by slicing give ``cv2.cvtColor``'s bytes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_data_pipeline import DATE, DRIVE, kitti_tree  # noqa: F401
from test_readers_fixtures import (a2d2_dir, a2d2_dir_big, city_zips,  # noqa: F401
                                   city_zips_big, driving_dir, odom_tree)
from test_waymo_native import _full_frame, _make_laser_frame
from tests.fake_waymo import fake_sdk, make_frame_dict, write_segment
from xpt_mde_tpu import config as jconfig
from xpt_mde_tpu.data import list_static_frames as jstatic
from xpt_mde_tpu.data import readers as jreaders
from xpt_mde_tpu.data import shard_maker as jshard_maker
from xpt_mde_tpu.data.example_maker import ExampleMaker as JExampleMaker
from xpt_mde_tpu.data.readers import a2d2_reader as ja2d2
from xpt_mde_tpu.data.readers import city_reader as jcity
from xpt_mde_tpu.data.readers import driving_reader as jdriving
from xpt_mde_tpu.data.readers import kitti_reader as jkitti
from xpt_mde_tpu.data.readers import waymo_native as jwn
from xpt_mde_tpu.data.readers import waymo_reader as jwaymo
from xpt_mde_tpu_torch import config
from xpt_mde_tpu_torch.data import list_static_frames, readers, shard_maker
from xpt_mde_tpu_torch.data.example_maker import ExampleMaker
from xpt_mde_tpu_torch.data.readers import (a2d2_reader, city_reader, driving_reader,
                                            kitti_reader, waymo_native, waymo_reader)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "fixtures"
KITTI_MINI = FIXTURES / "kitti_mini"
METHODS = ("get_image", "get_pose", "get_point_cloud", "get_intrinsic")


def _outcome(fn, *args, **kwargs):
    """fn's result, or (exception class name, message) where it raises."""
    try:
        return fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001
        return (type(exc).__name__, str(exc))


def _assert_same(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), (what, got)
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert np.array_equal(got, want), what
    else:
        assert got == want, (what, got, want)


def _assert_same_readers(ours, ref, indices, rights=(False, True), stereo=True):
    for index in indices:
        for right in rights:
            for method in METHODS:
                _assert_same(_outcome(getattr(ours, method), index, right=right),
                             _outcome(getattr(ref, method), index, right=right),
                             (method, index, right))
        if stereo:
            _assert_same(_outcome(ours.get_stereo_extrinsic, index),
                         _outcome(ref.get_stereo_extrinsic, index), ("extrinsic", index))
        assert ours.index_to_id(index) == ref.index_to_id(index)


def _same_drives(ours, ref):
    drives = ref.list_drive_paths()
    assert [str(d) for d in ours.list_drive_paths()] == [str(d) for d in drives]
    return drives


def _init_both(ours, ref, drive):
    ours.init_drive(drive)
    ref.init_drive(drive)
    assert list(ours.get_range_()) == list(ref.get_range_())
    assert ours.num_frames_() == ref.num_frames_()
    assert ours.frame_names == ref.frame_names


def _assert_same_tree(got: Path, want: Path):
    names = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    assert names and names == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    for name in names:
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


def _assert_same_examples(dataset, split, shwc, keys, base, drive, indices):
    ours = ExampleMaker(dataset, split, shwc, keys, base)
    ref = JExampleMaker(dataset, split, shwc, keys, base)
    ours.init_reader(drive)
    ref.init_reader(drive)
    for index in indices:
        assert ours.make_snippet_ids(index) == ref.make_snippet_ids(index)
        got, want = _outcome(ours.get_example, index), _outcome(ref.get_example, index)
        if isinstance(want, tuple):
            assert got == want, index
            continue
        assert sorted(got) == sorted(want)
        for key in want:
            _assert_same(got[key], want[key], (dataset, index, key))


# --------------------------------------------------------------------------
# the copies and the registry


@pytest.mark.parametrize("name", ["README.md", "kitti_raw_static_frames.txt",
                                  "kitti_raw_test_scenes.txt", "kitti_raw_train_scenes.txt",
                                  "kitti_test_depth_frames.txt"])
def test_resources_are_byte_copies(name):
    ours = kitti_reader.RESOURCES / name
    assert ours.read_bytes() == (jkitti.RESOURCES / name).read_bytes()
    assert REPO / "xpt_mde_tpu_torch" in ours.parents


def test_waymo_protos_are_copies():
    ours = Path(waymo_native.__file__).parent / "waymo_protos"
    ref = Path(jwn.__file__).parent / "waymo_protos"
    assert (ours / "dataset_pb2.py").read_bytes() == (ref / "dataset_pb2.py").read_bytes()
    strip = [line for line in (ref / "dataset.proto").read_text().splitlines()
             if not line.startswith("//")]
    assert [line for line in (ours / "dataset.proto").read_text().splitlines()
            if not line.startswith("//")] == strip


@pytest.mark.parametrize("name", ["kitti_raw", "kitti_odom", "cityscapes", "a2d2", "waymo",
                                  "synthetic", "driving_stereo"])
def test_reader_factory_routes_as_jax(name, city_zips):  # noqa: F811
    base = city_zips if name == "cityscapes" else None
    ours, ref = readers.data_reader_factory(name, "train", base), \
        jreaders.data_reader_factory(name, "train", base)
    assert type(ours).__name__ == type(ref).__name__
    assert type(ours).__module__.startswith("xpt_mde_tpu_torch.")
    assert ours.split == ref.split == "train"
    with pytest.raises(ValueError, match="unknown dataset"):
        readers.data_reader_factory("nuscenes", "train")


# --------------------------------------------------------------------------
# KITTI


def test_kitti_calibration_and_oxts_match_jax(kitti_tree):  # noqa: F811
    for root in (KITTI_MINI / "2011_09_26", kitti_tree / DATE):
        parsed = {}
        for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt", "calib_imu_to_velo.txt"):
            got, want = kitti_reader.read_calib_file(root / name), jkitti.read_calib_file(root / name)
            assert sorted(got) == sorted(want)
            for key in want:
                _assert_same(got[key], want[key], (name, key))
            parsed[name] = want
        ours = kitti_reader.KittiCalib(*parsed.values())
        ref = jkitti.KittiCalib(*parsed.values())
        for key in ("K_cam2", "K_cam3", "T_cam2_velo", "T_cam3_velo", "stereo_T_LR",
                    "T_cam2_imu"):
            _assert_same(getattr(ours, key), getattr(ref, key), key)
    odom = {"P_rect_02": np.arange(12.0) + 1, "P_rect_03": np.arange(12.0) - 3,
            "R_rect_00": np.eye(3).reshape(-1)}
    _assert_same(kitti_reader.KittiCalib(odom).stereo_T_LR, jkitti.KittiCalib(odom).stereo_T_LR,
                 "odometry extrinsic")
    rows = np.random.RandomState(0).uniform(-1, 1, (6, 30))
    rows[:, :3] += [49.0, 8.4, 110.0]
    _assert_same(kitti_reader.oxts_to_pose(rows), jkitti.oxts_to_pose(rows), "oxts")


@pytest.mark.parametrize("tree", ["kitti_mini", "kitti_tree"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_kitti_raw_reader_matches_jax(tree, split, kitti_tree):  # noqa: F811
    base, drive = (KITTI_MINI, ("2011_09_26", "0001")) if tree == "kitti_mini" \
        else (kitti_tree, (DATE, DRIVE))
    ours, ref = kitti_reader.KittiRawReader(split, base), jkitti.KittiRawReader(split, base)
    _same_drives(ours, ref)
    _init_both(ours, ref, drive)
    indices = list(ref.get_range_())[:3] or [2, 3]
    _assert_same_readers(ours, ref, indices + [10 ** 6])


@pytest.mark.parametrize("split", ["train", "test"])
def test_kitti_odom_reader_matches_jax(split, odom_tree):  # noqa: F811
    ours, ref = kitti_reader.KittiOdomReader(split, odom_tree), \
        jkitti.KittiOdomReader(split, odom_tree)
    _same_drives(ours, ref)
    _init_both(ours, ref, "09")
    _assert_same_readers(ours, ref, [0, 2, 5, 7, 12])


def test_kitti_examples_match_jax(odom_tree, kitti_tree):  # noqa: F811
    keys = ["image", "intrinsic", "pose_gt", "image_R", "intrinsic_R", "stereo_T_LR"]
    _assert_same_examples("kitti_odom", "test", (5, 16, 48, 3), keys, odom_tree, "09",
                          range(8))
    keys = shard_maker.DEFAULT_DATA_KEYS["kitti_raw"] + ["depth_gt_R", "pose_gt_R"]
    _assert_same_examples("kitti_raw", "train", (5, 32, 96, 3), keys, kitti_tree,
                          (DATE, DRIVE), range(2, 10))


# --------------------------------------------------------------------------
# Cityscapes, A2D2, DrivingStereo


@pytest.mark.parametrize("fixture", ["city_zips", "city_zips_big"])
def test_cityscapes_reader_matches_jax(fixture, request):
    base = request.getfixturevalue(fixture)
    ours, ref = city_reader.CityscapesReader("train", base), jcity.CityscapesReader("train", base)
    drives = _same_drives(ours, ref)
    _init_both(ours, ref, drives[0])
    _assert_same_readers(ours, ref, list(ref.get_range_()))
    assert city_reader.CITY_CROP == jcity.CITY_CROP and city_reader.ZIP_NAMES == jcity.ZIP_NAMES


def test_cityscapes_examples_match_jax(city_zips_big):  # noqa: F811
    keys = ["image", "intrinsic", "image_R", "intrinsic_R", "depth_gt", "stereo_T_LR"]
    _assert_same_examples("cityscapes", "train", (5, 32, 96, 3), keys, city_zips_big,
                          "leftImg8bit_sequence/train/aachen/aachen", range(4, 10))


@pytest.mark.parametrize("fixture", ["a2d2_dir", "a2d2_dir_big"])
def test_a2d2_reader_matches_jax(fixture, request):
    base = request.getfixturevalue(fixture)
    ours, ref = a2d2_reader.A2D2Reader("train", base), ja2d2.A2D2Reader("train", base)
    drives = _same_drives(ours, ref)
    _init_both(ours, ref, drives[0])
    _assert_same_readers(ours, ref, list(ref.get_range_()) + [0, 1])
    keys = ["image", "intrinsic", "image_R", "intrinsic_R", "depth_gt", "depth_gt_R",
            "stereo_T_LR"]
    if fixture == "a2d2_dir_big":
        _assert_same_examples("a2d2", "train", (5, 32, 96, 3), keys, base, drives[0],
                              list(ref.get_range_()))


@pytest.mark.parametrize("lens", ["Telecam", "Fisheye", "Pinhole"])
def test_a2d2_undistort_matches_jax(lens):
    cam = {"CamMatrix": [[50.0, 0, 16], [0, 55, 8], [0, 0, 1]],
           "CamMatrixOriginal": [[52.0, 0, 15], [0, 56, 9], [0, 0, 1]],
           "Distortion": [0.05, -0.01, 0.001, 0.002] + ([] if lens == "Fisheye" else [0.0]),
           "Lens": lens, "Resolution": [32, 16],
           "view": {"x-axis": [1.0, 0.02, 0], "y-axis": [0, 1.0, 0.01], "origin": [0.1, 0, 0]}}
    cfg = {"cameras": {"front_left": cam, "front_right": dict(cam, view=dict(
        cam["view"], origin=[0.4, 0.01, 0]))}}
    ours, ref = a2d2_reader.SensorConfig(cfg), ja2d2.SensorConfig(cfg)
    image = np.random.RandomState(3).randint(0, 256, (16, 32, 3)).astype(np.uint8)
    _assert_same(ours.undistort_image(image, "front_left"),
                 ref.undistort_image(image, "front_left"), lens)
    _assert_same(ours.get_stereo_extrinsic(), ref.get_stereo_extrinsic(), "T_LR")
    _assert_same(ours.get_resolution_hw("front_left"), ref.get_resolution_hw("front_left"),
                 "resolution")


def test_driving_stereo_reader_and_examples_match_jax(driving_dir):  # noqa: F811
    ours, ref = driving_reader.DrivingStereoReader("train", driving_dir), \
        jdriving.DrivingStereoReader("train", driving_dir)
    drives = _same_drives(ours, ref)
    _init_both(ours, ref, drives[0])
    _assert_same_readers(ours, ref, [0, 2, 3, 5])
    keys = shard_maker.DEFAULT_DATA_KEYS["driving_stereo"]
    _assert_same_examples("driving_stereo", "test", (5, 16, 48, 3), keys, driving_dir,
                          drives[0], [2, 3])


# --------------------------------------------------------------------------
# Waymo


@pytest.fixture()
def fake_drive(tmp_path):
    drive_dir = tmp_path / "training_0000"
    drive_dir.mkdir()
    frames = [make_frame_dict(i) for i in range(30)]
    frames[5]["time_of_day"] = "Night"
    write_segment(drive_dir / "segment-0.tfrecord", frames)
    return tmp_path, drive_dir


def test_waymo_reader_on_the_fake_sdk_matches_jax(fake_drive):
    base, drive = fake_drive
    ours = waymo_reader.WaymoReader("train", base, sdk=fake_sdk())
    ref = jwaymo.WaymoReader("train", base, sdk=fake_sdk())
    _same_drives(ours, ref)
    _init_both(ours, ref, drive)
    # in streaming order: the Night frame, eviction after frame 25, the end
    _assert_same_readers(ours, ref, [2, 3, 4, 5, 6, 25, 2, 10, 99], rights=(False,))
    assert ours.get_image(3, right=True) is None and ours.get_stereo_extrinsic() is None
    assert np.array_equal(waymo_reader.T_C2V, jwaymo.T_C2V)


@pytest.fixture()
def native_segments(tmp_path):
    """Wire-format segments (``test_waymo_native._full_frame``): one train
    and one validation drive of 12 frames, frame 5 at night."""
    for name in ("training_0000", "validation_0000"):
        drive = tmp_path / name
        drive.mkdir()
        frames = [_full_frame(i) for i in range(12)]
        frames[5].context.stats.time_of_day = "Night"
        waymo_native.write_tfrecord_file(drive / "segment-0.tfrecord",
                                         [f.SerializeToString() for f in frames])
    return tmp_path


def test_waymo_reader_native_matches_jax(native_segments):
    for split in ("train", "test"):
        ours, ref = waymo_reader.WaymoReader(split, native_segments), \
            jwaymo.WaymoReader(split, native_segments)
        drives = _same_drives(ours, ref)
        _init_both(ours, ref, drives[0])
        _assert_same_readers(ours, ref, [2, 3, 4, 5, 6, 11, 12], rights=(False,))


def test_waymo_examples_and_shards_match_jax(native_segments, tmp_path):
    """The test split (no static-sequence check: the frames are solid
    colour) through ExampleMaker and ShardMaker."""
    keys = shard_maker.DEFAULT_DATA_KEYS["waymo"]
    drive = native_segments / "validation_0000"
    _assert_same_examples("waymo", "test", (5, 16, 24, 3), keys, native_segments, drive,
                          range(2, 10))
    cfg = config.Config(datapath=str(tmp_path / "port"),
                        image_size_overrides={"waymo": (16, 24)})
    jcfg = jconfig.Config(datapath=str(tmp_path / "jax"),
                          image_size_overrides={"waymo": (16, 24)})
    _assert_same_tree(shard_maker.ShardMaker(cfg, "waymo", "test", native_segments).make(),
                      jshard_maker.ShardMaker(jcfg, "waymo", "test", native_segments).make())


def test_waymo_native_parsing_matches_jax(tmp_path):
    for data in (b"", b"123456789", bytes(range(256)) * 3):
        assert waymo_native.crc32c(data) == jwn.crc32c(data)
        assert waymo_native.masked_crc32c(data) == jwn.masked_crc32c(data)
    records = [b"alpha", b"", np.arange(40, dtype=np.uint8).tobytes()]
    waymo_native.write_tfrecord_file(tmp_path / "ours.tfrecord", records)
    jwn.write_tfrecord_file(tmp_path / "ref.tfrecord", records)
    assert (tmp_path / "ours.tfrecord").read_bytes() == (tmp_path / "ref.tfrecord").read_bytes()
    assert list(waymo_native.read_tfrecord_file(tmp_path / "ref.tfrecord")) == records
    rng = np.random.RandomState(2)
    yaw = 0.3
    extrinsic = np.eye(4)
    extrinsic[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    extrinsic[:3, 3] = [1.0, 0.2, 1.8]
    frames = [_full_frame(3),
              _make_laser_frame(rng.uniform(1, 50, (2, 8)).astype(np.float32), extrinsic),
              _make_laser_frame(rng.uniform(1, 50, (2, 6)).astype(np.float32),
                                top_pose=rng.uniform(-0.1, 0.1, (2, 6, 6)).astype(np.float32),
                                frame_pose=extrinsic)]
    for frame in frames:
        parsed = waymo_native.parse_range_image_and_camera_projection(frame)
        want = jwn.parse_range_image_and_camera_projection(frame)
        for got_part, want_part in zip(parsed, want):
            if isinstance(want_part, dict):
                assert sorted(got_part) == sorted(want_part)
                for key in want_part:
                    for a, b in zip(got_part[key], want_part[key], strict=True):
                        _assert_same(a, b, "range image")
            elif want_part is not None:
                _assert_same(got_part, want_part, "top pose")
        points, cps = waymo_native.convert_range_image_to_point_cloud(frame, *parsed[:2],
                                                                      parsed[3])
        jpoints, jcps = jwn.convert_range_image_to_point_cloud(frame, *want[:2], want[3])
        for a, b in zip(points + cps, jpoints + jcps, strict=True):
            _assert_same(a, b, "points")
    angles = rng.uniform(-1, 1, (3, 4, 3))
    _assert_same(waymo_native._rotation_zyx(*angles.T), jwn._rotation_zyx(*angles.T), "zyx")


# --------------------------------------------------------------------------
# the static-frame tool


def test_list_static_frames_matches_jax(tmp_path):
    """A sequence that moves for 4 frames and then stands still: both
    tools flag the same frames with the same flow ratios."""
    seq = tmp_path / "sequences" / "00"
    (seq / "image_2").mkdir(parents=True)
    rng = np.random.RandomState(0)
    texture = cv2.GaussianBlur(rng.randint(0, 256, (64, 160, 3)).astype(np.uint8), (5, 5), 0)
    for i in range(8):
        shift = 6 * min(i, 4)
        cv2.imwrite(str(seq / "image_2" / f"{i:06d}.png"), texture[:, shift:shift + 96])
    got = list_static_frames.list_static_frames(seq, threshold=0.05)
    assert got == jstatic.list_static_frames(seq, threshold=0.05)
    assert got and got[0] >= 5
    a, b = cv2.imread(str(seq / "image_2" / "000000.png")), \
        cv2.imread(str(seq / "image_2" / "000002.png"))
    assert list_static_frames.flow_valid_ratio(a, b) == jstatic.flow_valid_ratio(a, b)
    list_static_frames.main(tmp_path, tmp_path / "ours.txt")
    jstatic.main(tmp_path, tmp_path / "ref.txt")
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "ref.txt").read_text()


def test_readers_import_opencv_only_where_they_decode():
    """Importing every reader module loads neither OpenCV nor PIL: they
    import them where a file is decoded."""
    import subprocess
    import textwrap

    code = textwrap.dedent("""
        import sys
        for name in ("cv2", "PIL"):
            sys.modules[name] = None
        from xpt_mde_tpu_torch.data import list_static_frames
        from xpt_mde_tpu_torch.data.readers import (a2d2_reader, city_reader, driving_reader,
                                                    kitti_reader, waymo_native, waymo_reader)
        import numpy as np
        calib = kitti_reader.KittiCalib({"P_rect_02": np.ones(12), "P_rect_03": np.ones(12),
                                         "R_rect_00": np.eye(3).reshape(-1)})
        print("READERS OK", calib.stereo_T_LR.shape)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "READERS OK (4, 4)" in proc.stdout
