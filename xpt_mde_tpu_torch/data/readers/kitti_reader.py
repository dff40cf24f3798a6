"""KITTI raw and odometry readers, native parsing (port of
``xpt_mde_tpu.data.readers.kitti_reader``). Images are decoded with
OpenCV (``cv2.imread``, BGR), imported where a frame is read; the
calibration, pose and velodyne parsing is numpy. The conventions are the
KITTI devkit's:

- rectified camera N: ``K_camN = P_rect_0N[:3, :3]``;
  ``T_camN_velo = T_N @ R_rect_00 @ T_cam0_velo`` with
  ``T_N[0, 3] = P_rect_0N[0, 3] / P_rect_0N[0, 0]``;
- OXTS packet -> ``T_w_imu`` via the Mercator projection with scale
  ``cos(lat0)``;
- camera-to-world pose: ``T_w_cam2 = T_w_imu @ inv(T_cam2_imu)``;
- stereo extrinsic: ``T_cam2_cam3 = T_cam2_velo @ inv(T_cam3_velo)``;
- the train split drops static frames (SfMLearner's list) and the 2
  first and last frames; the test split reads the Eigen depth-frame list.
  The lists are this package's copy of the JAX package's
  ``data/resources`` (``tests/test_torch_readers.py`` holds them equal).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.data.readers.reader_base import DataReaderBase
from xpt_mde_tpu_torch.utils.util_class import RecoverableSkip

RESOURCES = Path(__file__).resolve().parent.parent / "resources"
EARTH_RADIUS = 6378137.0


# --------------------------------------------------------------------------
# calibration parsing


def read_calib_file(path) -> dict:
    """Parse 'key: v1 v2 ...' calibration text files."""
    data = {}
    for line in Path(path).read_text().splitlines():
        if ":" not in line:
            continue
        key, val = line.split(":", 1)
        try:
            data[key.strip()] = np.array(
                [float(x) for x in val.strip().split()])
        except ValueError:
            pass  # non-numeric entries (e.g. calib_time)
    return data


def _rt_to_mat(rot9: np.ndarray, trans3: np.ndarray) -> np.ndarray:
    mat = np.eye(4)
    mat[:3, :3] = rot9.reshape(3, 3)
    mat[:3, 3] = trans3
    return mat


class KittiCalib:
    """Rectified-camera calibration chain for one KITTI date dir."""

    def __init__(self, cam2cam: dict, velo2cam: dict | None = None,
                 imu2velo: dict | None = None):
        self.K_cam2 = cam2cam["P_rect_02"].reshape(3, 4)[:3, :3].copy()
        self.K_cam3 = cam2cam["P_rect_03"].reshape(3, 4)[:3, :3].copy()

        r_rect = np.eye(4)
        r_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
        if velo2cam is not None:
            t_cam0_velo = _rt_to_mat(velo2cam["R"], velo2cam["T"])
            self.T_cam2_velo = self._cam_n_velo(cam2cam, "02", r_rect,
                                                t_cam0_velo)
            self.T_cam3_velo = self._cam_n_velo(cam2cam, "03", r_rect,
                                                t_cam0_velo)
            self.stereo_T_LR = self.T_cam2_velo @ np.linalg.inv(self.T_cam3_velo)
        else:
            self.T_cam2_velo = self.T_cam3_velo = None
            # odometry: derive the stereo extrinsic from projection offsets
            # T_cam2_cam3 = T2 @ inv(T3) with T_N[0,3] = P_rect_0N[0,3]/fx,
            # so the x-translation is t2 - t3 (positive ~0.47 m: a point's
            # x-coordinate grows when expressed in the left frame)
            t2 = cam2cam["P_rect_02"].reshape(3, 4)[0, 3] / self.K_cam2[0, 0]
            t3 = cam2cam["P_rect_03"].reshape(3, 4)[0, 3] / self.K_cam3[0, 0]
            self.stereo_T_LR = np.eye(4)
            self.stereo_T_LR[0, 3] = t2 - t3
        if imu2velo is not None and self.T_cam2_velo is not None:
            t_velo_imu = _rt_to_mat(imu2velo["R"], imu2velo["T"])
            self.T_cam2_imu = self.T_cam2_velo @ t_velo_imu
        else:
            self.T_cam2_imu = None

    @staticmethod
    def _cam_n_velo(cam2cam, n, r_rect, t_cam0_velo):
        p_rect = cam2cam[f"P_rect_{n}"].reshape(3, 4)
        t_n = np.eye(4)
        t_n[0, 3] = p_rect[0, 3] / p_rect[0, 0]
        return t_n @ r_rect @ t_cam0_velo


# --------------------------------------------------------------------------
# OXTS -> pose


def oxts_to_pose(oxts_rows: np.ndarray) -> np.ndarray:
    """Convert [N, >=6] OXTS packets (lat lon alt roll pitch yaw ...) into
    [N, 4, 4] T_w_imu transforms (KITTI devkit Mercator math)."""
    lat, lon, alt = oxts_rows[:, 0], oxts_rows[:, 1], oxts_rows[:, 2]
    roll, pitch, yaw = oxts_rows[:, 3], oxts_rows[:, 4], oxts_rows[:, 5]
    scale = np.cos(lat[0] * np.pi / 180.0)
    tx = scale * lon * np.pi * EARTH_RADIUS / 180.0
    ty = scale * EARTH_RADIUS * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    tz = alt

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        m = np.tile(np.eye(3), (len(a), 1, 1))
        m[:, 1, 1], m[:, 1, 2], m[:, 2, 1], m[:, 2, 2] = c, -s, s, c
        return m

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        m = np.tile(np.eye(3), (len(a), 1, 1))
        m[:, 0, 0], m[:, 0, 2], m[:, 2, 0], m[:, 2, 2] = c, s, -s, c
        return m

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        m = np.tile(np.eye(3), (len(a), 1, 1))
        m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
        return m

    rot = rz(yaw) @ ry(pitch) @ rx(roll)
    poses = np.tile(np.eye(4), (len(lat), 1, 1))
    poses[:, :3, :3] = rot
    poses[:, 0, 3] = tx
    poses[:, 1, 3] = ty
    poses[:, 2, 3] = tz
    return poses


# --------------------------------------------------------------------------
# readers


class KittiRawReader(DataReaderBase):
    """KITTI raw: drives under <base>/<date>/<date>_drive_<id>_sync."""

    def __init__(self, split: str = "train", base_path=None):
        super().__init__(split, base_path)
        self.calib: KittiCalib | None = None
        self.drive_dir: Path | None = None
        self.poses_imu: np.ndarray | None = None
        self.target_frame_ids: list[int] = []

    def list_drive_paths(self):
        scenes_file = RESOURCES / f"kitti_raw_{'test' if self.split == 'test' else 'train'}_scenes.txt"
        drives = []
        for line in scenes_file.read_text().splitlines():
            line = line.strip()
            if line:
                date, drive = line.split()[:2] if " " in line else (line[:10], line[-9:-5])
                drives.append((date, drive))
        return drives

    def init_drive(self, drive_path):
        date, drive_id = drive_path
        base = Path(self.base_path)
        self.drive_dir = base / date / f"{date}_drive_{drive_id}_sync"
        cam2cam = read_calib_file(base / date / "calib_cam_to_cam.txt")
        velo2cam = read_calib_file(base / date / "calib_velo_to_cam.txt")
        imu2velo = read_calib_file(base / date / "calib_imu_to_velo.txt")
        self.calib = KittiCalib(cam2cam, velo2cam, imu2velo)
        self._load_oxts()
        self.target_frame_ids = self._list_frame_ids(date, drive_id)

    def _load_oxts(self):
        oxts_dir = self.drive_dir / "oxts" / "data"
        rows = []
        for f in sorted(oxts_dir.glob("*.txt")):
            rows.append(np.fromstring(f.read_text(), sep=" "))
        self.poses_imu = oxts_to_pose(np.stack(rows)) if rows else None

    def _list_frame_ids(self, date, drive_id):
        img_dir = self.drive_dir / "image_02" / "data"
        frame_ids = sorted(int(f.stem) for f in img_dir.glob("*.png"))
        if self.split == "test":
            prefix = f"{date} {drive_id}"
            lines = (RESOURCES / "kitti_test_depth_frames.txt").read_text().splitlines()
            return [int(l.split()[-1]) for l in lines if l.startswith(prefix)]
        frame_ids = frame_ids[2:-2]
        prefix = f"{date} {drive_id}"
        static = (RESOURCES / "kitti_raw_static_frames.txt").read_text().splitlines()
        static_ids = {int(l.split(" ")[-1]) for l in static if l.startswith(prefix)}
        return sorted(set(frame_ids) - static_ids)

    def num_frames_(self):
        return len(self.target_frame_ids)

    def get_range_(self):
        return self.target_frame_ids

    def get_image(self, index, right=False):
        cam = "image_03" if right else "image_02"
        path = self.drive_dir / cam / "data" / f"{index:010d}.png"
        if not path.exists():
            return None
        import cv2
        return cv2.imread(str(path))  # BGR

    def get_pose(self, index, right=False):
        if self.poses_imu is None or index >= len(self.poses_imu):
            return None
        t_w_imu = self.poses_imu[index]
        t_w_cam2 = t_w_imu @ np.linalg.inv(self.calib.T_cam2_imu)
        if right:
            return (t_w_cam2 @ self.calib.stereo_T_LR).astype(np.float32)
        return t_w_cam2.astype(np.float32)

    def get_point_cloud(self, index, right=False):
        path = self.drive_dir / "velodyne_points" / "data" / f"{index:010d}.bin"
        if not path.exists():
            raise RecoverableSkip(f"no velodyne for frame {index}")
        velo = np.fromfile(str(path), dtype=np.float32).reshape(-1, 4)
        velo[:, 3] = 1.0
        t2cam = self.calib.T_cam3_velo if right else self.calib.T_cam2_velo
        pts = (t2cam @ velo.T)[:3].T
        return pts[pts[:, 2] > 0]

    def get_intrinsic(self, index=0, right=False):
        k = self.calib.K_cam3 if right else self.calib.K_cam2
        return k.copy().astype(np.float32)

    def get_stereo_extrinsic(self, index=0):
        return self.calib.stereo_T_LR.copy().astype(np.float32)


class KittiOdomReader(DataReaderBase):
    """KITTI odometry: <base>/sequences/<id>, GT poses only for the test
    split. Train sequences: 00-08, 11-21 minus 12; test: 09, 10."""

    TRAIN_SEQS = [f"{i:02d}" for i in list(range(9)) + list(range(11, 22))
                  if i != 12]
    TEST_SEQS = ["09", "10"]

    def __init__(self, split: str = "train", base_path=None):
        super().__init__(split, base_path)
        self.calib: KittiCalib | None = None
        self.seq_dir: Path | None = None
        self.poses: np.ndarray | None = None
        self.target_frame_ids: list[int] = []

    def list_drive_paths(self):
        return self.TEST_SEQS if self.split == "test" else self.TRAIN_SEQS

    def init_drive(self, drive_path):
        drive_id = drive_path
        base = Path(self.base_path)
        self.seq_dir = base / "sequences" / drive_id
        calib = read_calib_file(self.seq_dir / "calib.txt")
        # odometry calib: P0..P3 for gray/color pairs; color cams are P2, P3
        cam2cam = {"P_rect_02": calib["P2"], "P_rect_03": calib["P3"],
                   "R_rect_00": np.eye(3).reshape(-1)}
        self.calib = KittiCalib(cam2cam)
        frame_ids = sorted(int(f.stem) for f in
                           (self.seq_dir / "image_2").glob("*.png"))
        if self.split == "train":
            frame_ids = frame_ids[2:-2]
            self.poses = None
        else:
            pose_file = base / "poses" / f"{drive_id}.txt"
            rows = np.loadtxt(str(pose_file)).reshape(-1, 3, 4)
            homo = np.tile(np.array([[[0.0, 0, 0, 1]]]), (rows.shape[0], 1, 1))
            self.poses = np.concatenate([rows, homo], axis=1)
        self.target_frame_ids = frame_ids

    def num_frames_(self):
        return len(self.target_frame_ids)

    def get_range_(self):
        return self.target_frame_ids

    def get_image(self, index, right=False):
        cam = "image_3" if right else "image_2"
        path = self.seq_dir / cam / f"{index:06d}.png"
        if not path.exists():
            return None
        import cv2
        return cv2.imread(str(path))

    def get_pose(self, index, right=False):
        if self.poses is None or index >= len(self.poses):
            return None
        t_w_cam2 = self.poses[index]
        if right:
            return (t_w_cam2 @ self.calib.stereo_T_LR).astype(np.float32)
        return t_w_cam2.astype(np.float32)

    def get_point_cloud(self, index, right=False):
        return None

    def get_intrinsic(self, index=0, right=False):
        k = self.calib.K_cam3 if right else self.calib.K_cam2
        return k.copy().astype(np.float32)

    def get_stereo_extrinsic(self, index=0):
        return self.calib.stereo_T_LR.copy().astype(np.float32)
