"""DrivingStereo reader: zip-backed stereo pairs and half-resolution
calibration (port of ``xpt_mde_tpu.data.readers.driving_reader``):
per-drive zips (train-left-image / train-right-image / train-depth-map),
KITTI-style calibration text with P_rect_101/P_rect_103 (right/left) and
the R_103/T_103 left-from-right extrinsic; uint16 depth PNGs scaled by
1/256. Images are decoded with PIL, imported where a file is read; the
RGB -> BGR swap is numpy slicing.
"""

from __future__ import annotations

import io
import zipfile
from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.data.depth_map import depth_map_to_point_cloud
from xpt_mde_tpu_torch.data.readers.reader_base import DataReaderBase


def _open_image(data: bytes, dtype) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)), dtype)


class DrivingStereoReader(DataReaderBase):
    def __init__(self, split: str = "train", base_path=None):
        super().__init__(split, base_path)
        self.zip_files: dict = {}
        self.intrinsic = None
        self.intrinsic_R = None
        self.stereo_T_LR = None

    def list_drive_paths(self):
        return sorted(Path(self.base_path).glob(
            f"{self.split}-left-image/*.zip"))

    def init_drive(self, drive_path):
        drive_path = str(drive_path)
        self.zip_files = {
            "leftImg": zipfile.ZipFile(drive_path),
            "rightImg": zipfile.ZipFile(
                drive_path.replace("-left-image", "-right-image")),
            "depthMap": zipfile.ZipFile(
                drive_path.replace("-left-image", "-depth-map")),
        }
        self.frame_names = sorted(self.zip_files["leftImg"].namelist())
        calib = self._read_calib(drive_path)
        # 103 is the LEFT camera, 101 the RIGHT
        self.intrinsic = calib["P_rect_103"].reshape(3, 4)[:, :3]
        self.intrinsic_R = calib["P_rect_101"].reshape(3, 4)[:, :3]
        t_rl = np.eye(4, dtype=np.float32)
        t_rl[:3, :3] = calib["R_103"].reshape(3, 3)
        t_rl[:3, 3] = calib["T_103"]
        self.stereo_T_LR = np.linalg.inv(t_rl).astype(np.float32)

    @staticmethod
    def _read_calib(drive_path: str) -> dict:
        parts = drive_path.split("/")
        parts[-2] = "calib/half-image-calib"
        calib_file = "/".join(parts).replace(".zip", ".txt")
        params = {}
        for line in Path(calib_file).read_text().splitlines():
            if ":" not in line:
                continue
            key, values = line.split(":", 1)
            try:
                params[key.strip()] = np.array(
                    [float(v) for v in values.strip().split()], np.float32)
            except ValueError:
                pass
        return params

    def num_frames_(self):
        return len(self.frame_names) - 4

    def get_range_(self):
        return range(2, len(self.frame_names) - 2)

    def get_image(self, index, right=False):
        name = self.frame_names[index]
        zipkey = "rightImg" if right else "leftImg"
        data = self.zip_files[zipkey].read(name)
        return _open_image(data, np.uint8)[..., ::-1].copy()  # RGB -> BGR

    def get_pose(self, index, right=False):
        return None

    def get_point_cloud(self, index, right=False):
        if right:
            return None  # only left depth maps exist
        name = self.frame_names[index].replace(".jpg", ".png")
        depth = _open_image(self.zip_files["depthMap"].read(name), np.uint16)
        depth = depth.astype(np.float32) / 256.0
        return depth_map_to_point_cloud(depth, self.intrinsic)

    def get_intrinsic(self, index=0, right=False):
        k = self.intrinsic_R if right else self.intrinsic
        return k.copy().astype(np.float32)

    def get_stereo_extrinsic(self, index=0):
        return self.stereo_T_LR.copy()
