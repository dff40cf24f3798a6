"""Cityscapes sequence reader, straight out of the zip archives (port of
``xpt_mde_tpu.data.readers.city_reader``): four zips
(leftImg8bit_sequence, rightImg8bit_sequence, camera, disparity), the
CITY_CROP pre-crop removing the hood and the blurred border, depth from
the precomputed disparity ``(d - 1) / 256 -> fx * baseline / disp``, the
camera JSON of each sub-drive, the stereo extrinsic from the baseline.
PNGs are decoded with PIL, imported where a file is read; the RGB -> BGR
swap is numpy slicing.

``base_path`` is the directory containing the zips, or a dict of already
open ZipFile objects keyed leftImg/rightImg/camera/disparity.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.data.depth_map import depth_map_to_point_cloud
from xpt_mde_tpu_torch.data.readers.reader_base import DataReaderBase
from xpt_mde_tpu_torch.utils.util_class import RecoverableSkip

# pre-crop removing vehicle hood and blurred border [sy, ey, sx, ex]
CITY_CROP = [0, 750, 48, 2048]

ZIP_NAMES = {
    "leftImg": "leftImg8bit_sequence_trainvaltest.zip",
    "rightImg": "rightImg8bit_sequence_trainvaltest.zip",
    "camera": "camera_trainvaltest.zip",
    "disparity": "disparity_trainvaltest.zip",
}


def open_city_zips(base_path) -> dict:
    base = Path(base_path)
    zips = {}
    for key, name in ZIP_NAMES.items():
        path = base / name
        if path.exists():
            zips[key] = zipfile.ZipFile(path, "r")
    if "leftImg" not in zips:
        raise FileNotFoundError(f"no cityscapes zips under {base}")
    return zips


def list_drive_paths_from_names(filelist) -> list[str]:
    """Drive prefix = everything up to the sub-drive/frame/suffix parts."""
    files = sorted(f for f in filelist if f.endswith(".png"))
    return sorted({"_".join(f.split("_")[:-3]) for f in files})


class CityscapesReader(DataReaderBase):
    def __init__(self, split: str = "train", base_path=None):
        super().__init__(split, base_path)
        if isinstance(base_path, dict):
            self.zip_files = base_path
        else:
            self.zip_files = open_city_zips(base_path)
        self.camera_names = []
        self.cur_camera_param: dict = {}
        self.cur_camera_index = -1
        self.target_indices: list[int] = []

    def list_drive_paths(self):
        return list_drive_paths_from_names(
            self.zip_files["leftImg"].namelist())

    def init_drive(self, drive_path):
        names = self.zip_files["leftImg"].namelist()
        self.camera_names = self.zip_files["camera"].namelist() \
            if "camera" in self.zip_files else []
        self.frame_names = sorted(f for f in names
                                  if f.startswith(drive_path)
                                  and f.endswith(".png"))
        self.cur_camera_index = -1
        self._build_target_indices()

    def _build_target_indices(self):
        """Per sub-drive, drop the 4 first and last frames."""
        sub_drives = sorted({"_".join(f.split("_")[:-2])
                             for f in self.frame_names})
        self.target_indices = []
        for sub in sub_drives:
            idxs = sorted(i for i, f in enumerate(self.frame_names)
                          if f.startswith(sub))
            self.target_indices.extend(idxs[4:-4])

    def num_frames_(self):
        return len(self.target_indices)

    def get_range_(self):
        return self.target_indices

    def _open_image(self, zkey: str, name: str) -> np.ndarray:
        from PIL import Image
        data = self.zip_files[zkey].read(name)
        return np.array(Image.open(io.BytesIO(data)))

    def get_image(self, index, right=False):
        name = self.frame_names[index]
        if right:
            name = name.replace("leftImg8bit", "rightImg8bit")
            img = self._open_image("rightImg", name)
        else:
            img = self._open_image("leftImg", name)
        img = np.asarray(img, np.uint8)[..., ::-1].copy()  # RGB -> BGR
        return img[CITY_CROP[0]:CITY_CROP[1], CITY_CROP[2]:CITY_CROP[3]]

    def get_pose(self, index, right=False):
        return None

    def get_point_cloud(self, index, right=False):
        if right:
            return None
        params = self._get_camera_param(index)
        baseline = params["extrinsic"]["baseline"]
        fx = params["intrinsic"]["fx"]
        disp_name = self.frame_names[index].replace("leftImg8bit", "disparity")
        if ("disparity" not in self.zip_files
                or disp_name not in self.zip_files["disparity"].namelist()):
            return None
        disp = np.asarray(self._open_image("disparity", disp_name),
                          np.float32)
        disp[disp > 0] = (disp[disp > 0] - 1) / 256.0
        depth = np.zeros_like(disp)
        depth[disp > 0] = fx * baseline / disp[disp > 0]
        depth = depth[CITY_CROP[0]:CITY_CROP[1], CITY_CROP[2]:CITY_CROP[3]]
        return depth_map_to_point_cloud(depth, self.get_intrinsic(index))

    def get_intrinsic(self, index=0, right=False):
        params = self._get_camera_param(index)
        intr = params["intrinsic"]
        k = np.array([[intr["fx"], 0, intr["u0"] - CITY_CROP[2]],
                      [0, intr["fy"], intr["v0"] - CITY_CROP[0]],
                      [0, 0, 1]])
        return k.astype(np.float32)

    def get_stereo_extrinsic(self, index=0):
        params = self._get_camera_param(index)
        baseline = params["extrinsic"]["baseline"]
        t_lr = np.eye(4, dtype=np.float32)
        t_lr[0, 3] = baseline  # right->left points transform
        return t_lr

    def _get_camera_param(self, index) -> dict:
        if self.cur_camera_index == index:
            return self.cur_camera_param
        name = self.frame_names[index] \
            .replace("leftImg8bit_sequence", "camera") \
            .replace("leftImg8bit", "camera")
        subdrive = "_".join(name.split("_")[:-2])
        matches = [f for f in self.camera_names if f.startswith(subdrive)]
        if not matches:
            raise RecoverableSkip(f"no camera json like {subdrive}")
        self.cur_camera_param = json.loads(
            self.zip_files["camera"].read(matches[0]))
        self.cur_camera_index = index
        return self.cur_camera_param
