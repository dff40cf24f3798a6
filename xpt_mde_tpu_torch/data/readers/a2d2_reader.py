"""A2D2 reader: zip-backed front stereo cameras and lidar npz depth (port
of ``xpt_mde_tpu.data.readers.a2d2_reader``): per-drive zips
(camera_frontleft/frontright, lidar_frontleft/frontright), a 20-frame
eviction buffer, depth maps rebuilt from the lidar npz row/col/depth
arrays, and a ``cams_lidars.json`` SensorConfig for the camera matrices,
resolutions and undistortion. PNGs are decoded with PIL and undistorted
with OpenCV, each imported where it is called; the RGB -> BGR swap is
numpy slicing.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.data.depth_map import depth_map_to_point_cloud
from xpt_mde_tpu_torch.data.readers.reader_base import DataReaderBase


class SensorConfig:
    """Wraps cams_lidars.json."""

    def __init__(self, cfg: dict):
        self.sensor_config = cfg

    @classmethod
    def from_file(cls, path):
        return cls(json.loads(Path(path).read_text()))

    def get_cam_matrix(self, cam_key: str) -> np.ndarray:
        return np.asarray(self.sensor_config["cameras"][cam_key]["CamMatrix"],
                          np.float32)

    def get_resolution_hw(self, cam_key: str) -> np.ndarray:
        res = self.sensor_config["cameras"][cam_key]["Resolution"]
        return np.asarray([res[1], res[0]], np.int32)

    def get_view_transform(self, cam_key: str) -> np.ndarray:
        """Camera-to-vehicle transform from the view axes (x/y axis + origin)."""
        view = self.sensor_config["cameras"][cam_key]["view"]
        x = np.asarray(view["x-axis"], np.float64)
        y = np.asarray(view["y-axis"], np.float64)
        origin = np.asarray(view["origin"], np.float64)
        x = x / np.linalg.norm(x)
        y = y - x * np.dot(x, y)
        y = y / np.linalg.norm(y)
        z = np.cross(x, y)
        mat = np.eye(4)
        mat[:3, 0], mat[:3, 1], mat[:3, 2], mat[:3, 3] = x, y, z, origin
        return mat

    def get_stereo_extrinsic(self) -> np.ndarray:
        """T_LR: right-cam points -> left-cam frame, from the view
        transforms of front_left / front_right."""
        t_v_l = self.get_view_transform("front_left")
        t_v_r = self.get_view_transform("front_right")
        return (np.linalg.inv(t_v_l) @ t_v_r).astype(np.float32)

    def undistort_image(self, image, cam_name):
        import cv2
        cams = self.sensor_config["cameras"][cam_name]
        intr_dist = np.asarray(cams["CamMatrixOriginal"])
        intr_undist = np.asarray(cams["CamMatrix"])
        dist = np.asarray(cams["Distortion"])
        if cams["Lens"] == "Fisheye":
            return cv2.fisheye.undistortImage(image, intr_dist, D=dist,
                                              Knew=intr_undist)
        if cams["Lens"] == "Telecam":
            return cv2.undistort(image, intr_dist, distCoeffs=dist,
                                 newCameraMatrix=intr_undist)
        return image


class A2D2Reader(DataReaderBase):
    def __init__(self, split: str = "train", base_path=None):
        super().__init__(split, base_path)
        self.zip_files: dict = {}
        self.frame_buffer: dict = {}
        self.sensor_config: SensorConfig | None = None
        self.latest_index = 0

    def list_drive_paths(self):
        return sorted(Path(self.base_path).glob("*camera_frontleft*.zip"))

    def init_drive(self, drive_path):
        drive_path = str(drive_path)
        self.zip_files = {
            "camera_left": zipfile.ZipFile(drive_path),
            "camera_right": zipfile.ZipFile(
                drive_path.replace("camera_frontleft", "camera_frontright")),
            "lidar_left": zipfile.ZipFile(
                drive_path.replace("camera_frontleft", "lidar_frontleft")),
            "lidar_right": zipfile.ZipFile(
                drive_path.replace("camera_frontleft", "lidar_frontright")),
        }
        cfgfile = Path(drive_path).parent / "cams_lidars.json"
        self.sensor_config = SensorConfig.from_file(cfgfile)
        self.frame_names = sorted(
            n for n in self.zip_files["camera_left"].namelist()
            if n.endswith(".png"))
        self.frame_buffer = {}
        self.latest_index = 0

    def num_frames_(self):
        return len(self.frame_names)

    def get_range_(self):
        return range(2, self.num_frames_() - 2)

    def get_image(self, index, right=False):
        return self._frame_data(index, "image_R" if right else "image")

    def get_pose(self, index, right=False):
        return None

    def get_point_cloud(self, index, right=False):
        intrinsic = self.get_intrinsic(index, right)
        depth_map = self._frame_data(index,
                                     "depth_gt_R" if right else "depth_gt")
        return depth_map_to_point_cloud(depth_map, intrinsic)

    def get_intrinsic(self, index=0, right=False):
        return self._frame_data(index, "intrinsic_R" if right else "intrinsic")

    def get_stereo_extrinsic(self, index=0):
        return self._frame_data(index, "stereo_T_LR")

    # --- internals ----------------------------------------------------------

    def _frame_data(self, index, key):
        """20-frame eviction buffer."""
        if index not in self.frame_buffer:
            self.frame_buffer[index] = {
                "image": self._read_image(index),
                "image_R": self._read_image(index, right=True),
                "intrinsic": self.sensor_config.get_cam_matrix("front_left"),
                "intrinsic_R": self.sensor_config.get_cam_matrix("front_right"),
                "depth_gt": self._read_depth_map(index),
                "depth_gt_R": self._read_depth_map(index, right=True),
                "stereo_T_LR": self.sensor_config.get_stereo_extrinsic(),
            }
            self.latest_index = max(self.latest_index, index)
            for old in [i for i in self.frame_buffer
                        if i < self.latest_index - 20]:
                self.frame_buffer.pop(old)
        return self.frame_buffer[index][key]

    def _read_image(self, index, right=False):
        name = self.frame_names[index]
        zipkey = "camera_left"
        if right:
            name = name.replace("frontleft", "frontright") \
                       .replace("front_left", "front_right")
            zipkey = "camera_right"
        from PIL import Image
        data = self.zip_files[zipkey].read(name)
        image = np.asarray(Image.open(io.BytesIO(data)), np.uint8)
        return image[..., ::-1].copy()  # RGB -> BGR

    def _read_depth_map(self, index, right=False):
        """Dense-ify the lidar npz row/col/depth arrays."""
        name = self.frame_names[index]
        if right:
            name = name.replace("frontleft", "frontright") \
                       .replace("front_left", "front_right")
        npz_name = name.replace("_camera_", "_lidar_") \
                       .replace("/camera/", "/lidar/").replace(".png", ".npz")
        lidar_key = "lidar_right" if right else "lidar_left"
        npz = np.load(io.BytesIO(self.zip_files[lidar_key].read(npz_name)))
        rows = (npz["pcloud_attr.row"] + 0.5).astype(np.int32)
        cols = (npz["pcloud_attr.col"] + 0.5).astype(np.int32)
        depths = npz["pcloud_attr.depth"]
        cam = "front_right" if right else "front_left"
        imsize_hw = self.sensor_config.get_resolution_hw(cam)
        depth_map = np.zeros(tuple(imsize_hw), np.float32)
        depth_map[rows, cols] = depths
        return depth_map
