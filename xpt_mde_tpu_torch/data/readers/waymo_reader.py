"""Waymo Open Dataset reader: the front camera, Day frames (port of
``xpt_mde_tpu.data.readers.waymo_reader``). It needs neither the
``waymo_open_dataset`` SDK nor tensorflow: segments are parsed by the
vendored proto subset and the numpy range-image geometry of
``waymo_native`` (an SDK can still be passed as ``sdk=`` and must give the
same point clouds).

- the drive's TFRecord segments stream in order through a 20-frame
  buffer;
- the front camera (index 0) only; frames not at "Day" are skipped;
- camera-to-world pose = ``frame.images[0].pose @ T_C2V``, where T_C2V is
  the axis swap from the camera to the vehicle frame;
- the point cloud comes from the range images, masked to the points that
  project into the front camera, rotated into the camera frame.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from xpt_mde_tpu_torch.data.readers.reader_base import DataReaderBase
from xpt_mde_tpu_torch.utils.util_class import RecoverableSkip

# axis swap: camera frame (right, down, front) <- vehicle frame (front, left, up)
T_C2V = np.array([[0, 0, 1, 0],
                  [-1, 0, 0, 0],
                  [0, -1, 0, 0],
                  [0, 0, 0, 1]], dtype=np.float32)


def _native_waymo():
    from xpt_mde_tpu_torch.data.readers.waymo_native import native_sdk
    return native_sdk()


class WaymoReader(DataReaderBase):
    def __init__(self, split: str = "train", base_path=None, sdk=None):
        """:param sdk: optional (dataset_pb2, frame_utils, tf) triple
        overriding the built-in SDK-free parser (waymo_native.native_sdk);
        tests also inject protocol-compatible fakes here."""
        super().__init__(split, base_path)
        self._sdk = sdk
        self._pb, self._fu, self._tf = None, None, None
        self.frame_buffer: dict = {}
        self.latest_index = -1
        self._iterator = None
        self.num_frames_estimate = 0

    def list_drive_paths(self):
        pattern = "training_*" if self.split == "train" else "validation_*"
        return sorted(p for p in Path(self.base_path).glob(pattern)
                      if p.is_dir())

    def init_drive(self, drive_path):
        self._pb, self._fu, self._tf = self._sdk or _native_waymo()
        files = sorted(str(f) for f in Path(drive_path).glob("*.tfrecord*"))
        dataset = self._tf.data.TFRecordDataset(files, compression_type="")
        self._iterator = iter(dataset)
        self.frame_buffer = {}
        self.latest_index = -1
        # frame count is unknown without a full pass; estimate generously
        # and rely on StopIteration to end the drive
        self.num_frames_estimate = 10000

    def num_frames_(self):
        return self.num_frames_estimate

    def get_range_(self):
        return range(2, self.num_frames_estimate - 2)

    def _get_frame(self, index: int):
        """Sequential streaming with a 20-frame buffer."""
        while self.latest_index < index:
            try:
                record = next(self._iterator)
            except StopIteration:
                raise StopIteration(f"end of waymo drive at {self.latest_index}")
            frame = self._pb.Frame()
            frame.ParseFromString(bytearray(record.numpy()))
            self.latest_index += 1
            self.frame_buffer[self.latest_index] = frame
            for old in [i for i in self.frame_buffer
                        if i < self.latest_index - 20]:
                self.frame_buffer.pop(old)
        if index not in self.frame_buffer:
            raise RecoverableSkip(f"waymo frame {index} evicted")
        frame = self.frame_buffer[index]
        if frame.context.stats.time_of_day != "Day":
            raise RecoverableSkip("waymo non-Day frame")
        return frame

    def get_image(self, index, right=False):
        if right:
            return None
        frame = self._get_frame(index)
        image = self._tf.image.decode_jpeg(frame.images[0].image).numpy()
        return image[..., ::-1].copy()  # RGB -> BGR

    def get_pose(self, index, right=False):
        frame = self._get_frame(index)
        t_w_v = np.array(frame.images[0].pose.transform,
                         np.float32).reshape(4, 4)
        return (t_w_v @ T_C2V).astype(np.float32)

    def get_point_cloud(self, index, right=False):
        frame = self._get_frame(index)
        fu = self._fu
        (range_images, camera_projections, _, range_image_top_pose) = \
            fu.parse_range_image_and_camera_projection(frame)
        points, cp_points = fu.convert_range_image_to_point_cloud(
            frame, range_images, camera_projections, range_image_top_pose)
        points_all = np.concatenate(points, axis=0)
        cp_all = np.concatenate(cp_points, axis=0)
        # keep points that project into the front camera (name == 1)
        mask = cp_all[:, 0] == 1
        points_veh = points_all[mask]
        # vehicle frame -> camera frame via the axis-swap rotation
        rot_v2c = np.linalg.inv(T_C2V)[:3, :3]
        points_cam = (rot_v2c @ points_veh.T).T
        return points_cam[points_cam[:, 2] > 0].astype(np.float32)

    def get_intrinsic(self, index=0, right=False):
        frame = self._get_frame(max(index, self.latest_index if index < 0 else index))
        calib = frame.context.camera_calibrations[0]
        fx, fy, cx, cy = calib.intrinsic[:4]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    def get_stereo_extrinsic(self, index=0):
        return None  # single front camera
