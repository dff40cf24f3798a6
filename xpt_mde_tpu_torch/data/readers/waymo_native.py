"""SDK-free Waymo segment parsing: TFRecord IO and range-image geometry
(port of ``xpt_mde_tpu.data.readers.waymo_native``). It stands in for
the three outside surfaces a Waymo reader needs:

- ``waymo_open_dataset.dataset_pb2`` -> the vendored proto subset
  (``waymo_protos/dataset.proto``, field numbers as in the public schema);
- ``waymo_open_dataset.utils.frame_utils`` -> numpy implementations of
  ``parse_range_image_and_camera_projection`` and
  ``convert_range_image_to_point_cloud`` (the public
  ``range_image_utils`` math: uniform/explicit beam inclinations, azimuth
  from the extrinsic yaw, polar->cartesian, extrinsic to the vehicle
  frame, and the TOP laser's per-pixel pose correction through the frame
  pose);
- ``tf.data.TFRecordDataset`` / ``tf.image.decode_jpeg`` -> a pure-python
  TFRecord reader (crc32c-verified) and an OpenCV JPEG decode (imported
  where a JPEG is decoded; the BGR -> RGB swap is numpy slicing).

``native_sdk()`` returns the (dataset_pb2, frame_utils, tf)-shaped triple
``WaymoReader`` consumes, so data prep runs without tensorflow or the
waymo_open_dataset package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from xpt_mde_tpu_torch.data.readers.waymo_protos import dataset_pb2

TOP_LASER = dataset_pb2.LaserName.TOP

# ---------------------------------------------------------------------------
# TFRecord container format (length | masked crc | payload | masked crc)
# ---------------------------------------------------------------------------

_CRC32C_TABLE = None


def _crc32c_table():
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = np.zeros(256, dtype=np.uint32)
        poly = np.uint32(0x82F63B78)  # Castagnoli, reflected
        for i in range(256):
            crc = np.uint32(i)
            for _ in range(8):
                crc = (crc >> np.uint32(1)) ^ (poly if crc & np.uint32(1)
                                               else np.uint32(0))
            table[i] = crc
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    buf = np.frombuffer(data, dtype=np.uint8)
    crc = np.uint32(0xFFFFFFFF)
    for b in buf:
        crc = table[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint32(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def read_tfrecord_file(path, check_crc: bool = True):
    """Yield record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) != 12:
                raise IOError(f"truncated TFRecord header in {path}")
            length, length_crc = struct.unpack("<QI", header)
            if check_crc and masked_crc32c(header[:8]) != length_crc:
                raise IOError(f"TFRecord length crc mismatch in {path}")
            payload = f.read(length)
            (data_crc,) = struct.unpack("<I", f.read(4))
            if len(payload) != length:
                raise IOError(f"truncated TFRecord payload in {path}")
            if check_crc and masked_crc32c(payload) != data_crc:
                raise IOError(f"TFRecord payload crc mismatch in {path}")
            yield payload


def write_tfrecord_file(path, records) -> None:
    """Write records in the TFRecord container format (test fixtures /
    parity with tf.io.TFRecordWriter output)."""
    with open(path, "wb") as f:
        for record in records:
            header = struct.pack("<Q", len(record))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(record)
            f.write(struct.pack("<I", masked_crc32c(record)))


# ---------------------------------------------------------------------------
# Range image decoding + point-cloud conversion (numpy frame_utils)
# ---------------------------------------------------------------------------


def _decode_matrix(compressed: bytes, proto_cls, dtype):
    matrix = proto_cls()
    matrix.ParseFromString(zlib.decompress(compressed))
    return np.array(matrix.data, dtype=dtype).reshape(matrix.shape.dims)


def parse_range_image_and_camera_projection(frame):
    """frame -> ({laser: [ri_return1, ri_return2]}, {laser: [cp1, cp2]},
    None, top_pose [H,W,6] or None); arrays are numpy, matching the SDK's
    MatrixFloat/MatrixInt32 tensors."""
    range_images, camera_projections = {}, {}
    range_image_top_pose = None
    for laser in frame.lasers:
        for ri in (laser.ri_return1, laser.ri_return2):
            if not ri.range_image_compressed:
                continue
            range_images.setdefault(laser.name, []).append(
                _decode_matrix(ri.range_image_compressed,
                               dataset_pb2.MatrixFloat, np.float32))
            if ri.camera_projection_compressed:
                camera_projections.setdefault(laser.name, []).append(
                    _decode_matrix(ri.camera_projection_compressed,
                                   dataset_pb2.MatrixInt32, np.int32))
        if (laser.name == TOP_LASER
                and laser.ri_return1.range_image_pose_compressed):
            range_image_top_pose = _decode_matrix(
                laser.ri_return1.range_image_pose_compressed,
                dataset_pb2.MatrixFloat, np.float32)
    return range_images, camera_projections, None, range_image_top_pose


def _rotation_zyx(roll, pitch, yaw):
    """R_z(yaw) @ R_y(pitch) @ R_x(roll) for [...]-shaped angle arrays."""
    cos_r, sin_r = np.cos(roll), np.sin(roll)
    cos_p, sin_p = np.cos(pitch), np.sin(pitch)
    cos_y, sin_y = np.cos(yaw), np.sin(yaw)
    rot = np.empty(np.shape(roll) + (3, 3), dtype=np.float64)
    rot[..., 0, 0] = cos_y * cos_p
    rot[..., 0, 1] = cos_y * sin_p * sin_r - sin_y * cos_r
    rot[..., 0, 2] = cos_y * sin_p * cos_r + sin_y * sin_r
    rot[..., 1, 0] = sin_y * cos_p
    rot[..., 1, 1] = sin_y * sin_p * sin_r + cos_y * cos_r
    rot[..., 1, 2] = sin_y * sin_p * cos_r - cos_y * sin_r
    rot[..., 2, 0] = -sin_p
    rot[..., 2, 1] = cos_p * sin_r
    rot[..., 2, 2] = cos_p * cos_r
    return rot


def _beam_inclinations(calibration, height: int) -> np.ndarray:
    if len(calibration.beam_inclinations):
        inclinations = np.array(calibration.beam_inclinations, np.float64)
    else:
        lo, hi = (calibration.beam_inclination_min,
                  calibration.beam_inclination_max)
        inclinations = (0.5 + np.arange(height)) / height * (hi - lo) + lo
    # calibration lists beams bottom-to-top; range image rows run
    # top-to-bottom
    return inclinations[::-1]


def _sensor_points(range_image, calibration):
    """Polar range image -> cartesian points in the SENSOR frame [H,W,3]."""
    height, width = range_image.shape[:2]
    extrinsic = np.array(calibration.extrinsic.transform,
                         np.float64).reshape(4, 4)
    inclination = _beam_inclinations(calibration, height)  # [H]
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (width - 0.5 - np.arange(width)) / width  # col 0 -> (W-.5)/W
    azimuth = (ratios * 2.0 - 1.0) * np.pi - az_correction  # [W]
    dist = range_image[..., 0].astype(np.float64)
    cos_incl = np.cos(inclination)[:, None]
    points = np.stack([
        cos_incl * np.cos(azimuth)[None, :] * dist,
        cos_incl * np.sin(azimuth)[None, :] * dist,
        np.sin(inclination)[:, None] * dist,
    ], axis=-1)
    return points, extrinsic


def convert_range_image_to_point_cloud(frame, range_images,
                                       camera_projections,
                                       range_image_top_pose, ri_index=0):
    """Per-laser vehicle-frame point lists + camera-projection rows,
    ordered by laser name (the SDK's contract)."""
    points_list, cp_list = [], []
    frame_pose = np.array(frame.pose.transform, np.float64).reshape(4, 4)
    pixel_rot = pixel_trans = None
    if range_image_top_pose is not None:
        pose = range_image_top_pose.astype(np.float64)
        pixel_rot = _rotation_zyx(pose[..., 0], pose[..., 1], pose[..., 2])
        pixel_trans = pose[..., 3:6]

    for calibration in sorted(frame.context.laser_calibrations,
                              key=lambda c: c.name):
        if calibration.name not in range_images:
            continue
        range_image = range_images[calibration.name][ri_index]
        sensor_points, extrinsic = _sensor_points(range_image, calibration)
        points = sensor_points @ extrinsic[:3, :3].T + extrinsic[:3, 3]
        if calibration.name == TOP_LASER and pixel_rot is not None:
            # vehicle -> world by the per-pixel pose, world -> vehicle by
            # the frame pose (motion compensation of the spinning laser)
            world = (np.einsum("hwij,hwj->hwi", pixel_rot, points)
                     + pixel_trans)
            inv_pose = np.linalg.inv(frame_pose)
            points = world @ inv_pose[:3, :3].T + inv_pose[:3, 3]
        mask = range_image[..., 0] > 0
        points_list.append(points[mask].astype(np.float32))
        cps = camera_projections.get(calibration.name)
        if cps is not None:
            cp_list.append(cps[ri_index][mask])
        else:
            cp_list.append(np.zeros((int(mask.sum()), 6), np.int32))
    return points_list, cp_list


# ---------------------------------------------------------------------------
# SDK-shaped facade
# ---------------------------------------------------------------------------


class _Record:
    __slots__ = ("_payload",)

    def __init__(self, payload: bytes):
        self._payload = payload

    def numpy(self) -> bytes:
        return self._payload


class _TFRecordDataset:
    def __init__(self, files, compression_type=""):
        if compression_type:
            raise ValueError("native TFRecord reader: only uncompressed "
                             "containers (Waymo segments are uncompressed)")
        self._files = [Path(f) for f in files]

    def __iter__(self):
        for path in self._files:
            for payload in read_tfrecord_file(path):
                yield _Record(payload)


def _decode_jpeg(data):
    import cv2
    bgr = cv2.imdecode(np.frombuffer(bytes(data), np.uint8),
                       cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError("JPEG decode failed")
    rgb = bgr[..., ::-1].copy()  # tf.image.decode_jpeg is RGB
    return SimpleNamespace(numpy=lambda: rgb)


def native_sdk():
    """(dataset_pb2, frame_utils, tf)-shaped triple for WaymoReader."""
    frame_utils = SimpleNamespace(
        parse_range_image_and_camera_projection=
        parse_range_image_and_camera_projection,
        convert_range_image_to_point_cloud=
        convert_range_image_to_point_cloud)
    tf_like = SimpleNamespace(
        data=SimpleNamespace(TFRecordDataset=_TFRecordDataset),
        image=SimpleNamespace(decode_jpeg=_decode_jpeg))
    return dataset_pb2, frame_utils, tf_like
