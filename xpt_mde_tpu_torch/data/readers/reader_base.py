"""Dataset reader base class (port of
``xpt_mde_tpu.data.readers.reader_base``).

A reader exposes per-drive frame access: image, pose, point cloud or
depth, intrinsics, stereo extrinsic. All outputs are numpy; poses are 4x4
camera-to-world transforms, so the example maker forms relative
target->source transforms the same way for every dataset.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class DataReaderBase:
    def __init__(self, split: str = "train", base_path=None):
        self.split = split
        self.base_path = base_path
        self.frame_names: list = []

    # --- drive management -------------------------------------------------
    def list_drive_paths(self) -> list:
        """All drives for this split."""
        raise NotImplementedError()

    def init_drive(self, drive_path) -> None:
        """Prepare to read one drive."""
        raise NotImplementedError()

    def num_frames_(self) -> int:
        raise NotImplementedError()

    def get_range_(self) -> range:
        """Frame indices usable as snippet centers."""
        raise NotImplementedError()

    # --- per-frame data ---------------------------------------------------
    def get_image(self, index: int, right: bool = False) -> np.ndarray:
        """[H, W, 3] uint8."""
        raise NotImplementedError()

    def get_pose(self, index: int, right: bool = False) -> Optional[np.ndarray]:
        """[4, 4] camera-to-world transform, or None if unavailable."""
        raise NotImplementedError()

    def get_point_cloud(self, index: int, right: bool = False) -> Optional[np.ndarray]:
        """[N, 3] points in the camera frame, or None."""
        raise NotImplementedError()

    def get_depth(self, index: int, srcshape_hw, dstshape_hw, intrinsic,
                  right: bool = False) -> Optional[np.ndarray]:
        """[dstH, dstW] float32 depth map, or None."""
        raise NotImplementedError()

    def get_intrinsic(self, index: int = 0, right: bool = False) -> np.ndarray:
        """[3, 3] camera matrix at source resolution."""
        raise NotImplementedError()

    def get_stereo_extrinsic(self, index: int = 0) -> Optional[np.ndarray]:
        """[4, 4] T_LR (right-to-left points transform), or None."""
        raise NotImplementedError()

    def index_to_id(self, index: int):
        """Dataset-specific frame id for logging."""
        return index
