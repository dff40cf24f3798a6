"""Dataset readers (port of ``xpt_mde_tpu.data.readers``).

``synthetic`` needs numpy only. The readers of real datasets decode PNG
and JPEG files with OpenCV or PIL, which they import where they call it:
``kitti_raw`` and ``kitti_odom`` (``cv2.imread``), ``cityscapes``,
``driving_stereo`` and ``a2d2`` (PIL; A2D2's ``undistort_image`` also
OpenCV), ``waymo`` (``cv2.imdecode`` and ``google.protobuf``).
"""

from xpt_mde_tpu_torch.data.readers.reader_base import DataReaderBase


def data_reader_factory(dataset_name: str, split: str,
                        base_path=None) -> DataReaderBase:
    """The reader of ``dataset_name`` for ``split``; each module is
    imported only when its dataset is asked for."""
    if dataset_name == "kitti_raw":
        from xpt_mde_tpu_torch.data.readers.kitti_reader import KittiRawReader
        return KittiRawReader(split, base_path)
    if dataset_name == "kitti_odom":
        from xpt_mde_tpu_torch.data.readers.kitti_reader import KittiOdomReader
        return KittiOdomReader(split, base_path)
    if dataset_name == "cityscapes":
        from xpt_mde_tpu_torch.data.readers.city_reader import CityscapesReader
        return CityscapesReader(split, base_path)
    if dataset_name == "a2d2":
        from xpt_mde_tpu_torch.data.readers.a2d2_reader import A2D2Reader
        return A2D2Reader(split, base_path)
    if dataset_name == "waymo":
        from xpt_mde_tpu_torch.data.readers.waymo_reader import WaymoReader
        return WaymoReader(split, base_path)
    if dataset_name == "synthetic":
        from xpt_mde_tpu_torch.data.synthetic import SyntheticReader
        return SyntheticReader(split, base_path)
    if dataset_name == "driving_stereo":
        from xpt_mde_tpu_torch.data.readers.driving_reader import DrivingStereoReader
        return DrivingStereoReader(split, base_path)
    raise ValueError(f"unknown dataset: {dataset_name}")
