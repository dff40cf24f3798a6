"""Snippet example assembly: one frame index -> one training example
(port of ``xpt_mde_tpu.data.example_maker``; its examples equal the JAX
package's bit for bit, ``tests/test_torch_shard_chain.py``). It keeps the
JAX module's behaviour:

- snippet ids [id-2 .. id+2], stride 2 for a2d2/cityscapes, clipped to
  the drive's range;
- the TARGET frame moves to the END of the image stack;
- aspect-preserving resize to the target aspect, then a dataset-specific
  crop: KITTI cuts the sky (top, 0.7 ratio), a2d2/cityscapes cut the
  vehicle (bottom), otherwise a horizontal center crop, with the
  intrinsic's cx/cy moved to match;
- static-sequence rejection: the blurred frame-difference pixel count
  over the top third, against a threshold from the DESTINATION width,
  needs >= 2 moving frames;
- poses stored as target->source transforms inv(pose_src) @ pose_tgt;
- GT depth from LiDAR point-cloud splatting;
- the Waymo snippet motion check (0.2 m .. 10 m), with the original
  implementation's ``is``-comparison bug fixed.

The resize and the blur are ``image_ops``' numpy counterparts of
``cv2.resize`` and ``cv2.GaussianBlur``, bit for bit on uint8, so
building shards imports neither OpenCV nor PIL (the readers of real
datasets do, to decode their files).

Images are stored vertically stacked [S*H, W, 3] uint8 (target last).
"""

from __future__ import annotations

import numpy as np

from xpt_mde_tpu_torch.data.depth_map import point_cloud_to_depth_map
from xpt_mde_tpu_torch.data.image_ops import gaussian_blur3, resize_linear
from xpt_mde_tpu_torch.data.readers import data_reader_factory
from xpt_mde_tpu_torch.utils.util_class import RecoverableSkip


class ExampleMaker:
    def __init__(self, dataset: str, split: str, shwc_shape, data_keys,
                 reader_args=None):
        self.dataset = dataset
        self.split = split
        self.shwc_shape = tuple(shwc_shape)  # (S, H, W, C)
        self.data_keys = list(data_keys)
        self.reader_args = reader_args
        self.data_reader = None
        self.max_frame_id = 0

    def init_reader(self, drive_path):
        self.data_reader = data_reader_factory(self.dataset, self.split,
                                               self.reader_args)
        self.data_reader.init_drive(drive_path)
        rng = self.get_range()
        if len(rng) > 0:
            self.max_frame_id = max(rng)

    def num_frames(self):
        return self.data_reader.num_frames_()

    def get_range(self):
        return self.data_reader.get_range_()

    def get_example(self, index: int) -> dict:
        frame_id, frame_seq_ids = self.make_snippet_ids(index)
        example = {}
        example["image"], rawshape_hw, rszshape_hw = \
            self.load_snippet_images(frame_seq_ids)
        if self.split != "test":
            self.check_static_sequence(example)

        example["intrinsic"] = self.load_intrinsic(frame_id, rawshape_hw,
                                                   rszshape_hw)
        if "depth_gt" in self.data_keys:
            example["depth_gt"] = self.load_depth_map(frame_id, rawshape_hw,
                                                      rszshape_hw)
        if "pose_gt" in self.data_keys:
            example["pose_gt"] = self.load_snippet_poses(frame_seq_ids)
        if "image_R" in self.data_keys:
            example["image_R"], _, _ = self.load_snippet_images(frame_seq_ids,
                                                                right=True)
        if "intrinsic_R" in self.data_keys:
            example["intrinsic_R"] = self.load_intrinsic(
                frame_id, rawshape_hw, rszshape_hw, right=True)
        if "depth_gt_R" in self.data_keys:
            example["depth_gt_R"] = self.load_depth_map(
                frame_id, rawshape_hw, rszshape_hw, right=True)
        if "pose_gt_R" in self.data_keys:
            example["pose_gt_R"] = self.load_snippet_poses(frame_seq_ids,
                                                           right=True)
        if "stereo_T_LR" in self.data_keys:
            ext = self.data_reader.get_stereo_extrinsic(frame_id)
            if ext is not None:
                example["stereo_T_LR"] = ext.astype(np.float32)

        example = self.crop_example(example, rszshape_hw)
        example = self.verify_snippet(example)
        return example

    # --- snippet assembly -------------------------------------------------

    def make_snippet_ids(self, frame_index: int):
        frame_id = self.data_reader.index_to_id(frame_index)
        halflen = self.shwc_shape[0] // 2
        stride = 2 if self.dataset in ("a2d2", "cityscapes") else 1
        seq = np.arange(frame_id - halflen * stride,
                        frame_id + halflen * stride + 1, stride)
        return frame_id, np.clip(seq, 0, self.max_frame_id).tolist()

    def load_snippet_images(self, frame_ids, right: bool = False):
        snippet = self.shwc_shape[0]
        dstshape_hw = (self.shwc_shape[1], self.shwc_shape[2])
        image_seq, rawshape_hw, rszshape_hw = [], (), ()
        for fid in frame_ids:
            image = self.data_reader.get_image(fid, right=right)
            if image is None:
                raise RecoverableSkip(f"missing image at {fid}")
            rawshape_hw = image.shape[:2]
            rszshape_hw = self.get_resize_shape(rawshape_hw, dstshape_hw)
            image = resize_linear(image, (rszshape_hw[1], rszshape_hw[0]))
            image_seq.append(image)
        # target frame to the end
        target = image_seq.pop(snippet // 2)
        image_seq.append(target)
        return (np.concatenate(image_seq, axis=0).astype(np.uint8),
                rawshape_hw, rszshape_hw)

    @staticmethod
    def get_resize_shape(rawshape_hw, dstshape_hw):
        """Aspect-preserving resize target."""
        raw_ratio = rawshape_hw[1] / rawshape_hw[0]
        dst_ratio = dstshape_hw[1] / dstshape_hw[0]
        if abs(dst_ratio - raw_ratio) < 0.05:
            return tuple(dstshape_hw)
        if dst_ratio > raw_ratio:  # dst wider: match width, keep height big
            return (int(rawshape_hw[0] * dstshape_hw[1] / rawshape_hw[1] + 0.5),
                    dstshape_hw[1])
        return (dstshape_hw[0],
                int(rawshape_hw[1] * dstshape_hw[0] / rawshape_hw[0] + 0.5))

    def check_static_sequence(self, example):
        """Reject snippets where fewer than 2 frames move."""
        image_seq = example["image"]
        snippet = self.shwc_shape[0]
        height = image_seq.shape[0] // snippet
        # the threshold uses the DESTINATION width even when the resized
        # image is wider, as the JAX package does: the resized width
        # would reject borderline-moving snippets that it keeps
        width = self.shwc_shape[2]
        num_src = snippet - 1
        target = image_seq[num_src * height:]
        y_border = height // 3
        diff_thresh = height * width // 50

        def blur(img):
            return gaussian_blur3(gaussian_blur3(img)).astype(np.int32)

        target_smooth = blur(target)
        dynamic = 0
        for i in range(snippet):
            src = image_seq[i * height:(i + 1) * height]
            diff = np.abs(target_smooth - blur(src))
            diffmap = np.sum(diff[:y_border], axis=2)
            if int(np.sum(diffmap > 20)) > diff_thresh:
                dynamic += 1
        if dynamic < 2:
            raise RecoverableSkip("[check_static_sequence] static sequence")

    def load_intrinsic(self, index, rawshape_hw, rszshape_hw, right=False):
        intrinsic = self.data_reader.get_intrinsic(index, right=right)
        if intrinsic is None:
            raise RecoverableSkip("missing intrinsic")
        return self.rescale_intrinsic(intrinsic, rawshape_hw,
                                      rszshape_hw).astype(np.float32)

    @staticmethod
    def rescale_intrinsic(intrinsic, rawshape_hw, rszshape_hw):
        out = intrinsic.copy().astype(np.float32)
        out[0] *= rszshape_hw[1] / rawshape_hw[1]
        out[1] *= rszshape_hw[0] / rawshape_hw[0]
        return out

    def load_snippet_poses(self, frame_ids, right=False):
        pose_seq = []
        for fid in frame_ids:
            pose = self.data_reader.get_pose(fid, right=right)
            if pose is None:
                raise RecoverableSkip(f"missing pose at {fid}")
            pose_seq.append(pose)
        target_pose = pose_seq.pop(self.shwc_shape[0] // 2)
        # target->source transforms
        pose_seq = [np.linalg.inv(pose) @ target_pose for pose in pose_seq]
        return np.stack(pose_seq, axis=0).astype(np.float32)

    def load_depth_map(self, index, rawshape_hw, rszshape_hw, right=False):
        intrinsic = self.data_reader.get_intrinsic(index, right)
        point_cloud = self.data_reader.get_point_cloud(index, right)
        if intrinsic is None or point_cloud is None:
            raise RecoverableSkip("missing depth inputs")
        intrinsic_rsz = self.rescale_intrinsic(intrinsic, rawshape_hw,
                                               rszshape_hw)
        depth = point_cloud_to_depth_map(point_cloud, intrinsic_rsz,
                                         rszshape_hw)
        return depth[..., np.newaxis].astype(np.float32)

    # --- cropping ---------------------------------------------------------

    def crop_example(self, example, rszshape_hw):
        if tuple(rszshape_hw) == self.shwc_shape[1:3]:
            return example
        cy, cx, ch, cw = self.get_crop_range(rszshape_hw)

        def crop_image(image):
            stack = image.reshape(-1, rszshape_hw[0], rszshape_hw[1], 3)
            return stack[:, cy:cy + ch, cx:cx + cw].reshape(-1, cw, 3)

        example["image"] = crop_image(example["image"])
        if example.get("image_R") is not None:
            example["image_R"] = crop_image(example["image_R"])

        def crop_intrinsic(k):
            k = np.copy(k)
            k[0, 2] -= cx
            k[1, 2] -= cy
            return k

        example["intrinsic"] = crop_intrinsic(example["intrinsic"])
        if example.get("intrinsic_R") is not None:
            example["intrinsic_R"] = crop_intrinsic(example["intrinsic_R"])
        for key in ("depth_gt", "depth_gt_R"):
            if example.get(key) is not None:
                example[key] = example[key][cy:cy + ch, cx:cx + cw]
        return example

    def get_crop_range(self, rszshape_hw):
        """(cy, cx, ch, cw) per dataset."""
        rsz_h, rsz_w = rszshape_hw
        dst_h, dst_w = self.shwc_shape[1:3]
        if self.dataset.startswith("kitti"):
            if rsz_h > dst_h and rsz_w == dst_w:
                return int((rsz_h - dst_h) * 0.7), 0, dst_h, dst_w  # cut sky
            return 0, (rsz_w - dst_w) // 2, dst_h, dst_w
        if self.dataset in ("a2d2", "cityscapes"):
            if rsz_h > dst_h and rsz_w == dst_w:
                return 0, 0, dst_h, dst_w  # cut vehicle at the bottom
            return 0, (rsz_w - dst_w) // 2, dst_h, dst_w
        if self.dataset == "driving_stereo":
            if rsz_h > dst_h and rsz_w == dst_w:
                return 0, 0, dst_h, dst_w
            return 0, (rsz_w - dst_w) // 2, dst_h, dst_w
        if self.dataset == "synthetic":
            return 0, 0, dst_h, dst_w
        raise ValueError(f"Wrong dataset to crop: {self.dataset}")

    def verify_snippet(self, example):
        """Waymo motion sanity check (the original implementation compared
        ``self.dataset is "waymo"``, which never held; fixed here as in the
        JAX package)."""
        if self.dataset == "waymo" and "pose_gt" in example:
            positions = example["pose_gt"][:, :3, 3]
            distances = np.linalg.norm(positions, axis=1)
            if np.min(distances) < 0.2:
                raise RecoverableSkip("[verify_snippet] not moving")
            if np.max(distances) > 10.0:
                raise RecoverableSkip("[verify_snippet] scene change")
        # no None filtering needed: every loader above raises
        # RecoverableSkip on missing data
        return example
