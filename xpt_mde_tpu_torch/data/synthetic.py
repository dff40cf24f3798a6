"""Synthetic snippet batches (port of ``xpt_mde_tpu.data.synthetic``).

The default world of the reference's ``SyntheticDataset``: 5-frame
snippets of a textured fronto-parallel plane 10 m away, seen by a camera
stepping 0.5 m in x, with exact GT depth and target->source poses, and
with ``stereo=True`` a right camera ``baseline_m`` to the right of the
left one. Pure numpy, copied rather than imported so the port needs no
JAX; for a given seed and size it yields the reference's batches bit for
bit (``tests/test_torch_data.py``). The reference's other worlds
(varying depth and motion, a moving object) have no caller in the port
and are not carried.

Feature dict layout (numpy arrays, as the reference's loaders give):
    image5d      [B, S, H, W, 3] float32 in [-1, 1], target LAST
    intrinsic    [B, 3, 3]
    depth_gt     [B, H, W, 1]
    pose_gt      [B, S - 1, 4, 4]  (target -> source)
    with stereo=True:
    image5d_R    [B, S, H, W, 3]   each left frame seen from +baseline
    intrinsic_R, pose_gt_R         copies of the left ones
    stereo_T_LR  [B, 4, 4]         identity with [0, 3] = baseline
"""

from __future__ import annotations

import numpy as np

from xpt_mde_tpu_torch.config import SNIPPET_LEN

DEPTH_M = 10.0
STEP_M = 0.5


def _texture(height: int, width: int, rng: np.random.RandomState) -> np.ndarray:
    """Smooth random texture in [-1, 1] with strong horizontal gradients."""
    freqs = rng.uniform(0.05, 0.4, (4,))
    phases = rng.uniform(0, np.pi * 2, (4,))
    u = np.arange(width, dtype=np.float32)[None, :]
    v = np.arange(height, dtype=np.float32)[:, None]
    img = sum(np.sin(u * f + p) * 0.4 for f, p in zip(freqs[:2], phases[:2]))
    img = img + sum(np.sin(v * f + p) * 0.2 for f, p in zip(freqs[2:], phases[2:]))
    rgb = np.stack([img, np.roll(img, 3, axis=1), np.roll(img, 7, axis=0)], -1)
    return np.clip(rgb, -1, 1).astype(np.float32)


def _render_plane(texture: np.ndarray, fx: float, cam_x: float,
                  depth_rows: np.ndarray) -> np.ndarray:
    """The texture seen from camera x-offset ``cam_x`` (metres): row v
    shifts by fx * cam_x / depth_rows[v] pixels. With pure x translation
    the rows are independent, so this per-row warp is an exact render."""
    height, width = texture.shape[:2]
    shifts = fx * cam_x / depth_rows
    u = np.arange(width, dtype=np.float32)
    out = np.empty_like(texture)
    for c in range(texture.shape[-1]):
        for v in range(height):
            out[v, :, c] = np.interp(u + shifts[v], u, texture[v, :, c])
    return out


class SyntheticDataset:
    """Iterable of feature-dict batches with exact geometry."""

    def __init__(self, batch_size: int = 2, height: int = 32, width: int = 64,
                 num_batches: int = 8, stereo: bool = False, seed: int = 0,
                 baseline_m: float = 0.3):
        self.batch_size = batch_size
        self.height = height
        self.width = width
        self.num_batches = num_batches
        self.stereo = stereo
        self.seed = seed
        self.baseline_m = baseline_m
        self.depth_rows = np.full((height,), DEPTH_M, np.float32)
        fx = width * 0.6
        self.intrinsic = np.array(
            [[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32)

    def __len__(self):
        return self.num_batches

    def config_keys(self):
        keys = ["image", "intrinsic", "depth_gt", "pose_gt"]
        if self.stereo:
            keys += ["image_R", "intrinsic_R", "pose_gt_R", "stereo_T_LR"]
        return keys

    def _make_example(self, rng: np.random.RandomState):
        texture = _texture(self.height, self.width, rng)
        # sources at [-2, -1, +1, +2] * step, the target at 0 and LAST
        src_offsets = [t * STEP_M for t in range(-2, SNIPPET_LEN - 2) if t != 0]
        frames = [_render_plane(texture, self.intrinsic[0, 0], o, self.depth_rows)
                  for o in src_offsets]
        frames.append(texture)
        # target -> source for a camera at +o: x_src = x - o
        pose_gt = np.tile(np.eye(4, dtype=np.float32), (SNIPPET_LEN - 1, 1, 1))
        for i, o in enumerate(src_offsets):
            pose_gt[i, 0, 3] = -o
        depth_gt = np.tile(self.depth_rows[:, None, None], (1, self.width, 1))
        return np.stack(frames, axis=0), depth_gt, pose_gt

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.num_batches):
            images, depths, poses = zip(*(self._make_example(rng)
                                          for _ in range(self.batch_size)))
            feats = {
                "image5d": np.stack(images),
                "intrinsic": np.tile(self.intrinsic, (self.batch_size, 1, 1)),
                "depth_gt": np.stack(depths),
                "pose_gt": np.stack(poses),
            }
            if self.stereo:
                feats.update(self._right_views(feats))
            yield feats

    def _right_views(self, feats: dict) -> dict:
        """The right camera sits ``baseline_m`` to the right of the left
        one: on a fronto-parallel plane each right frame is an exact
        re-render of its left frame."""
        fx = self.intrinsic[0, 0]
        images_r = [np.stack([_render_plane(frame, fx, self.baseline_m, self.depth_rows)
                              for frame in snippet])
                    for snippet in feats["image5d"]]
        t_lr = np.tile(np.eye(4, dtype=np.float32), (self.batch_size, 1, 1))
        t_lr[:, 0, 3] = self.baseline_m  # right -> left: x_L = x_R + b
        return {"image5d_R": np.stack(images_r).astype(np.float32),
                "intrinsic_R": feats["intrinsic"].copy(),
                "pose_gt_R": feats["pose_gt"].copy(),
                "stereo_T_LR": t_lr}
