"""Synthetic snippet batches (port of ``xpt_mde_tpu.data.synthetic``).

Two GT-bearing worlds and the shard-making reader, pure numpy, copied
rather than imported so the port needs no JAX; for a given seed and size
each yields the reference's batches or frames bit for bit
(``tests/test_torch_data.py``, ``tests/test_torch_synthetic_worlds.py``,
``tests/test_torch_shard_chain.py``):

- :class:`SyntheticDataset`: 5-frame snippets of a textured surface seen
  by a camera stepping in x, with exact GT depth and target->source
  poses. By default a fronto-parallel plane 10 m away; ``varying_depth``
  makes it a row-banded relief whose inverse depth is painted into
  channel 0, ``vary_motion`` draws each example's step, ``moving_object``
  adds a band moving on its own (optionally accelerating), and
  ``stereo=True`` adds a right camera ``baseline_m`` to the right;
- :class:`PlanarSceneDataset`: a tilted textured plane rendered exactly
  under full SE(3) camera motion (x translation and yaw);
- :class:`SyntheticReader`: the shard-making twin, a reader of
  procedurally rendered "drives" for ``ShardMaker("synthetic")``.

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


def _render_plane(texture: np.ndarray, fx: float, cam_x: float, depth_m) -> np.ndarray:
    """The texture seen from camera x-offset ``cam_x`` (metres): row v
    shifts by fx * cam_x / depth(v) pixels, ``depth_m`` a scalar or an [H]
    array of per-row depths. With pure x translation the rows are
    independent, so this per-row warp is an exact render."""
    height, width = texture.shape[:2]
    depth_rows = np.broadcast_to(np.asarray(depth_m, np.float32), (height,))
    shifts = fx * cam_x / depth_rows
    u = np.arange(width, dtype=np.float32)
    out = np.empty_like(texture)
    for c in range(texture.shape[-1]):
        for v in range(height):
            out[v, :, c] = np.interp(u + shifts[v], u, texture[v, :, c])
    return out


def _depth_profile(height: int, depth_min: float, depth_max: float) -> np.ndarray:
    """Per-row depth: a smooth near -> far -> near sweep, so depth varies
    several-fold inside the Garg crop and a constant-depth predictor
    scores a clearly bad AbsRel."""
    v = np.linspace(0.0, 2.0 * np.pi, height, dtype=np.float32)
    t = 0.5 - 0.5 * np.cos(v)  # 0 -> 1 -> 0
    return (depth_min + (depth_max - depth_min) * t).astype(np.float32)


def _tint_by_inverse_depth(texture: np.ndarray, depth_rows: np.ndarray,
                           depth_min: float, depth_max: float) -> np.ndarray:
    """Mix an inverse-depth cue into channel 0, so single-image depth is
    learnable from local appearance; the output stays in [-1, 1]."""
    inv = 1.0 / depth_rows
    lo, hi = 1.0 / depth_max, 1.0 / depth_min
    cue = (2.0 * (inv - lo) / (hi - lo) - 1.0).astype(np.float32)
    out = texture.copy()
    out[..., 0] = 0.4 * out[..., 0] + 0.6 * cue[:, None]
    return np.clip(out, -1, 1)


class SyntheticDataset:
    """Iterable of feature-dict batches with exact geometry.

    ``varying_depth``: depth sweeps depth_m/2 .. 2 depth_m across the
    rows, its inverse painted into channel 0. ``vary_motion``: each
    example's camera step is scaled by a draw from [0.6, 1.4].
    ``moving_object``: rows ``object_rows()`` hold a surface at
    ``object_depth_m`` (0.7 depth_m by default) whose world x at frame t
    is step * t * (object_vel_ratio + object_accel * t / 2); at constant
    velocity the wrong depth d_obj / (1 - r) closes the warp, and a
    nonzero accel leaves no single depth that does (monocular only)."""

    def __init__(self, batch_size: int = 2, snippet_len: int = 5,
                 height: int = 32, width: int = 64, num_batches: int = 8,
                 stereo: bool = False, seed: int = 0, depth_m: float = 10.0,
                 step_m: float = 0.5, varying_depth: bool = False,
                 vary_motion: bool = False, baseline_m: float = 0.3,
                 moving_object: bool = False, object_vel_ratio: float = 0.6,
                 object_accel: float = 0.0, object_depth_m: float | None = None):
        if moving_object and stereo:
            raise ValueError("moving_object supports monocular worlds only")
        self.batch_size = batch_size
        self.snippet_len = snippet_len
        self.height = height
        self.width = width
        self.num_batches = num_batches
        self.stereo = stereo
        self.seed = seed
        self.depth_m = depth_m
        self.step_m = step_m
        self.varying_depth = varying_depth
        self.vary_motion = vary_motion
        self.baseline_m = baseline_m
        self.moving_object = moving_object
        self.object_vel_ratio = object_vel_ratio
        self.object_accel = object_accel
        self.object_depth_m = depth_m * 0.7 if object_depth_m is None else object_depth_m
        if varying_depth:
            self.depth_rows = _depth_profile(height, depth_m * 0.5, depth_m * 2.0)
        else:
            self.depth_rows = np.full((height,), depth_m, np.float32)
        fx = width * 0.6
        self.intrinsic = np.array(
            [[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1]], np.float32)

    def object_rows(self) -> tuple[int, int]:
        """The moving band [r0, r1), inside the Garg crop (rows
        0.41H..0.99H), so the band's depth shows in AbsRel."""
        return int(self.height * 0.50), int(self.height * 0.72)

    def __len__(self):
        return self.num_batches

    def config_keys(self):
        keys = ["image", "intrinsic", "depth_gt", "pose_gt"]
        if self.stereo:
            keys += ["image_R", "intrinsic_R", "pose_gt_R", "stereo_T_LR"]
        return keys

    def _tint(self, texture: np.ndarray, depth_rows: np.ndarray) -> np.ndarray:
        return _tint_by_inverse_depth(texture, depth_rows, self.depth_m * 0.5,
                                      self.depth_m * 2.0)

    def _make_example(self, rng: np.random.RandomState):
        s = self.snippet_len
        fx = self.intrinsic[0, 0]
        texture = _texture(self.height, self.width, rng)
        if self.varying_depth:
            texture = self._tint(texture, self.depth_rows)
        step = self.step_m
        if self.vary_motion:
            step = step * rng.uniform(0.6, 1.4)
        # sources at [-2, -1, +1, +2] * step, the target at 0 and LAST; the
        # frame index is the time (one step a frame)
        src_times = [t for t in range(-2, s - 2) if t != 0][: s - 1]
        src_offsets = [t * step for t in src_times]
        frames = [_render_plane(texture, fx, o, self.depth_rows) for o in src_offsets]
        frames.append(texture)

        if self.moving_object:
            r0, r1 = self.object_rows()
            d_obj = self.object_depth_m
            r, a = self.object_vel_ratio, self.object_accel
            obj_tex = _texture(r1 - r0, self.width, rng)
            if self.varying_depth:
                obj_tex = self._tint(obj_tex, np.full((r1 - r0,), d_obj, np.float32))
            for frame, t in zip(frames, src_times + [0]):
                # the band's world x at time t; its image shift follows the
                # camera-relative offset
                x_obj = step * t * (r + a * t / 2.0)
                frame[r0:r1] = _render_plane(obj_tex, fx, t * step - x_obj, d_obj)

        # target -> source for a camera at +o: x_src = x - o
        pose_gt = np.tile(np.eye(4, dtype=np.float32), (s - 1, 1, 1))
        for i, o in enumerate(src_offsets):
            pose_gt[i, 0, 3] = -o
        depth_rows = self.depth_rows.copy()
        if self.moving_object:
            r0, r1 = self.object_rows()
            depth_rows[r0:r1] = self.object_depth_m
        depth_gt = np.tile(depth_rows[:, None, None], (1, self.width, 1)).astype(np.float32)
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
        one: each right frame is an exact re-render of its left frame."""
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


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


class PlanarSceneDataset:
    """A tilted textured plane rendered exactly under SE(3) camera motion.

    In the target view the plane's depth sweeps ``depth_max`` (top row)
    to ``depth_min`` (bottom row), like a road. Its texture is an analytic
    sum of sinusoids in the plane's own coordinates, so any pose renders
    exactly: per pixel, the ray meets the plane in closed form. The
    cameras translate in x by ``step_m`` and yaw by ``yaw_deg`` a frame
    (``vary_motion`` scales both per example), so ``pose_gt`` carries
    rotation. Channel 0 carries the inverse of the target-view depth as a
    surface property. Monocular keys, as :class:`SyntheticDataset`'s."""

    def __init__(self, batch_size: int = 2, snippet_len: int = 5,
                 height: int = 32, width: int = 64, num_batches: int = 8,
                 seed: int = 0, depth_min: float = 5.0, depth_max: float = 20.0,
                 step_m: float = 0.5, yaw_deg: float = 0.0, vary_motion: bool = False):
        self.batch_size = batch_size
        self.snippet_len = snippet_len
        self.height = height
        self.width = width
        self.num_batches = num_batches
        self.seed = seed
        self.depth_min = depth_min
        self.depth_max = depth_max
        self.step_m = step_m
        self.yaw_deg = yaw_deg
        self.vary_motion = vary_motion
        fx = width * 0.6
        cx, cy = width / 2, height / 2
        self.intrinsic = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)
        # the plane {X : n.X = c}, n = (0, ny, 1): target depth
        # z(v) = c / (1 + ny (v - cy) / fy), depth_max at v = 0 and
        # depth_min at v = H - 1
        a_top, a_bot = (0 - cy) / fx, (height - 1 - cy) / fx
        ny = (depth_max - depth_min) / (depth_min * a_bot - depth_max * a_top)
        self.normal = np.array([0.0, ny, 1.0], np.float32)
        self.plane_c = depth_max * (1.0 + ny * a_top)
        self.p0 = np.array([0.0, 0.0, self.plane_c], np.float32)
        self.e1 = np.array([1.0, 0.0, 0.0], np.float32)
        e2 = np.array([0.0, 1.0, -ny], np.float32)
        self.e2 = (e2 / np.linalg.norm(e2)).astype(np.float32)

    def __len__(self):
        return self.num_batches

    def config_keys(self):
        return ["image", "intrinsic", "depth_gt", "pose_gt"]

    def _sample_texture(self, rng: np.random.RandomState):
        """Per channel, a sum of four sinusoids in plane metres
        (wavelengths ~2-8 m, several pixels at every depth in range)."""
        freqs = rng.uniform(0.4, 1.5, (3, 4, 2)).astype(np.float32)
        phases = rng.uniform(0, 2 * np.pi, (3, 4)).astype(np.float32)
        amps = rng.uniform(0.15, 0.35, (3, 4)).astype(np.float32)

        def tex(s, tau):
            chans = []
            for ch in range(3):
                chans.append(sum(amps[ch, k] * np.sin(freqs[ch, k, 0] * s
                                                      + freqs[ch, k, 1] * tau
                                                      + phases[ch, k])
                                 for k in range(4)))
            img = np.stack(chans, axis=-1).astype(np.float32)
            # the inverse target-view depth, painted on the surface (ch 0)
            z_canon = self.p0[2] + tau * self.e2[2]
            lo, hi = 1.0 / self.depth_max, 1.0 / self.depth_min
            cue = 2.0 * (1.0 / np.clip(z_canon, self.depth_min * 0.5,
                                       self.depth_max * 2.0) - lo) / (hi - lo) - 1.0
            img[..., 0] = 0.4 * img[..., 0] + 0.6 * np.clip(cue, -1, 1)
            return np.clip(img, -1, 1)
        return tex

    def _render_pose(self, tex, rotation: np.ndarray, position: np.ndarray):
        """Exact render and depth map for the camera-to-world (R, t)."""
        k = self.intrinsic
        uu, vv = np.meshgrid(np.arange(self.width, dtype=np.float32),
                             np.arange(self.height, dtype=np.float32))
        dirs_c = np.stack([(uu - k[0, 2]) / k[0, 0], (vv - k[1, 2]) / k[1, 1],
                           np.ones_like(uu)], axis=-1)
        dirs_w = dirs_c @ rotation.T
        lam = (self.plane_c - position @ self.normal) / (dirs_w @ self.normal)
        rel = position + lam[..., None] * dirs_w - self.p0
        img = tex(rel @ self.e1, rel @ self.e2)
        return img.astype(np.float32), lam.astype(np.float32)  # z_c == lam

    def _make_example(self, rng: np.random.RandomState):
        s = self.snippet_len
        tex = self._sample_texture(rng)
        step, yaw = self.step_m, np.deg2rad(self.yaw_deg)
        if self.vary_motion:
            step = step * rng.uniform(0.6, 1.4)
            yaw = yaw * rng.uniform(0.6, 1.4)
        frames, poses = [], []
        for t in [t for t in range(-2, s - 2) if t != 0][: s - 1]:
            rot = _rot_y(yaw * t)
            pos = np.array([t * step, 0.0, 0.0], np.float32)
            frames.append(self._render_pose(tex, rot, pos)[0])
            # target -> source: X_s = R^T (X_t - pos)
            t2s = np.eye(4, dtype=np.float32)
            t2s[:3, :3] = rot.T
            t2s[:3, 3] = -rot.T @ pos
            poses.append(t2s)
        target, depth = self._render_pose(tex, np.eye(3, dtype=np.float32),
                                          np.zeros(3, np.float32))
        frames.append(target)
        return np.stack(frames), depth[..., None].astype(np.float32), np.stack(poses)

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.num_batches):
            images, depths, poses = zip(*(self._make_example(rng)
                                          for _ in range(self.batch_size)))
            yield {
                "image5d": np.stack(images),
                "intrinsic": np.tile(self.intrinsic, (self.batch_size, 1, 1)),
                "depth_gt": np.stack(depths),
                "pose_gt": np.stack(poses),
            }


class SyntheticReader:
    """Reader (``DataReaderBase``'s interface) of procedurally rendered
    drives for the shard-making path: each drive is a textured plane
    ``depth_m`` away seen by a camera stepping ``step_m`` in x a frame,
    with exact GT depth, poses and intrinsics, so
    ``ShardMaker(cfg, "synthetic", split, None)`` builds real shards with
    no raw data. ``base_path`` may be a dict overriding height, width,
    num_frames, drives, step_m and depth_m. Drive i's texture comes from
    seed i, as in the JAX package's reader, bit for bit."""

    def __init__(self, split: str = "train", base_path=None):
        self.split = split
        self.base_path = base_path
        opts = dict(base_path) if isinstance(base_path, dict) else {}
        self.height = int(opts.get("height", 64))
        self.width = int(opts.get("width", 128))
        self.num_frames = int(opts.get("num_frames", 12))
        self.n_drives = int(opts.get("drives", 2))
        self.step_m = float(opts.get("step_m", 0.5))
        self.depth_m = float(opts.get("depth_m", 10.0))
        fx = self.width * 0.6
        self.intrinsic = np.array(
            [[fx, 0, self.width / 2], [0, fx, self.height / 2], [0, 0, 1]],
            np.float32)
        self.texture = None
        self.frame_names: list = []

    def list_drive_paths(self):
        return [f"synthetic_{i:02d}" for i in range(self.n_drives)]

    def init_drive(self, drive_path):
        seed = int(str(drive_path).rsplit("_", 1)[-1])
        self.texture = _texture(self.height, self.width, np.random.RandomState(seed))
        self.frame_names = [f"{drive_path}/{i:04d}" for i in range(self.num_frames)]

    def num_frames_(self):
        return self.num_frames

    def get_range_(self):
        return range(2, self.num_frames - 2)

    def get_image(self, index, right=False):
        if right:
            return None
        img = _render_plane(self.texture, self.intrinsic[0, 0], index * self.step_m,
                            self.depth_m)
        return ((np.clip(img, -1, 1) + 1) / 2 * 255).astype(np.uint8)

    def get_pose(self, index, right=False):
        pose = np.eye(4, dtype=np.float32)  # camera-to-world
        pose[0, 3] = index * self.step_m
        return pose

    def get_point_cloud(self, index, right=False):
        from xpt_mde_tpu_torch.data.depth_map import depth_map_to_point_cloud
        depth = np.full((self.height, self.width), self.depth_m, np.float32)
        return depth_map_to_point_cloud(depth, self.intrinsic)

    def get_intrinsic(self, index=0, right=False):
        return self.intrinsic.copy()

    def get_stereo_extrinsic(self, index=0):
        return None

    def index_to_id(self, index):
        return index
