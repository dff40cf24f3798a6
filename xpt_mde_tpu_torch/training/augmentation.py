"""Batch augmentation: crop + resize, horizontal flip, color jitter (port of
``xpt_mde_tpu.training.augmentation``).

Semantics kept from the JAX package:

- one decision and one parameter set per batch, shared by every sample
  and by the left and right views of a stereo batch;
- CropAndResize crops a normalized box (y1, x1, y2, x2) and resizes it
  back to (H, W) as ``jax.image.scale_and_translate(method="linear")``
  does (half-pixel centres, triangle weights renormalized over in-frame
  pixels, one separable weight matrix per axis), crops ``depth_gt`` and
  ``depth_gt_R`` nearest, and adjusts the intrinsics (cx' = (cx - x1 W) /
  (x2 - x1), fx' = fx / (x2 - x1), likewise for y);
- HorizontalFlip mirrors the images, maps K to |[[0,0,W],0,0] - K| and
  conjugates the poses and ``stereo_T_LR`` by diag(-1, 1, 1, 1)
  (``depth_gt`` is not mirrored and the left and right views are not
  swapped, as in the JAX package);
- ColorJitter blends towards the channel mean by ``saturation`` in [0.5,
  1.5] and applies ``gamma`` in [0.5, 1.5] on the [0, 1] image.

Random draws: jax.random and torch.Generator give different numbers, so
the distributions are kept, not the streams. Every draw comes from a CPU
``torch.Generator`` (a few scalars per batch, so the device is never
synchronized) and each augmenter's ``apply`` takes its drawn parameters
directly, so tests can pin them. Everything else is built on the
images' device from those host scalars: no host-to-device copy either.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch


def _uniform(generator, size: int, low: float, high: float) -> list[float]:
    """``size`` float32 draws in [low, high) from a CPU generator."""
    draws = torch.rand(size, generator=generator, dtype=torch.float32)
    return (draws * (high - low) + low).tolist()


def _linear_weight_mat(in_size: int, out_size: int, scale: np.float32,
                       translation: np.float32, device) -> torch.Tensor:
    """[in_size, out_size] resampling weights of
    ``jax._src.image.scale.compute_weight_mat`` for the linear (triangle)
    kernel with antialiasing, in float32."""
    inv_scale = np.float32(1.0) / scale
    kernel_scale = float(max(inv_scale, np.float32(1.0)))
    shift = float(translation * inv_scale)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
                * float(inv_scale) - shift - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = torch.abs(sample_f[None, :] - src[:, None]) / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = torch.sum(weights, dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def crop_resize_5d(image5d: torch.Tensor, box: Sequence[float]) -> torch.Tensor:
    """Crop the normalized ``box`` (y1, x1, y2, x2) of [B, S, H, W, C] and
    resize it back to (H, W) (``_crop_resize_5d``)."""
    h, w = image5d.shape[2:4]
    y1, x1, y2, x2 = (np.float32(b) for b in box)
    scale_y = np.float32(1.0) / (y2 - y1)
    scale_x = np.float32(1.0) / (x2 - x1)
    wy = _linear_weight_mat(h, h, scale_y, -y1 * np.float32(h) * scale_y, image5d.device)
    wx = _linear_weight_mat(w, w, scale_x, -x1 * np.float32(w) * scale_x, image5d.device)
    out = torch.einsum("bshwc,wj->bshjc", image5d, wx)
    return torch.einsum("bshjc,hi->bsijc", out, wy)


def crop_nearest(image: torch.Tensor, box: Sequence[float]) -> torch.Tensor:
    """Nearest crop + resize of [B, H, W, C] (sparse depth maps,
    ``_crop_nearest``)."""
    h, w = image.shape[1:3]
    y1, x1, y2, x2 = (np.float32(b) for b in box)

    def source_index(size, lo, hi):
        pos = ((torch.arange(size, dtype=torch.float32, device=image.device) + 0.5)
               * float(hi - lo) + float(lo * np.float32(size)))
        return torch.clamp(torch.floor(pos), 0, size - 1).long()

    return image.index_select(1, source_index(h, y1, y2)).index_select(
        2, source_index(w, x1, x2))


class CropAndResize:
    """Random crop (shared across the batch) resized back to full size."""

    def __init__(self, aug_prob: float = 0.2, half_crop_ratio: float = 0.1):
        self.aug_prob = aug_prob
        self.half_crop_ratio = half_crop_ratio

    def draw(self, generator=None) -> tuple[float, float, float, float]:
        """The box (y1, x1, y2, x2): each offset lands in (0,
        half_crop_ratio] with probability aug_prob and is 0 otherwise."""
        maxval1 = self.half_crop_ratio
        minval1 = -(1.0 - self.aug_prob) * self.half_crop_ratio / self.aug_prob
        y1x1 = _uniform(generator, 2, minval1, maxval1)
        y2x2 = _uniform(generator, 2, 1.0 - maxval1, 1.0 - minval1)
        return tuple(min(max(b, 0.0), 1.0) for b in y1x1 + y2x2)

    def __call__(self, features: dict, generator=None) -> dict:
        return self.apply(features, self.draw(generator))

    def apply(self, features: dict, box: Sequence[float]) -> dict:
        height, width = features["image5d"].shape[2:4]
        out = dict(features)
        for sfx in ("", "_R"):
            if "image5d" + sfx in features:
                out["image5d" + sfx] = crop_resize_5d(features["image5d" + sfx], box)
                out["intrinsic" + sfx] = self.adjust_intrinsic(features["intrinsic" + sfx],
                                                               box, height, width)
            if "depth_gt" + sfx in features:
                out["depth_gt" + sfx] = crop_nearest(features["depth_gt" + sfx], box)
        return out

    @staticmethod
    def adjust_intrinsic(intrinsic: torch.Tensor, box: Sequence[float],
                         height: int, width: int) -> torch.Tensor:
        """K [B, 3, 3] of the crop (``_adjust_intrinsic``)."""
        y1, x1, y2, x2 = (np.float32(b) for b in box)
        center = torch.zeros(3, 3, dtype=intrinsic.dtype, device=intrinsic.device)
        center[0, 2] = float(x1 * np.float32(width))
        center[1, 2] = float(y1 * np.float32(height))
        cropped = intrinsic - center
        x_ratio = float(np.float32(1.0) / (x2 - x1))
        y_ratio = float(np.float32(1.0) / (y2 - y1))
        return torch.stack([cropped[:, 0] * x_ratio, cropped[:, 1] * y_ratio,
                            cropped[:, 2]], dim=1)


class HorizontalFlip:
    def __init__(self, aug_prob: float = 0.2):
        self.aug_prob = aug_prob

    def draw(self, generator=None) -> bool:
        return _uniform(generator, 1, 0.0, 1.0)[0] < self.aug_prob

    def __call__(self, features: dict, generator=None) -> dict:
        return self.apply(features, self.draw(generator))

    def apply(self, features: dict, do_flip: bool) -> dict:
        return self.flip(features) if do_flip else dict(features)

    @staticmethod
    def flip(features: dict) -> dict:
        """Mirror the snippets, their intrinsics and the poses (``_flip``)."""
        width = features["image5d"].shape[-2]
        out = dict(features)
        for sfx in ("", "_R"):
            if "image5d" + sfx in features:
                out["image5d" + sfx] = torch.flip(features["image5d" + sfx], dims=[-2])
            if "intrinsic" + sfx in features:
                intrinsic = features["intrinsic" + sfx]
                wh = torch.zeros(3, 3, dtype=intrinsic.dtype, device=intrinsic.device)
                wh[0, 2] = width
                out["intrinsic" + sfx] = torch.abs(wh - intrinsic)
        for key in ("pose_gt", "pose_gt_R", "stereo_T_LR"):
            if key in features:
                # T P T with T = diag(-1, 1, 1, 1): flip the sign of row 0
                # and column 0 (the products with +-1 and 0 are exact)
                pose = features[key].clone()
                pose[..., 0, :] *= -1.0
                pose[..., :, 0] *= -1.0
                out[key] = pose
        return out


class ColorJitter:
    def __init__(self, aug_prob: float = 0.2):
        self.aug_prob = aug_prob

    def draw(self, generator=None) -> tuple[bool, float, float]:
        """(do_jitter, gamma, saturation), in the JAX package's order."""
        do_jitter = _uniform(generator, 1, 0.0, 1.0)[0] < self.aug_prob
        gamma = _uniform(generator, 1, 0.5, 1.5)[0]
        saturation = _uniform(generator, 1, 0.5, 1.5)[0]
        return do_jitter, gamma, saturation

    def __call__(self, features: dict, generator=None) -> dict:
        return self.apply(features, *self.draw(generator))

    def apply(self, features: dict, do_jitter: bool, gamma: float,
              saturation: float) -> dict:
        out = dict(features)
        if do_jitter:
            for key in ("image5d", "image5d_R"):
                if key in features:
                    out[key] = self.jitter(features[key], gamma, saturation)
        return out

    @staticmethod
    def jitter(image: torch.Tensor, gamma: float, saturation: float) -> torch.Tensor:
        """Saturation then gamma on the [0, 1] image (``_jitter``)."""
        x = (image + 1.0) / 2.0
        gray = torch.mean(x, dim=-1, keepdim=True)
        x = torch.clamp(gray + saturation * (x - gray), 0.0, 1.0)
        x = torch.pow(torch.clamp(x, min=1e-6), gamma)
        return x * 2.0 - 1.0


class TotalAugment:
    """Chain of augmenters, each drawing from the same generator in turn."""

    def __init__(self, augmenters: Sequence):
        self.augmenters = list(augmenters)

    def __call__(self, features: dict, generator=None) -> dict:
        for aug in self.augmenters:
            features = aug(features, generator)
        return features


def augmentation_factory(augment_probs: Mapping[str, float] | None) -> TotalAugment:
    """Build the augment chain from a {name: prob} dict."""
    augmenters = []
    for key, prob in (augment_probs or {}).items():
        if key == "CropAndResize":
            augmenters.append(CropAndResize(prob))
        elif key == "HorizontalFlip":
            augmenters.append(HorizontalFlip(prob))
        elif key == "ColorJitter":
            augmenters.append(ColorJitter(prob))
        else:
            raise ValueError(f"Wrong augmentation type: {key}")
    return TotalAugment(augmenters)
