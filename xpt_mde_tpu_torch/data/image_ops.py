"""numpy counterparts of the two OpenCV calls on the example path, bit for
bit on uint8, so that building shards needs neither OpenCV nor PIL.

- :func:`resize_linear` is ``cv2.resize(img, (w, h))`` (``INTER_LINEAR``)
  on a uint8 image. OpenCV computes it in fixed point, not as a float
  bilinear: each axis's source index and fraction come from
  ``(d + 0.5) * scale - 0.5`` in float32, the two weights are rounded to
  11 bits (``INTER_RESIZE_COEF_BITS``), a row pass sums the two
  neighbours with them into int32 (the right edge, and everything past
  the first column whose right neighbour leaves the frame, takes the
  clamped pixel times 2048), and a column pass drops 4 bits of each row
  sum, multiplies by the row weights, drops 16 bits of each product and
  rounds the sum by ``(s + 2) >> 2``. Rows outside the frame clamp to the
  edge with their weights kept, columns to the left edge with the weight
  set to (1, 0). At equal size it copies; where the source is exactly
  twice the destination in both axes it averages each 2x2 block,
  ``(a + b + c + d + 2) >> 2`` (OpenCV's fast area path).
- :func:`gaussian_blur3` is ``cv2.GaussianBlur(img, (3, 3), 0)`` on a
  uint8 image: the kernel is [1, 2, 1] / 4 in each axis, exact in
  OpenCV's fixed point, so the result is ``(sum + 8) >> 4`` of the
  [1, 2, 1] x [1, 2, 1] weighted neighbours, with the border reflected
  about the edge pixel (``BORDER_REFLECT_101``).

``tests/test_torch_shard_chain.py`` holds both to ``cv2`` on seeded
images.
"""

from __future__ import annotations

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


def _source_coords(src_n: int, dst_n: int):
    """Per destination index: the left/top source index (floor) and the
    fraction, both as OpenCV forms them (the scale in float64, the
    coordinate and the fraction in float32)."""
    scale = 1.0 / (dst_n / src_n)
    coord = ((np.arange(dst_n) + 0.5) * scale - 0.5).astype(np.float32)
    index = np.floor(coord).astype(np.int64)
    frac = (coord - index.astype(np.float32)).astype(np.float32)
    return index, frac


def _weights(frac: np.ndarray):
    one, coef = np.float32(1), np.float32(COEF_SCALE)
    return (np.rint((one - frac) * coef).astype(np.int64),
            np.rint(frac * coef).astype(np.int64))


def resize_linear(image: np.ndarray, dsize_wh) -> np.ndarray:
    """``cv2.resize(image, dsize_wh)`` for a uint8 [H, W] or [H, W, C]
    image; ``dsize_wh`` is (width, height), as OpenCV takes it."""
    if image.dtype != np.uint8:
        raise TypeError(f"resize_linear takes uint8 images, not {image.dtype}")
    dst_w, dst_h = int(dsize_wh[0]), int(dsize_wh[1])
    src_h, src_w = image.shape[:2]
    if (src_h, src_w) == (dst_h, dst_w):
        return image.copy()
    pixels = image.astype(np.int64)
    if src_w == 2 * dst_w and src_h == 2 * dst_h:
        block = (pixels[0::2, 0::2] + pixels[0::2, 1::2]
                 + pixels[1::2, 0::2] + pixels[1::2, 1::2])
        return ((block + 2) >> 2).astype(np.uint8)

    # the row pass
    sx, fx = _source_coords(src_w, dst_w)
    left, right = sx < 0, sx >= src_w - 1
    sx[left], fx[left] = 0, 0
    sx[right], fx[right] = src_w - 1, 0
    a0, a1 = _weights(fx)
    chan = (slice(None),) + (None,) * (image.ndim - 2)
    rows = (pixels[:, sx] * a0[chan]
            + pixels[:, np.minimum(sx + 1, src_w - 1)] * a1[chan])
    past = sx + 1 >= src_w  # from the first such column on: the pixel alone
    if past.any():
        first = int(np.argmax(past))
        rows[:, first:] = pixels[:, sx[first:]] * COEF_SCALE

    # the column pass
    sy, fy = _source_coords(src_h, dst_h)
    b0, b1 = _weights(fy)
    r0, r1 = np.clip(sy, 0, src_h - 1), np.clip(sy + 1, 0, src_h - 1)
    col = (slice(None),) + (None,) * (image.ndim - 1)
    out = (((b0[col] * (rows[r0] >> 4)) >> 16)
           + ((b1[col] * (rows[r1] >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def gaussian_blur3(image: np.ndarray) -> np.ndarray:
    """``cv2.GaussianBlur(image, (3, 3), 0)`` for a uint8 [H, W] or
    [H, W, C] image of at least 2 x 2 pixels."""
    if image.dtype != np.uint8:
        raise TypeError(f"gaussian_blur3 takes uint8 images, not {image.dtype}")
    pad = ((1, 1), (1, 1)) + ((0, 0),) * (image.ndim - 2)
    p = np.pad(image.astype(np.int32), pad, mode="reflect")
    rows = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]
    total = rows[:-2] + 2 * rows[1:-1] + rows[2:]
    return ((total + 8) >> 4).astype(np.uint8)
