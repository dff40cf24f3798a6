"""Offline tool: static-frame detection by optical flow (port of
``xpt_mde_tpu.data.list_static_frames``). For each KITTI-odometry
sequence it computes OpenCV's dense Farneback flow between consecutive
frames (at half size) and lists the frames whose share of pixels moving
2-50 px is under a threshold (the vehicle stands still). The output has
the static-frame resource files' format: "<drive> <frame_id>" lines. It
needs OpenCV, which it imports where it reads and compares frames.

Usage (on a data-preparation machine):
    python -m xpt_mde_tpu_torch.data.list_static_frames <kitti_odom_root> <out.txt>
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def flow_valid_ratio(frame_a: np.ndarray, frame_b: np.ndarray,
                     min_flow: float = 2.0, max_flow: float = 50.0) -> float:
    """Fraction of pixels with plausible inter-frame motion."""
    import cv2
    gray_a = cv2.cvtColor(frame_a, cv2.COLOR_BGR2GRAY)
    gray_b = cv2.cvtColor(frame_b, cv2.COLOR_BGR2GRAY)
    flow = cv2.calcOpticalFlowFarneback(
        gray_a, gray_b, flow=None, pyr_scale=0.5, levels=3, winsize=10,
        iterations=3, poly_n=5, poly_sigma=1.1, flags=0)
    dist = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    valid = np.count_nonzero((min_flow < dist) & (dist < max_flow))
    return valid / dist.size


def list_static_frames(seq_dir, threshold: float = 0.5,
                       subsample: int = 1) -> list[int]:
    """Frame ids in one sequence dir whose flow to the previous frame is
    mostly static."""
    import cv2
    seq_dir = Path(seq_dir)
    frames = sorted((seq_dir / "image_2").glob("*.png"))
    static = []
    prev = None
    for i, path in enumerate(frames):
        if i % subsample:
            continue
        img = cv2.imread(str(path))
        if img is None:
            continue
        img = cv2.resize(img, (img.shape[1] // 2, img.shape[0] // 2))
        if prev is not None and flow_valid_ratio(prev, img) < threshold:
            static.append(int(path.stem))
        prev = img
    return static


def main(kitti_odom_root, out_path):
    root = Path(kitti_odom_root)
    lines = []
    for seq_dir in sorted((root / "sequences").glob("[0-9][0-9]")):
        seq = seq_dir.name
        static = list_static_frames(seq_dir)
        lines.extend(f"{seq} {fid:06d}" for fid in static)
        print(f"[list_static_frames] {seq}: {len(static)} static frames")
    Path(out_path).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
