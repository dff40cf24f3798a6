"""Debug viewer of one example (port of ``xpt_mde_tpu.data.viewer``):
image / right image / viridis depth panels, and optionally the intrinsic
and the pose printed. Headless first: the panels are returned (and
written to ``save_dir`` where given); ``wait >= 0`` also opens cv2
windows where a display exists. Takes ExampleMaker examples (uint8
stacked snippets) and decoded loader rows alike."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def apply_color_map(depth: np.ndarray, max_depth: float = 50.0):
    """Depth map -> viridis BGR view, invalid (zero) pixels black."""
    import cv2

    depth = np.squeeze(np.asarray(depth))
    if depth.ndim > 2:
        depth = depth[..., 0]
    view = (np.clip(depth, 0, max_depth) / max_depth * 255).astype(np.uint8)
    view = cv2.applyColorMap(view, cv2.COLORMAP_VIRIDIS)
    view[depth == 0, :] = (0, 0, 0)
    return view


def _to_u8(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image
    return ((np.clip(image, -1, 1) + 1) / 2 * 255).astype(np.uint8)  # floats are [-1, 1]


def show_example(example: dict, wait: int = -1, print_param: bool = False,
                 max_height: int = 1000, suffix: str = "", save_dir=None) -> dict:
    """Build (and optionally show or save) the debug panels of one example.

    :param example: {"image": [H*S, W, 3] or [S, H, W, 3], optional
        "image_R", "depth_gt", "intrinsic", "pose_gt"}
    :param wait: cv2.waitKey delay; < 0 opens no window (headless)
    :param save_dir: where given, the panels are written there as pngs
    :return: {panel_name: uint8 BGR array}
    """
    import cv2

    panels = {}
    for key in ("image", "image_R"):
        if example.get(key) is None:
            continue
        img = _to_u8(example[key])
        if img.ndim == 4:  # [S, H, W, 3] snippet -> vertical stack
            img = img.reshape(-1, img.shape[-2], img.shape[-1])
        if max_height and img.shape[0] > max_height:
            w = int(img.shape[1] * max_height / img.shape[0])
            img = cv2.resize(img, (w, max_height))
        panels[key + suffix] = img
    if example.get("depth_gt") is not None:
        panels["depth" + suffix] = apply_color_map(example["depth_gt"])

    if print_param:
        print("\nintrinsic:\n", np.asarray(example["intrinsic"]))
        if example.get("pose_gt") is not None:
            import torch

            from xpt_mde_tpu_torch.utils import se3
            from xpt_mde_tpu_torch.utils.precision import full_f32

            with full_f32():
                pose = torch.as_tensor(np.asarray(example["pose_gt"], np.float64))
                print("pose\n", se3.matrix_to_twist(pose).numpy())

    if save_dir is not None:
        save_dir = Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        for name, panel in panels.items():
            cv2.imwrite(str(save_dir / f"{name}.png"), panel)
    if wait >= 0:
        for name, panel in panels.items():
            cv2.imshow(name, panel)
        cv2.waitKey(wait)
    return panels
