"""Depth comparison panels and 3D point clouds (port of
``xpt_mde_tpu.evaluate.visualize``): side-by-side colormapped disparity
against other methods' precomputed results, and an Open3D overlay of the
predicted and the GT point clouds where open3d is installed. cv2 and
open3d are imported only where they draw."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def colormap_disparity(depth: np.ndarray, max_depth: float = 80.0):
    """A viridis disparity panel (BGR uint8) of a depth map."""
    import cv2

    depth = np.squeeze(depth)
    disp = np.zeros_like(depth)
    valid = depth > 1e-3
    disp[valid] = 1.0 / depth[valid]
    disp = disp / max(disp.max(), 1e-6)
    return cv2.applyColorMap((disp * 255).astype(np.uint8), cv2.COLORMAP_VIRIDIS)


def compare_depths(npz_path, out_dir, external_disparities: dict | None = None,
                   stride: int = 10) -> None:
    """``compare_{i:05d}.png`` every ``stride`` frames of saved predictions:
    image | ours | each external method, stacked vertically.

    :param external_disparities: method name -> [N, h, w] disparities (e.g.
        monodepth2's precomputed results)
    """
    import cv2

    results = dict(np.load(npz_path))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    num = results["depth"].shape[0]
    for i in range(0, num, stride):
        panels = [results["image"][i], colormap_disparity(results["depth"][i])]
        h, w = panels[0].shape[:2]
        for disps in (external_disparities or {}).values():
            disp = disps[i]
            disp = cv2.resize(disp / max(disp.max(), 1e-6), (w, h))
            panels.append(cv2.applyColorMap((disp * 255).astype(np.uint8),
                                            cv2.COLORMAP_VIRIDIS))
        cv2.imwrite(str(out_dir / f"compare_{i:05d}.png"), np.concatenate(panels, axis=0))
    print(f"[compare_depths] wrote panels to {out_dir}")


def visualize_point_cloud(npz_path, frame: int = 0):
    """Open3D window with the predicted (orange) and GT (blue) point
    clouds of one frame. :return: the clouds, or None without open3d"""
    try:
        import open3d as o3d
    except ImportError:
        print("[visualize_point_cloud] open3d not installed; "
              "use compare_depths for 2D panels instead")
        return None
    from xpt_mde_tpu_torch.data.depth_map import depth_map_to_point_cloud

    results = dict(np.load(npz_path))
    k = results["intrinsic"][frame]
    clouds = []
    for key, color in (("depth", [1.0, 0.3, 0.0]), ("depth_gt", [0.0, 0.3, 1.0])):
        if key not in results:
            continue
        cloud = o3d.geometry.PointCloud()
        cloud.points = o3d.utility.Vector3dVector(
            depth_map_to_point_cloud(np.squeeze(results[key][frame]), k))
        cloud.paint_uniform_color(color)
        clouds.append(cloud)
    o3d.visualization.draw_geometries(clouds)
    return clouds
