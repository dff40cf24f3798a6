"""LiDAR <-> depth-map conversions, host-side numpy at data-prep time
(port of ``xpt_mde_tpu.data.depth_map``; same arithmetic, so the same
bits, ``tests/test_torch_shard_chain.py``).

- ``point_cloud_to_depth_map``: project points through K and bilinearly
  splat each depth into its 4 neighbour pixels with (1-|du|)(1-|dv|)
  weights; ``np.add.at`` accumulates every duplicate hit, and pixels whose
  summed weight is under 0.5 are dropped.
- ``depth_map_to_point_cloud`` and the sparse-aware ``resize_depth_map``.
"""

from __future__ import annotations

import numpy as np


def point_cloud_to_depth_map(src_pcd: np.ndarray, intrinsic: np.ndarray,
                             imshape) -> np.ndarray:
    """
    :param src_pcd: [N, 3] camera-frame points (X=right, Y=down, Z=front)
    :param intrinsic: [3, 3]
    :param imshape: (height, width) of the output depth map
    :return: [height, width] float32 sparse depth map
    """
    height, width = imshape[:2]
    points = src_pcd[src_pcd[:, 2] > 1.0].T  # [3, N]
    if points.shape[1] == 0:
        return np.zeros((height, width), np.float32)
    pixels = intrinsic @ points / points[2:3]
    valid = ((pixels[0] >= 0) & (pixels[0] < width - 1)
             & (pixels[1] >= 0) & (pixels[1] < height - 1))
    pixels = pixels[:, valid]
    depths = points[2, valid]

    u, v = pixels[0], pixels[1]
    u0, v0 = np.floor(u).astype(np.int64), np.floor(v).astype(np.int64)
    u1, v1 = np.ceil(u).astype(np.int64), np.ceil(v).astype(np.int64)

    depthmap = np.zeros((height, width), np.float32)
    weightmap = np.zeros((height, width), np.float32)
    for un, vn in ((u0, v0), (u0, v1), (u1, v0), (u1, v1)):
        w = (1.0 - np.abs(u - un)) * (1.0 - np.abs(v - vn))
        np.add.at(depthmap, (vn, un), depths * w)
        np.add.at(weightmap, (vn, un), w)

    nz = depthmap > 0
    depthmap[nz] = depthmap[nz] / weightmap[nz]
    depthmap[weightmap < 0.5] = 0
    return depthmap


def depth_map_to_point_cloud(depth_map: np.ndarray,
                             intrinsic: np.ndarray) -> np.ndarray:
    """Back-project a depth map to [N, 3] camera-frame points (depths
    over 0.1); maps over 1e6 pixels are subsampled 2x in each axis."""
    depth_map = np.array(depth_map)
    if depth_map.ndim == 3:
        depth_map = depth_map[:, :, 0]
    u_grid, v_grid = np.meshgrid(np.arange(depth_map.shape[1]),
                                 np.arange(depth_map.shape[0]))
    if depth_map.size > 1e6:  # subsample very large maps
        depth_map = depth_map.copy()
        depth_map[0:-1:2, :] = 0.0
        depth_map[:, 0:-1:2] = 0.0
    z = depth_map.reshape(-1)
    x = (u_grid.reshape(-1) - intrinsic[0, 2]) / intrinsic[0, 0] * z
    y = (v_grid.reshape(-1) - intrinsic[1, 2]) / intrinsic[1, 1] * z
    points = np.stack([x, y, z], axis=1)
    return points[z > 0.1]


def resize_depth_map(depth_map: np.ndarray, srcshape_hw,
                     dstshape_hw) -> np.ndarray:
    """Sparse-aware depth resize: average the valid source pixels in each
    destination pixel's footprint."""
    if depth_map.ndim == 3:
        depth_map = depth_map[:, :, 0]
    du, dv = np.meshgrid(np.arange(dstshape_hw[1]), np.arange(dstshape_hw[0]))
    du, dv = du.reshape(-1), dv.reshape(-1)
    scale_y = srcshape_hw[0] / dstshape_hw[0]
    scale_x = srcshape_hw[1] / dstshape_hw[1]
    su = (du * scale_x).astype(np.int64)
    sv = (dv * scale_y).astype(np.int64)
    radi_x, radi_y = int(scale_x / 2), int(scale_y / 2)

    dst_depth = np.zeros(du.shape, np.float32)
    weight = np.zeros(du.shape, np.float32)
    for sdy in range(-radi_y, radi_y + 1):
        for sdx in range(-radi_x, radi_x + 1):
            v_inds = np.clip(sv + sdy, 0, srcshape_hw[0] - 1)
            u_inds = np.clip(su + sdx, 0, srcshape_hw[1] - 1)
            tmp = depth_map[v_inds, u_inds]
            dst_depth += tmp
            weight += (tmp > 0)
    nz = weight > 0
    dst_depth[nz] /= weight[nz]
    return dst_depth.reshape(dstshape_hw[0], dstshape_hw[1], 1)
