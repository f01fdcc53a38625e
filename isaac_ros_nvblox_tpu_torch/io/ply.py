"""PLY export of meshes and voxel layers (port of
isaac_ros_nvblox_tpu/io/ply.py for the device mapper).

Reference: `io::outputColorMeshLayerToPly` / `io::outputVoxelLayerToPly`
(nvblox/io/mesh_io.h; the save_ply service, nvblox_node.cpp:1612-1628).
Binary little-endian PLY, with vertex colors when given. The numpy writers
here are byte for byte those of the reference; `native.write_mesh_ply`
writes the same bytes from C++.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks


def write_mesh_ply(path, vertices: np.ndarray, triangles: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> None:
    """Write a triangle mesh as binary PLY: vertices f32[V, 3], triangles
    i32[T, 3], colors u8[V, 3] (optional)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    V = int(vertices.shape[0])
    T = int(triangles.shape[0])
    has_color = colors is not None and len(colors) == V
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {V}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {T}", "property list uchar int vertex_indices",
               "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(V, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = vertices.astype(np.float32)
            rec["rgb"] = colors.astype(np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(vertices.astype("<f4").tobytes())
        face = np.zeros(T, dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face["n"] = 3
        face["idx"] = triangles.astype(np.int32)
        f.write(face.tobytes())


def write_pointcloud_ply(path, points: np.ndarray,
                         intensities: Optional[np.ndarray] = None) -> None:
    """Write a point cloud f32[N, 3], optionally with a float intensity
    property."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    V = int(points.shape[0])
    has_i = intensities is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {V}",
              "property float x", "property float y", "property float z"]
    if has_i:
        header += ["property float intensity"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_i:
            rec = np.zeros(V, dtype=[("xyz", "<f4", 3), ("i", "<f4")])
            rec["xyz"] = points.astype(np.float32)
            rec["i"] = np.asarray(intensities, np.float32)
            f.write(rec.tobytes())
        else:
            f.write(points.astype("<f4").tobytes())


@torch.no_grad()
def write_voxel_layer_ply_device(path, m, channel: str,
                                 min_weight: float = 1e-4) -> int:
    """A device mapper's voxel channel as an intensity point cloud at the
    voxel centres of its live blocks: "tsdf" (weight >= min_weight),
    "esdf" (signed meters, observed voxels), "occupancy" (log-odds,
    observed) or "freespace" (high confidence, every voxel). Returns the
    number of points."""
    live = wg.live_slot_mask(m.state)
    slots = torch.nonzero(live).squeeze(1)
    if slots.numel() == 0:
        write_pointcloud_ply(path, np.zeros((0, 3), np.float32),
                             np.zeros((0,), np.float32))
        return 0
    bidx = m.state.block_index_of_slot[slots]
    centers = voxel_centers_for_blocks(bidx, m.voxel_size_m).cpu().numpy()
    centers = centers.reshape(-1, 3)
    need = {"esdf": ("esdf_sq_dist", "esdf_is_inside", "esdf_observed"),
            "tsdf": ("tsdf_distance", "tsdf_weight"),
            "occupancy": ("occupancy_log_odds", "occupancy_observed"),
            "freespace": ("freespace_high_confidence",)}
    if channel not in need:
        raise ValueError(f"unknown channel {channel!r}")
    ch = {k: m.channels[k][slots].cpu().numpy() for k in need[channel]}
    if channel == "esdf":
        sq = np.minimum(ch["esdf_sq_dist"], 1e12)
        vals = np.minimum(np.sqrt(sq) * m.voxel_size_m,
                          m.params.esdf.max_esdf_distance_m)
        vals = np.where(ch["esdf_is_inside"], -vals, vals).reshape(-1)
        mask = ch["esdf_observed"].reshape(-1).astype(bool)
    elif channel == "tsdf":
        vals = ch["tsdf_distance"].reshape(-1)
        mask = ch["tsdf_weight"].reshape(-1) >= min_weight
    elif channel == "occupancy":
        vals = ch["occupancy_log_odds"].reshape(-1)
        mask = ch["occupancy_observed"].reshape(-1) > 0
    else:
        vals = ch["freespace_high_confidence"].reshape(-1).astype(np.float32)
        mask = np.ones_like(vals, bool)
    write_pointcloud_ply(path, centers[mask], vals[mask].astype(np.float32))
    return int(mask.sum())
