"""Visualization marker helpers.

Reference: nvblox_ros visualization helpers (src/lib/visualization.cpp,
include/nvblox_ros/visualization.hpp:33-77): turn planes, height limits,
workspace AABBs, and clear-shapes into RViz marker messages.

Here markers are transport-agnostic dataclasses published on the message
bus; any front end (the HTML viewer in tools/, Foxglove-style consumers)
can render them.

A copy of isaac_ros_nvblox_tpu/runtime/visualization.py for the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from isaac_ros_nvblox_tpu_torch.runtime.msgs import Header


@dataclasses.dataclass
class Marker:
    """Minimal marker: a colored primitive in the layer frame."""
    header: Header
    ns: str
    kind: str                      # "cube" | "sphere" | "plane" | "lines"
    pose_T: np.ndarray             # f32[4, 4]
    scale: Tuple[float, float, float]
    color_rgba: Tuple[float, float, float, float]
    points: Optional[np.ndarray] = None  # for "lines": f32[N, 2, 3]


def plane_marker(plane, center_xy: Tuple[float, float], size_m: float = 2.0,
                 frame_id: str = "odom", stamp_s: float = 0.0) -> Marker:
    """Visualize a ground plane fit as a thin oriented box (parity:
    visualization.cpp plane marker)."""
    cx, cy = center_xy
    cz = plane.height_at(cx, cy)
    n = plane.normal()
    # Build a rotation whose z axis is the plane normal.
    z = n / np.linalg.norm(n)
    x = np.cross([0.0, 1.0, 0.0], z)
    if np.linalg.norm(x) < 1e-6:
        x = np.asarray([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2] = x, y, z
    T[:3, 3] = (cx, cy, cz)
    return Marker(header=Header(stamp_s, frame_id), ns="ground_plane",
                  kind="plane", pose_T=T, scale=(size_m, size_m, 0.01),
                  color_rgba=(0.2, 0.8, 0.2, 0.5))


def aabb_marker(min_m, max_m, ns: str = "workspace_bounds",
                frame_id: str = "odom", stamp_s: float = 0.0) -> Marker:
    """Workspace-bounds / clear-shape AABB as a wireframe-ish cube marker."""
    min_m = np.asarray(min_m, np.float64)
    max_m = np.asarray(max_m, np.float64)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (min_m + max_m) / 2.0
    size = tuple((max_m - min_m).tolist())
    return Marker(header=Header(stamp_s, frame_id), ns=ns, kind="cube",
                  pose_T=T, scale=size, color_rgba=(0.2, 0.2, 0.9, 0.25))


def height_limit_marker(height_m: float, extent_m: float = 10.0,
                        ns: str = "height_limit", frame_id: str = "odom",
                        stamp_s: float = 0.0) -> Marker:
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = height_m
    return Marker(header=Header(stamp_s, frame_id), ns=ns, kind="plane",
                  pose_T=T, scale=(extent_m, extent_m, 0.005),
                  color_rgba=(0.9, 0.6, 0.1, 0.3))


def sphere_marker(center_m, radius_m: float, ns: str = "clear_shape",
                  frame_id: str = "odom", stamp_s: float = 0.0) -> Marker:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = np.asarray(center_m, np.float32)
    d = 2.0 * radius_m
    return Marker(header=Header(stamp_s, frame_id), ns=ns, kind="sphere",
                  pose_T=T, scale=(d, d, d),
                  color_rgba=(0.9, 0.2, 0.2, 0.35))
