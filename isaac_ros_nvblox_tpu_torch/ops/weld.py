"""Vertex welding of a host triangle soup (numpy; the port's copy of the
numpy path of isaac_ros_nvblox_tpu/native/__init__.py::weld_mesh).

Vertices are keyed by their position rounded to a quantum; vertices with
one key become one, and each triangle indexes the welded vertices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def weld_mesh(verts: np.ndarray, colors: np.ndarray, quantum: float
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weld a triangle soup `f32[T, 3, 3]` (with per-vertex colors of the
    same shape, 0-255) -> (vertices f32[V, 3], colors u8[V, 3],
    triangles i32[T, 3]). Each welded vertex keeps the position and color
    of its first occurrence in key order."""
    flat_v = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    flat_c = np.ascontiguousarray(colors, np.float32).reshape(-1, 3)
    q = np.round(flat_v / quantum).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    return (flat_v[first],
            np.clip(flat_c[first], 0, 255).astype(np.uint8),
            inv.reshape(-1, 3).astype(np.int32))
