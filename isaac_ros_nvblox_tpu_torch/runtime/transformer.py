"""Transformer: pose resolution for sensor frames.

Reference: nvblox_ros `Transformer` (nvblox_ros/src/lib/transformer.cpp:42-184)
— resolves T_layer_sensor at a message timestamp from either a TF tree or
queued transform/pose topics with nearest-neighbor timestamp matching, plus
a static sensor-extrinsics cache.

Port of isaac_ros_nvblox_tpu/runtime/transformer.py: no ROS/TF
dependency — a pose queue per frame with nearest-neighbor lookup within
tolerance and optional interpolation, plus a static frame->extrinsic cache
(frame_id -> T_parent_child). Lookups stay on the host: the interpolation
runs `Transform.interpolate` on CPU float32 tensors and returns numpy.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import Transform


class Transformer:
    def __init__(self, global_frame: str = "odom",
                 timestamp_tolerance_s: float = 0.05,
                 use_interpolation: bool = True,
                 max_queue_length: int = 500):
        self.global_frame = global_frame
        self.timestamp_tolerance_s = timestamp_tolerance_s
        self.use_interpolation = use_interpolation
        self.max_queue_length = max_queue_length
        self._lock = threading.Lock()
        # frame -> sorted list of (t, T_G_F)
        self._queues: Dict[str, Tuple[list, list]] = {}
        # static extrinsics: child frame -> (parent, T_parent_child)
        self._static: Dict[str, Tuple[str, np.ndarray]] = {}

    def add_static_transform(self, parent: str, child: str,
                             T_parent_child: np.ndarray) -> None:
        self._static[child] = (parent, np.asarray(T_parent_child, np.float32))

    def add_pose(self, frame: str, timestamp_s: float,
                 T_G_F: np.ndarray) -> None:
        """Feed a timestamped pose of `frame` in the global frame
        (parity: transform/pose topic callbacks, transformer.cpp:95-128)."""
        with self._lock:
            ts, Ts = self._queues.setdefault(frame, ([], []))
            i = bisect.bisect_left(ts, timestamp_s)
            ts.insert(i, timestamp_s)
            Ts.insert(i, np.asarray(T_G_F, np.float32))
            if len(ts) > self.max_queue_length:
                del ts[0], Ts[0]

    def _resolve_dynamic(self, frame: str, timestamp_s: float
                         ) -> Optional[np.ndarray]:
        ts, Ts = self._queues.get(frame, ([], []))
        if not ts:
            return None
        i = bisect.bisect_left(ts, timestamp_s)
        candidates = []
        if i < len(ts):
            candidates.append(i)
        if i > 0:
            candidates.append(i - 1)
        best = min(candidates, key=lambda j: abs(ts[j] - timestamp_s))
        if abs(ts[best] - timestamp_s) > self.timestamp_tolerance_s:
            # Try interpolation between bracketing poses.
            if (self.use_interpolation and 0 < i < len(ts)
                    and ts[i - 1] <= timestamp_s <= ts[i]):
                alpha = (timestamp_s - ts[i - 1]) / max(ts[i] - ts[i - 1], 1e-9)
                return Transform.interpolate(
                    torch.from_numpy(Ts[i - 1]), torch.from_numpy(Ts[i]),
                    float(np.float32(alpha))).numpy()
            return None
        return Ts[best]

    def lookup_transform_to_global_frame(self, frame: str, timestamp_s: float
                                         ) -> Optional[np.ndarray]:
        """T_G_frame at the given time, chaining static extrinsics onto the
        nearest queued dynamic pose (parity:
        lookupTransformToGlobalFrame, transformer.cpp:42-83)."""
        with self._lock:
            T_static = np.eye(4, dtype=np.float32)
            f = frame
            # Walk static chain upward until a dynamically-tracked frame.
            seen = set()
            while f in self._static and f not in self._queues:
                if f in seen:
                    return None
                seen.add(f)
                parent, T_p_f = self._static[f]
                T_static = T_p_f @ T_static
                f = parent
            if f == self.global_frame:
                return T_static
            T_G_f = self._resolve_dynamic(f, timestamp_s)
            if T_G_f is None:
                return None
            return T_G_f @ T_static

    def can_transform(self, frame: str, timestamp_s: float) -> bool:
        return self.lookup_transform_to_global_frame(frame, timestamp_s) is not None
