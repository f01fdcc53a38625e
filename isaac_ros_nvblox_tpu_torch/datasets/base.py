"""Dataset loader interface (port of isaac_ros_nvblox_tpu/datasets/base.py).

Reference: `nvblox/datasets/data_loader_interface.h` with
`DataLoadResult{kSuccess, kBadFrame, kNoMoreData}` (fuser_node.cpp:217-220).
Frames hold numpy arrays, as the reference's do; the mapper copies them to
its device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from isaac_ros_nvblox_tpu_torch.models.camera import Camera


class DataLoadResult(enum.Enum):
    SUCCESS = "success"
    BAD_FRAME = "bad_frame"
    NO_MORE_DATA = "no_more_data"


@dataclasses.dataclass
class Frame:
    """One RGB-D frame: depth (meters, 0=invalid), optional color, pose."""
    depth: np.ndarray                 # f32[H, W]
    T_L_C: np.ndarray                 # f32[4, 4]
    camera: Camera
    color: Optional[np.ndarray] = None  # u8[H, W, 3]
    timestamp_s: float = 0.0


class DataLoader:
    """Sequential frame loader (nvblox's DataLoaderInterface)."""

    def load_next(self) -> tuple[DataLoadResult, Optional[Frame]]:
        raise NotImplementedError

    def __iter__(self):
        while True:
            result, frame = self.load_next()
            if result == DataLoadResult.NO_MORE_DATA:
                return
            if result == DataLoadResult.BAD_FRAME:
                continue
            yield frame
