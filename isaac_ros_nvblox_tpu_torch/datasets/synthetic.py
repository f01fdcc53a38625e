"""Synthetic dataset (port of isaac_ros_nvblox_tpu/datasets/synthetic.py):
a rendered orbit through an analytic scene, whose SDF doubles as the
reconstruction's ground truth.

Frames are rendered by `models/scene.py` on the loader's device (`cuda`
unless the caller asks for another) and handed out as numpy arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from isaac_ros_nvblox_tpu_torch.core.types import resolve_device
from isaac_ros_nvblox_tpu_torch.datasets.base import (DataLoader,
                                                      DataLoadResult, Frame)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.scene import (Scene,
                                                     default_test_scene,
                                                     orbit_pose, render_color,
                                                     render_depth)


class SyntheticDataLoader(DataLoader):
    def __init__(self, num_frames: int = 32,
                 scene: Optional[Scene] = None,
                 camera: Optional[Camera] = None,
                 with_color: bool = True,
                 orbit_radius: float = 2.0,
                 fps: float = 30.0,
                 device=None):
        self.scene = scene or default_test_scene()
        self.camera = camera or Camera(fx=320.0, fy=320.0, cx=159.5, cy=119.5,
                                       width=320, height=240)
        self.num_frames = num_frames
        self.with_color = with_color
        self.orbit_radius = orbit_radius
        self.fps = fps
        self.device = resolve_device(device)
        self._i = 0

    def load_next(self):
        if self._i >= self.num_frames:
            return DataLoadResult.NO_MORE_DATA, None
        t = 2.0 * np.pi * self._i / max(self.num_frames, 1)
        T = orbit_pose(t, radius=self.orbit_radius)
        depth = render_depth(self.scene, self.camera, T,
                             device=self.device).cpu().numpy()
        color = (render_color(self.scene, self.camera, T,
                              device=self.device).cpu().numpy()
                 if self.with_color else None)
        frame = Frame(depth=depth, T_L_C=T, camera=self.camera, color=color,
                      timestamp_s=self._i / self.fps)
        self._i += 1
        return DataLoadResult.SUCCESS, frame
