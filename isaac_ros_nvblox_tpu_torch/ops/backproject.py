"""Depth back-projection and point-cloud transforms (port of
isaac_ros_nvblox_tpu/ops/backproject.py): nvblox's back-projected depth
debug output and the dynamic point cloud read them.
"""

from __future__ import annotations

import torch

from isaac_ros_nvblox_tpu_torch.core.types import Transform
from isaac_ros_nvblox_tpu_torch.models.camera import Camera


@torch.no_grad()
def back_project_depth(depth, *, camera: Camera, max_depth_m: float = 1e6):
    """Depth image -> camera-frame points `f32[H*W, 3]` and a valid mask
    `bool[H*W]`. Invalid pixels (0, non-finite or beyond `max_depth_m`)
    give the origin, so that shapes stay static."""
    dev = depth.device
    vv, uu = torch.meshgrid(
        torch.arange(camera.height, dtype=torch.float32, device=dev),
        torch.arange(camera.width, dtype=torch.float32, device=dev),
        indexing="ij")
    valid = (depth > 0.0) & torch.isfinite(depth) & (depth <= max_depth_m)
    z = torch.where(valid, depth, torch.zeros_like(depth))
    return camera.unproject(uu, vv, z).reshape(-1, 3), valid.reshape(-1)


def transform_pointcloud(points, T_A_B) -> torch.Tensor:
    """Points from frame B to frame A."""
    return Transform.apply(T_A_B, points)
