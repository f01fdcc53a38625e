"""Projective occupancy integrator, log-odds fusion (port of
isaac_ros_nvblox_tpu/ops/occupancy.py).

`integrate_occupancy` is the plain PyTorch version of the occupancy fusion
kernel (`ops/occupancy_cuda.py`, `csrc/occupancy_fuse.cu`). Per voxel of a
batch of pool rows, against the depth sample at its projection:

  z < d - half_width      -> free          (log-odds += l_free)
  |z - d| <= half_width   -> occupied      (log-odds += l_occupied)
  z > d + half_width      -> unobserved    (no update)

with log-odds clamped to bounds and the `u8` observed flag raised where a
voxel updates. The projection and sampling are the TSDF integrator's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (Transform, set_rows_drop,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.models.camera import (Camera,
                                                      sample_image_nearest)


def _log_odds(p: float) -> float:
    return math.log(p / (1.0 - p))


@dataclasses.dataclass(frozen=True)
class OccupancyIntegratorParams:
    """The reference's occupancy_integrator_* parameters."""
    free_region_occupancy_probability: float = 0.3
    occupied_region_occupancy_probability: float = 0.7
    unobserved_region_occupancy_probability: float = 0.5
    occupied_region_half_width_m: float = 0.1
    max_integration_distance_m: float = 7.0
    min_log_odds: float = -10.0
    max_log_odds: float = 10.0

    def fusion_constants(self) -> Tuple[float, float, float, float, float]:
        """float32 (half width, l_free, l_occupied, min, max log-odds)."""
        return tuple(float(np.float32(c)) for c in (
            self.occupied_region_half_width_m,
            _log_odds(self.free_region_occupancy_probability),
            _log_odds(self.occupied_region_occupancy_probability),
            self.min_log_odds, self.max_log_odds))


@torch.no_grad()
def integrate_occupancy(log_odds, observed, slots, block_indices, depth,
                        T_L_C, *, camera: Camera, voxel_size_m: float,
                        params: OccupancyIntegratorParams
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one depth frame into the occupancy pool, in place.

    log_odds `f32[cap, 512]`, observed `u8[cap, 512]`; slots `i32[N]`
    (entries outside [0, cap) are padding and leave the pool untouched),
    block_indices `i32[N, 3]`, depth `f32[H, W]`, T_L_C `f32[4, 4]`.
    Returns (log_odds, observed), the same tensors.
    """
    cap = log_odds.shape[0]
    hw, l_free, l_occ, lo_min, lo_max = params.fusion_constants()
    centers_L = voxel_centers_for_blocks(block_indices, voxel_size_m)
    p_C = Transform.apply(Transform.inverse(T_L_C), centers_L)
    uv, in_view = camera.project(p_C)
    z = p_C[..., 2]

    measured = sample_image_nearest(depth, uv)
    depth_valid = (measured > 0.0) & torch.isfinite(measured)
    in_range = z <= float(np.float32(params.max_integration_distance_m))
    is_free = z < measured - hw
    is_occ = torch.abs(z - measured) <= hw

    update = in_view & depth_valid & in_range & (is_free | is_occ)
    delta = torch.where(is_occ, torch.full_like(z, l_occ),
                        torch.full_like(z, l_free))
    delta = torch.where(update, delta, torch.zeros_like(delta))

    safe = slots.clamp(0, cap - 1).long()
    lo_new = torch.clamp(log_odds[safe] + delta, lo_min, lo_max)
    obs_new = torch.maximum(observed[safe], update.to(observed.dtype))
    set_rows_drop(log_odds, slots, lo_new)
    set_rows_drop(observed, slots, obs_new)
    return log_odds, observed


def occupancy_scalars(camera: Camera, voxel_size_m: float,
                      params: OccupancyIntegratorParams) -> np.ndarray:
    """The float32 constants the occupancy kernel takes: the TSDF kernel's
    camera block (`ops/tsdf.py::tsdf_scalars` layout, unused entries 0)
    followed by the fusion constants."""
    return np.asarray(
        [camera.fx, camera.fy, camera.cx, camera.cy, camera.width - 1.0,
         camera.height - 1.0, voxel_size_m, 0.0,
         params.max_integration_distance_m, 0.0, 0.0, 0.0,
         *params.fusion_constants()], np.float32)
