"""TSDF and occupancy decay (port of isaac_ros_nvblox_tpu/ops/decay.py).

Decay is an elementwise pass over the whole pool (unallocated rows hold
zeros, on which it is a no-op): TSDF weights shrink by a factor, except
voxels inside the last camera view; occupancy log-odds move toward a target
without overshooting it. Each also returns a per-block metric from which
the mapper frees fully decayed blocks (mapper/device_mapper.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (Transform,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class TsdfDecayParams:
    """The reference's tsdf_decay_* parameters."""
    decay_factor: float = 0.95
    decayed_weight_threshold: float = 1e-3
    set_free_distance_on_decayed: bool = False
    free_distance_vox: float = 4.0
    exclude_last_view: bool = True


@dataclasses.dataclass(frozen=True)
class OccupancyDecayParams:
    """The reference's occupancy_decay_* parameters."""
    free_region_decay_probability: float = 0.55   # pulls free voxels up
    occupied_region_decay_probability: float = 0.4  # pulls occupied down
    to_free: bool = False  # decay toward the free-region probability


@torch.no_grad()
def decay_tsdf(distance, weight, block_indices_all, T_L_C, *,
               params: TsdfDecayParams, voxel_size_m: float,
               camera: Optional[Camera] = None,
               view_distance_m: float = 7.0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decay all TSDF weights; returns new (distance, weight,
    block_max_weight f32[cap]).

    With `camera` (and `params.exclude_last_view`), voxels in the camera's
    view at T_L_C (in front, projecting into the image, within
    `view_distance_m`) keep their weight. Weights that fall below the
    threshold become 0 (and, with `set_free_distance_on_decayed`, their
    distance the free distance).
    """
    w = weight * _f32(params.decay_factor)
    if camera is not None and params.exclude_last_view:
        centers = voxel_centers_for_blocks(block_indices_all, voxel_size_m)
        p_C = Transform.apply(Transform.inverse(T_L_C), centers)
        _, in_view = camera.project(p_C)
        in_view = in_view & (p_C[..., 2] <= _f32(view_distance_m))
        w = torch.where(in_view, weight, w)
    decayed = w < _f32(params.decayed_weight_threshold)
    if params.set_free_distance_on_decayed:
        distance = torch.where(
            decayed & (weight > 0),
            torch.full_like(distance,
                            _f32(params.free_distance_vox * voxel_size_m)),
            distance)
    w = torch.where(decayed, torch.zeros_like(w), w)
    return distance, w, torch.amax(w, dim=1)


def occupancy_decay_constants(params: OccupancyDecayParams
                              ) -> Tuple[float, float, float]:
    """float32 (occupied step, free step, target) log-odds."""
    p_occ = params.occupied_region_decay_probability
    p_free = params.free_region_decay_probability
    l_free = math.log(p_free / (1 - p_free))
    return (_f32(math.log((1 - p_occ) / p_occ)), _f32(l_free),
            _f32(l_free if params.to_free else 0.0))


@torch.no_grad()
def decay_occupancy(log_odds, *, params: OccupancyDecayParams
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move every log-odds toward the target (0, the unknown prior, or the
    free-region log-odds with `to_free`) without overshooting: occupied
    voxels by the occupied step, free ones by the free step. Returns new
    (log_odds, block_max_distance_from_target f32[cap])."""
    occ_step, free_step, target = occupancy_decay_constants(params)
    down = torch.clamp_min(log_odds - occ_step, target)
    up = torch.clamp_max(log_odds + free_step, target)
    out = torch.where(log_odds > target, down,
                      torch.where(log_odds < target, up, log_odds))
    return out, torch.amax(torch.abs(out - target), dim=1)


def deallocate_fully_decayed_blocks(pool, table, block_metric: np.ndarray,
                                    threshold: float) -> int:
    """Free the host-table blocks (`core/block_pool.py`) whose per-block
    metric (host f32[cap]) fell below `threshold`; their rows return to
    their fill values. Returns the count."""
    slots = table.allocated_slots()
    dead = slots[block_metric[slots] < threshold]
    if dead.size == 0:
        return 0
    keys = [tuple(k) for k in table.block_indices[dead].tolist()]
    table.free(keys)
    pool.reset_slots(dead)
    return int(dead.size)
