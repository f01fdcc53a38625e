"""Freespace integrator: temporal high-confidence freespace (port of
isaac_ros_nvblox_tpu/ops/freespace.py).

A voxel that has been free for long enough becomes high-confidence
freespace; a depth point that later lands inside such a voxel is dynamic
(ops/detect.py). Per voxel (nvblox's FreespaceVoxel):

  consecutive_occupancy_duration_ms: how long the voxel has been occupied
    without a break; reset when it is observed free.
  last_occupied_time_ms: when it was last occupied (the unobserved grace
    period `max_unobserved_to_keep_consecutive_occupancy_ms` reads it).
  is_high_confidence_freespace: set once the voxel has been free for
    `min_duration_since_occupied_for_freespace_ms`; reset after
    `min_consecutive_occupancy_duration_for_reset_ms` of occupancy.

A voxel is occupied when its TSDF distance is below
`max_tsdf_distance_for_occupancy_m` and it is observed this frame. Both
forms below are element-wise torch code; neither needs a kernel. Times are
float32 tensors (0-dim, on the channels' device) or Python floats.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from isaac_ros_nvblox_tpu_torch.core.types import (Transform, set_rows_drop,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera


@dataclasses.dataclass(frozen=True)
class FreespaceIntegratorParams:
    """nvblox's freespace_integrator_* parameters."""
    max_tsdf_distance_for_occupancy_m: float = 0.15
    max_unobserved_to_keep_consecutive_occupancy_ms: float = 250.0
    min_duration_since_occupied_for_freespace_ms: float = 1000.0
    min_consecutive_occupancy_duration_for_reset_ms: float = 2000.0
    check_neighborhood: bool = True
    initialize_to_high_confidence_freespace: bool = False


def _step(cons, last_occ, hc, d, w, in_view, time_ms, last_update_ms,
          params: FreespaceIntegratorParams):
    """The per-voxel state machine: (observed, keep_streak, cons_new,
    last_occ_new, demote, hc_new)."""
    dt_ms = time_ms - last_update_ms
    observed = in_view & (w > 1e-6)
    occupied_now = observed & (d < params.max_tsdf_distance_for_occupancy_m)
    # Unobserved grace: keep accumulating occupancy while briefly unobserved.
    recently_occupied = ((time_ms - last_occ)
                         <= params.max_unobserved_to_keep_consecutive_occupancy_ms)
    keep_streak = occupied_now | (~observed & recently_occupied & (cons > 0))
    cons_new = torch.where(keep_streak, cons + dt_ms, torch.zeros_like(cons))
    last_occ_new = torch.where(occupied_now, time_ms, last_occ)
    # Promote after a long free duration; demote after a long occupancy.
    promote = observed & ~occupied_now & (
        (time_ms - last_occ_new)
        >= params.min_duration_since_occupied_for_freespace_ms)
    demote = cons_new >= params.min_consecutive_occupancy_duration_for_reset_ms
    hc_new = ~demote & (hc | promote)
    return observed, keep_streak, cons_new, last_occ_new, demote, hc_new


@torch.no_grad()
def update_freespace(consecutive_ms, last_occupied_ms, high_confidence,
                     tsdf_distance, tsdf_weight, slots, block_indices, T_L_C,
                     time_ms, last_update_ms, *, camera: Camera,
                     voxel_size_m: float, params: FreespaceIntegratorParams,
                     distance_rows=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One freespace update over a view batch at `time_ms`, in place.

    consecutive_ms, last_occupied_ms f32[cap, 512], high_confidence
    bool[cap, 512]; slots i32[N] (entries outside [0, cap) are padding),
    block_indices i32[N, 3]. `distance_rows` (f32[N, 512], optional) are
    the batch's effective distances (the neighbourhood-dilated values of
    the mapper's fallback form). Returns the three channels.
    """
    cap = tsdf_distance.shape[0]
    rows = slots.clamp(0, cap - 1).long()
    p_C = Transform.apply(Transform.inverse(T_L_C),
                          voxel_centers_for_blocks(block_indices,
                                                   voxel_size_m))
    _, in_view = camera.project(p_C)
    d = tsdf_distance[rows] if distance_rows is None else distance_rows
    cons = consecutive_ms[rows]
    observed, keep, cons_new, last_new, _, hc_new = _step(
        cons, last_occupied_ms[rows], high_confidence[rows], d,
        tsdf_weight[rows], in_view, time_ms, last_update_ms, params)
    set_rows_drop(consecutive_ms, slots,
                  torch.where(observed | keep, cons_new, cons))
    set_rows_drop(last_occupied_ms, slots, last_new)
    set_rows_drop(high_confidence, slots, hc_new)
    return consecutive_ms, last_occupied_ms, high_confidence


@torch.no_grad()
def update_freespace_fullpool(consecutive_ms, last_occupied_ms,
                              high_confidence, eff_distance, tsdf_weight,
                              in_view, time_ms, last_update_ms, *,
                              params: FreespaceIntegratorParams
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The same state machine over whole pool rows with a per-voxel
    `in_view` mask (no gathers or scatters), in place. All arguments are
    `[n, 512]` rows (a pool or a pool prefix). Returns the three rows."""
    observed, keep, cons_new, last_new, demote, hc_new = _step(
        consecutive_ms, last_occupied_ms, high_confidence, eff_distance,
        tsdf_weight, in_view, time_ms, last_update_ms, params)
    consecutive_ms.copy_(torch.where(observed | keep, cons_new,
                                     consecutive_ms))
    last_occupied_ms.copy_(last_new)
    high_confidence.copy_(torch.where(observed | demote, hc_new,
                                      high_confidence))
    return consecutive_ms, last_occupied_ms, high_confidence
