"""Halo gathering: padded per-block neighbourhoods from the pool
(port of isaac_ros_nvblox_tpu/ops/halo.py::gather_halo).

Whole neighbour blocks are gathered by slot, then the faces, edges and
corners the halo needs are sliced and concatenated along each axis.
"""

from __future__ import annotations

import torch

from isaac_ros_nvblox_tpu_torch.core.types import VOXELS_PER_SIDE

B = VOXELS_PER_SIDE


def gather_halo(grid_channel, neighbor_slots, *, lo: int = 1, hi: int = 1,
                fill=0.0) -> torch.Tensor:
    """Padded neighbourhoods `[N, B+lo+hi, B+lo+hi, B+lo+hi, ...]`.

    Args:
      grid_channel: pool channel as a grid view `[cap, 8, 8, 8, ...]`.
      neighbor_slots: `i32[N, 27]` neighbour slot rows (order of
        core/world_grid.NEIGHBOR_OFFSETS; -1 = absent). Entry 13 is the
        block itself.
      lo, hi: halo width on the negative / positive side (0 or 1).
      fill: value for absent neighbours.
    """
    cap = grid_channel.shape[0]
    trailing = grid_channel.shape[4:]
    N = neighbor_slots.shape[0]

    def blocks_of(col):
        ns = neighbor_slots[:, col]
        data = grid_channel[ns.clamp(0, cap - 1).long()]
        mask = (ns >= 0).reshape((N, 1, 1, 1) + (1,) * len(trailing))
        return torch.where(mask, data, torch.full((), fill,
                                                  dtype=data.dtype,
                                                  device=data.device))

    def src(d):
        if d == -1:
            return slice(B - lo, B)
        if d == 0:
            return slice(0, B)
        return slice(0, hi)

    ds = ([-1] if lo else []) + [0] + ([1] if hi else [])
    x_slabs = []
    for dx in ds:
        y_slabs = []
        for dy in ds:
            z_parts = [blocks_of((dx + 1) * 9 + (dy + 1) * 3 + (dz + 1))
                       [:, src(dx), src(dy), src(dz)] for dz in ds]
            y_slabs.append(torch.cat(z_parts, dim=3))
        x_slabs.append(torch.cat(y_slabs, dim=2))
    return torch.cat(x_slabs, dim=1)
