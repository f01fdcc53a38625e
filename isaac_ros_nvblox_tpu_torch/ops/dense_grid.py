"""Dense grids of sparse layers (port of the tensor parts of
isaac_ros_nvblox_tpu/ops/dense_grid.py).

Reference: `voxelLayerToDenseVoxelGridInAABBAsync` + `Unified3DGrid<float>`
(esdf_and_gradients_conversions.cu:96-100), which power the
EsdfAndGradients service of motion planners. `gather_dense` reads a pool
channel at per-cell (slot, voxel) indices; `central_gradients` takes
central differences of a dense grid. `mapper/device_io.py` builds the
indices on the device from the slot grid.
"""

from __future__ import annotations

import numpy as np
import torch


def gather_dense(channel, slot, voxel_linear, fill) -> torch.Tensor:
    """channel `[cap, 512]` -> dense `[X, Y, Z]`: the voxel `voxel_linear`
    of slot `slot` per cell, `fill` where slot < 0."""
    cap = channel.shape[0]
    vals = channel[slot.clamp(0, cap - 1).reshape(-1).long(),
                   voxel_linear.reshape(-1).long()].reshape(slot.shape)
    return torch.where(slot >= 0, vals,
                       torch.as_tensor(fill, dtype=vals.dtype,
                                       device=vals.device))


def central_gradients(grid, voxel_size_m: float) -> torch.Tensor:
    """Central-difference gradients `f32[X, Y, Z, 3]` of a dense grid, with
    one-sided differences at the two faces of each axis."""
    vs = float(np.float32(voxel_size_m))

    def diff(axis):
        n = grid.shape[axis]
        fwd = torch.cat([grid.narrow(axis, 1, n - 1),
                         grid.narrow(axis, n - 1, 1)], axis)
        bwd = torch.cat([grid.narrow(axis, 0, 1),
                         grid.narrow(axis, 0, n - 1)], axis)
        # Spacing: 2 voxels inside, 1 at the two faces.
        idx = torch.arange(n, device=grid.device)
        spacing = torch.where((idx == 0) | (idx == n - 1), 1.0, 2.0)
        shape = [1, 1, 1]
        shape[axis] = n
        return (fwd - bwd) / (spacing.reshape(shape) * vs)

    return torch.stack([diff(0), diff(1), diff(2)], dim=-1)
