"""Dense grids of sparse layers (port of
isaac_ros_nvblox_tpu/ops/dense_grid.py).

Reference: `voxelLayerToDenseVoxelGridInAABBAsync` + `Unified3DGrid<float>`
(esdf_and_gradients_conversions.cu:96-100), which power the
EsdfAndGradients service of motion planners. `gather_dense` reads a pool
channel at per-cell (slot, voxel) indices; `central_gradients` takes
central differences of a dense grid. `mapper/device_io.py` builds the
indices on the device from the slot grid; for the host-table `Mapper`,
`dense_voxel_lookup` builds them on the host from its BlockTable.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import VOXELS_PER_SIDE, sqrt32

B = VOXELS_PER_SIDE


def dense_voxel_lookup(table, aabb_min_m, aabb_max_m, voxel_size_m: float
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host (slot i32[X, Y, Z], voxel_linear i32[X, Y, Z], origin_m
    f64[3]) of a BlockTable: grid cells are voxel centres from the voxel
    holding aabb_min; slot -1 where no block is allocated."""
    g0 = np.floor(np.asarray(aabb_min_m, np.float64)
                  / voxel_size_m).astype(np.int64)
    g1 = np.floor(np.asarray(aabb_max_m, np.float64)
                  / voxel_size_m).astype(np.int64)
    dims = (g1 - g0 + 1).astype(int)
    bx, lx = np.divmod(g0[0] + np.arange(dims[0]), B)
    by, ly = np.divmod(g0[1] + np.arange(dims[1]), B)
    bz, lz = np.divmod(g0[2] + np.arange(dims[2]), B)
    # Unique blocks along each axis -> few dict lookups.
    ubx, ix = np.unique(bx, return_inverse=True)
    uby, iy = np.unique(by, return_inverse=True)
    ubz, iz = np.unique(bz, return_inverse=True)
    slot_cube = np.full((ubx.size, uby.size, ubz.size), -1, np.int32)
    for a, bxa in enumerate(ubx.tolist()):
        for b, byb in enumerate(uby.tolist()):
            for c, bzc in enumerate(ubz.tolist()):
                slot_cube[a, b, c] = table.slot_of((bxa, byb, bzc))
    slot = slot_cube[np.ix_(ix, iy, iz)]
    voxel_linear = ((lx[:, None, None] * B + ly[None, :, None]) * B
                    + lz[None, None, :]).astype(np.int32)
    origin_m = (g0.astype(np.float64) + 0.5) * voxel_size_m
    return slot, np.broadcast_to(voxel_linear, slot.shape).copy(), origin_m


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


@torch.no_grad()
def esdf_and_gradients(mapper, aabb_min_m, aabb_max_m):
    """The EsdfAndGradients service response of a host-table `Mapper`
    (EsdfAndGradientsConverter::getEsdfAndGradientResponse,
    esdf_and_gradients_conversions.cu:50-86): the signed ESDF over the
    AABB (INF outside allocated blocks, clamped at the maximum distance)
    and its central-difference gradients."""
    from isaac_ros_nvblox_tpu_torch.ops.esdf import INF_SQ
    from isaac_ros_nvblox_tpu_torch.runtime.msgs import (
        EsdfAndGradientsResponse)
    vs = mapper.voxel_size_m
    dev = mapper.pool.device
    slot, voxel_linear, origin = dense_voxel_lookup(
        mapper.table, aabb_min_m, aabb_max_m, vs)
    slot_d = torch.as_tensor(slot, device=dev)
    lin_d = torch.as_tensor(voxel_linear, device=dev)
    sq = gather_dense(mapper.pool["esdf_sq_dist"], slot_d, lin_d,
                      float(np.float32(INF_SQ)))
    inside = gather_dense(mapper.pool["esdf_is_inside"].float(), slot_d,
                          lin_d, 0.0)
    dist = torch.clamp_max(
        sqrt32(torch.clamp_max(sq, INF_SQ)) * float(np.float32(vs)),
        float(np.float32(mapper.params.esdf.max_esdf_distance_m)))
    dist = torch.where(inside > 0.5, -dist, dist)
    grads = central_gradients(dist, vs)
    return EsdfAndGradientsResponse(
        success=True, origin_m=tuple(origin), voxel_size_m=vs,
        esdf=dist.cpu().numpy(), gradients=grads.cpu().numpy())
