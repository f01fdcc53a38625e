"""DeviceMapper: the device-resident depth / lidar -> TSDF or occupancy
(+ color) -> ESDF / mesh path (port of
isaac_ros_nvblox_tpu/mapper/device_mapper.py: the TSDF and occupancy
layers with color, mesh, ESDF, lidar, decay, clearing and freespace).

    integrate_depth:  touched-grid -> allocate -> view batch -> TSDF fusion
                      (kernel tsdf_fuse) or, on an occupancy mapper,
                      log-odds fusion (kernel occupancy_fuse) -> dirty bits;
                      no host sync
    integrate_pointcloud:
                      (motion compensation) -> range image -> lidar grid ->
                      allocate -> spherical TSDF fusion (kernel
                      tsdf_lidar_fuse) -> dirty bits; no host sync
    integrate_color:  color-frustum view batch (no allocation) -> color
                      fusion (kernel color_fuse) -> mesh-dirty bits
    decay:            TSDF weight or occupancy log-odds decay, then the
                      fully decayed blocks are freed (slots recycled through
                      the free stack, freed blocks logged in a device ring)
    clear_outside_radius / clear_tsdf_inside_shapes:
                      free the blocks outside a radius / unobserve the TSDF
                      voxels inside spheres and boxes
    update_esdf:      exact banded separable EDT (kernels edt_pass1,
                      edt_pass) over the allocated AABB, or over the dirty
                      AABB + band, spliced into the ESDF channels; sites
                      from the TSDF or from occupied voxels
    update_esdf_2d:   the 2-D ESDF of a height band: band sites collapsed
                      per (x, y) column, two planar EDT passes (kernels
                      edt_pass1, edt_pass) over the allocated xy extent
    integrate_depth_with_esdf2d:
                      the online tick: integrate_depth, then the 2-D
                      solve; no host sync
    update_mesh_dirty_device:
                      dirty blocks + their -1-side neighbours -> surface
                      crossing subset -> marching cubes (kernel
                      marching_cubes) -> slot-indexed soup
    export_mesh:      full-map marching cubes -> welded host mesh
    update_freespace: the freespace state machine over the view (TSDF
                      mappers built with enable_freespace): full pool with
                      a per-voxel frustum test and the dense 3^3 occupancy
                      dilation (kernel dilate_dense) when the block region
                      is known, else the view batch with a halo dilation
    replay_frames:    the offline loop over N frames: TSDF every frame, TSDF
                      + color in one pass (kernel tsdf_color_fuse) every
                      `color_every`, ESDF every `esdf_every` and mesh every
                      `mesh_every` frames

State lives on the mapper's device as tensors: the WorldGrid allocator and
the pool channels `f32/bool[cap, 512]`, which every step updates in place
(the reference donates the same buffers). The host tracks block AABBs from
the poses it is given, so the ESDF update needs no readback unless poses
arrive as device tensors.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import (VOXELS_PER_BLOCK,
                                                   VOXELS_PER_SIDE,
                                                   Transform, device_constant,
                                                   device_ints, fma,
                                                   resolve_device,
                                                   set_rows_drop, sqrt32,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.mapper.params import (MapperParams,
                                                      ProjectiveLayerType)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.lidar import (
    motion_compensate_pointcloud, pointcloud_to_range_image)
from isaac_ros_nvblox_tpu_torch.ops import decay as decay_ops
from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
from isaac_ros_nvblox_tpu_torch.ops import view as view_ops
from isaac_ros_nvblox_tpu_torch.ops.color_cuda import integrate_color_cuda
from isaac_ros_nvblox_tpu_torch.ops.esdf_dense import (collapse_2d_mask,
                                                     esdf_2d_from_sites,
                                                     esdf_from_sites_dense)
from isaac_ros_nvblox_tpu_torch.ops.freespace import (
    update_freespace, update_freespace_fullpool)
from isaac_ros_nvblox_tpu_torch.ops.halo import (dilate_occupancy_dense,
                                                 gather_halo_sliced)
from isaac_ros_nvblox_tpu_torch.ops.lidar_cuda import integrate_tsdf_lidar_cuda
from isaac_ros_nvblox_tpu_torch.ops.occupancy_cuda import (
    integrate_occupancy_cuda)
from isaac_ros_nvblox_tpu_torch.ops.mesh import (MeshLayer,
                                                 marching_cubes_blocks)
from isaac_ros_nvblox_tpu_torch.ops.mesh_cuda import (marching_cubes_fused,
                                                      resolve_edge_soup,
                                                      surface_crossing)
from isaac_ros_nvblox_tpu_torch.ops.tsdf_color_cuda import (
    integrate_tsdf_color_cuda)
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda

B = VOXELS_PER_SIDE
COLOR_CHANNELS = ("color_r", "color_g", "color_b", "color_weight")
_BIG = 2 ** 30

def _bucket(n: int, minimum: int = 256) -> int:
    """Batch bucket size: powers of two up to 2048, then 1024-steps."""
    if n <= 2048:
        b = minimum
        while b < n:
            b *= 2
        return b
    return ((n + 1023) // 1024) * 1024


def _bucket_blocks(n: int, mult: int = 8) -> int:
    """Round a region extent (blocks) up to a multiple of `mult`."""
    return max(((n + mult - 1) // mult) * mult, mult)


_COARSE_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def _bucket_blocks_coarse(n: int) -> int:
    """Coarse region-extent bucket of the incremental ESDF update."""
    for b in _COARSE_BUCKETS:
        if n <= b:
            return b
    return _bucket_blocks(n, 64)


def _masked_depth(depth, mask, mask_mode: int):
    """mask_mode 1 keeps the unmasked pixels (background), 2 the masked
    ones (foreground), 0 all."""
    if mask_mode == 1:
        return torch.where(mask > 0, torch.zeros_like(depth), depth)
    if mask_mode == 2:
        return torch.where(mask > 0, depth, torch.zeros_like(depth))
    return depth


def _allocate_view(state, grid_origin, *, voxel_size_m: float,
                   max_blocks: int, view_params=None):
    """A touched-block grid (grid, origin) -> workspace bounds -> allocate
    and batch: (state, slots, block indices)."""
    grid, origin = grid_origin
    if view_params is not None:
        grid = view_ops.apply_workspace_bounds_to_grid(
            grid, origin, voxel_size_m=voxel_size_m, params=view_params)
    state, slots, bidx, _ = wg.allocate_and_batch(
        state, grid, origin, max_blocks=max_blocks)
    return state, slots, bidx


@torch.no_grad()
def _integrate_frame(state, distance, weight, dirty, esdf_dirty, depth,
                     T_L_C, mask=None, *, camera: Camera, voxel_size_m: float,
                     params, max_blocks: int, mask_mode: int = 0,
                     view_params=None, color=None):
    """view grid -> allocate -> view batch -> TSDF fuse -> dirty bits.

    Updates the pool channels and dirty flags in place and returns the new
    allocator state. mask_mode: 0 = no mask, 1 = integrate unmasked pixels
    (background), 2 = integrate masked pixels (foreground). `color` =
    (aligned color image, (r, g, b, weight) channels) fuses the color frame
    on the same batch in the same pass (kernel tsdf_color_fuse); the
    reference's color integrator takes its blocks from the depth frame the
    same way (nvblox_node.cpp:1260-1265).
    """
    depth = _masked_depth(depth, mask, mask_mode)
    state, slots, bidx = _allocate_view(
        state, view_ops.touched_block_grid(
            depth, T_L_C, camera=camera, voxel_size_m=voxel_size_m,
            max_distance_m=params.max_integration_distance_m,
            truncation_m=params.truncation_m(voxel_size_m)),
        voxel_size_m=voxel_size_m, max_blocks=max_blocks,
        view_params=view_params)
    if color is None:
        integrate_tsdf_cuda(distance, weight, slots, bidx, depth, T_L_C,
                            camera=camera, voxel_size_m=voxel_size_m,
                            params=params)
    else:
        image, chans = color
        integrate_tsdf_color_cuda(distance, weight, *chans, slots, bidx,
                                  depth, image, T_L_C, camera=camera,
                                  voxel_size_m=voxel_size_m, params=params)
    set_rows_drop(dirty, slots, True)
    set_rows_drop(esdf_dirty, slots, True)
    return state


@torch.no_grad()
def _integrate_color_frame(chans, dirty, tsdf_distance, tsdf_weight, state,
                           color_image, depth, T_L_C, *, camera: Camera,
                           voxel_size_m: float, params, max_blocks: int):
    """color view batch -> color fusion (kernel color_fuse) -> mesh-dirty.

    The batch is the allocated blocks in the color frustum (no
    allocation): a max-distance pseudo-depth covers the whole view."""
    grid, origin = view_ops.touched_block_grid(
        torch.full((camera.height, camera.width),
                   params.max_integration_distance_m, device=dirty.device),
        T_L_C, camera=camera, voxel_size_m=voxel_size_m,
        max_distance_m=params.max_integration_distance_m,
        truncation_m=params.truncation_m(voxel_size_m))
    slots, bidx, _ = wg.view_batch(state, grid, origin,
                                   max_blocks=max_blocks)
    integrate_color_cuda(*chans, tsdf_distance, tsdf_weight, slots, bidx,
                         color_image, depth, T_L_C, camera=camera,
                         voxel_size_m=voxel_size_m, params=params)
    set_rows_drop(dirty, slots, True)


@torch.no_grad()
def _integrate_occupancy_frame(state, log_odds, observed, dirty, esdf_dirty,
                               depth, T_L_C, mask=None, *, camera: Camera,
                               voxel_size_m: float, params, max_blocks: int,
                               mask_mode: int = 0, view_params=None):
    """`_integrate_frame` for the occupancy layer (kernel occupancy_fuse).
    The view grid takes the occupancy params' max distance, with the
    occupied half width as its truncation band."""
    depth = _masked_depth(depth, mask, mask_mode)
    state, slots, bidx = _allocate_view(
        state, view_ops.touched_block_grid(
            depth, T_L_C, camera=camera, voxel_size_m=voxel_size_m,
            max_distance_m=float(params.max_integration_distance_m),
            truncation_m=float(params.occupied_region_half_width_m)),
        voxel_size_m=voxel_size_m, max_blocks=max_blocks,
        view_params=view_params)
    integrate_occupancy_cuda(log_odds, observed, slots, bidx, depth, T_L_C,
                             camera=camera, voxel_size_m=voxel_size_m,
                             params=params)
    set_rows_drop(dirty, slots, True)
    set_rows_drop(esdf_dirty, slots, True)
    return state


@torch.no_grad()
def _integrate_lidar_frame(state, distance, weight, dirty, esdf_dirty,
                           range_image, T_L_S, *, lidar, voxel_size_m: float,
                           params, max_blocks: int, view_params=None):
    """lidar grid -> allocate -> view batch -> spherical TSDF fusion
    (kernel tsdf_lidar_fuse) -> dirty bits. The workspace bounds apply as
    on the camera path."""
    state, slots, bidx = _allocate_view(
        state, view_ops.touched_block_grid_lidar(
            range_image, T_L_S, lidar=lidar, voxel_size_m=voxel_size_m,
            max_distance_m=params.max_integration_distance_m,
            truncation_m=params.truncation_m(voxel_size_m)),
        voxel_size_m=voxel_size_m, max_blocks=max_blocks,
        view_params=view_params)
    integrate_tsdf_lidar_cuda(distance, weight, slots, bidx, range_image,
                              T_L_S, lidar=lidar, voxel_size_m=voxel_size_m,
                              params=params)
    set_rows_drop(dirty, slots, True)
    set_rows_drop(esdf_dirty, slots, True)
    return state


# Per-channel values of freed or cleared rows (recycled slots start in each
# channel's initial state); every other channel resets to 0.
_CHANNEL_RESET = {"esdf_sq_dist": float(esdf_ops.INF_SQ),
                  "freespace_last_occupied_ms": -1e9}


def _reset_rows(channels: Dict[str, torch.Tensor], slots,
                reset_extra=()) -> None:
    """Reset the rows `slots` of every channel to its initial value, in
    place; slots outside [0, cap) are dropped. reset_extra: ((name, value),
    ...) overrides."""
    resets = dict(_CHANNEL_RESET)
    resets.update(dict(reset_extra))
    for name, ch in channels.items():
        set_rows_drop(ch, slots, resets.get(name, 0))


@torch.no_grad()
def _free_mask(state, channels, dirty, esdf_dirty, removed, dead, *,
               max_free: int, reset_extra=()):
    """Free the (at most `max_free`, lowest) slots where `dead` (bool[cap])
    and reset their channels and dirty bits, in place.

    `removed` = (log i32[K, 3], count i32[]): a device ring of freed block
    indices, written at (count + i) % K, so that publishers learn of
    removed blocks without a host sync per free. The log is updated in
    place. Returns (state, new count)."""
    cap = dead.shape[0]
    log, count = removed
    K = log.shape[0]
    keys = _first_ids(dead, max_free)
    ok = keys < _BIG
    idx = torch.where(ok, keys, cap)
    freed_bidx = state.block_index_of_slot[idx.clamp(0, cap - 1).long()]
    order = torch.cumsum(ok, 0, dtype=torch.int32) - 1
    n_ok = ok.sum(dtype=torch.int32)
    # Where one call frees more than K blocks, the newest K keep the ring.
    newest = ok & (order >= n_ok - K)
    set_rows_drop(log, torch.where(newest, torch.remainder(count + order, K),
                                   K), freed_bidx)
    count = count + n_ok
    state = wg.free_slots(state, torch.where(ok, idx, -1))
    _reset_rows(channels, idx, reset_extra)
    set_rows_drop(dirty, idx, False)
    set_rows_drop(esdf_dirty, idx, False)
    return state, count


def _block_centers(state, voxel_size_m: float) -> torch.Tensor:
    """World block centers `f32[cap, 3]` of every slot's block index."""
    bs = float(np.float32(voxel_size_m * B))
    return (state.block_index_of_slot.float() + 0.5) * bs


@torch.no_grad()
def _decay_tsdf_fused(state, channels, dirty, esdf_dirty, removed, T_L_C, *,
                      camera, voxel_size_m: float, params, max_free: int,
                      has_view: bool, reset_extra=(),
                      view_distance_m: float = 7.0):
    """TSDF weight decay, then the blocks whose weights all decayed away
    are freed; with a last view (`has_view`), its voxels keep their weight
    and blocks whose centers it sees are never freed."""
    d, w, block_max_w = decay_ops.decay_tsdf(
        channels["tsdf_distance"], channels["tsdf_weight"],
        state.block_index_of_slot, T_L_C, params=params,
        voxel_size_m=voxel_size_m,
        camera=camera if has_view and params.exclude_last_view else None,
        view_distance_m=view_distance_m)
    channels["tsdf_distance"].copy_(d)
    channels["tsdf_weight"].copy_(w)
    dead = wg.live_slot_mask(state) & (
        block_max_w < float(np.float32(params.decayed_weight_threshold)))
    if has_view:
        p_C = Transform.apply(Transform.inverse(T_L_C),
                              _block_centers(state, voxel_size_m))
        _, in_view = camera.project(p_C[:, None, :])
        dead = dead & ~in_view[:, 0]
    return _free_mask(state, channels, dirty, esdf_dirty, removed, dead,
                      max_free=max_free, reset_extra=reset_extra)


@torch.no_grad()
def _decay_occupancy_fused(state, channels, dirty, esdf_dirty, removed, *,
                           params, max_free: int, dealloc_threshold: float,
                           reset_extra=()):
    """Occupancy log-odds decay toward the target, then the blocks whose
    log-odds all reached it are freed."""
    lo, block_max = decay_ops.decay_occupancy(channels["occupancy_log_odds"],
                                              params=params)
    channels["occupancy_log_odds"].copy_(lo)
    dead = wg.live_slot_mask(state) & (
        block_max < float(np.float32(dealloc_threshold)))
    return _free_mask(state, channels, dirty, esdf_dirty, removed, dead,
                      max_free=max_free, reset_extra=reset_extra)


def _fullpool_in_view(block_index_of_slot, T_L_C, *, camera: Camera,
                      voxel_size_m: float, view_distance_m: float):
    """bool[n, 512]: each voxel center of the slots' blocks lies in the
    camera's view within `view_distance_m`. The reference spells this
    transform out element by element, and XLA folds the voxel size into
    the rotation (R * vs) and fuses the first product into the sum; this
    follows that order."""
    dev = block_index_of_slot.device
    lane = torch.arange(VOXELS_PER_BLOCK, device=dev)
    bi = block_index_of_slot.float()
    X = [bi[:, a:a + 1] * 8.0 + l.float() + 0.5
         for a, l in enumerate((lane // 64, (lane // 8) % 8, lane % 8))]
    T_C_L = Transform.inverse(T_L_C)
    vs = float(np.float32(voxel_size_m))
    pc = []
    for i in range(3):
        Rv = [T_C_L[i, j] * vs for j in range(3)]
        pc.append(fma(Rv[2], X[2], fma(Rv[0], X[0], Rv[1] * X[1]))
                  + T_C_L[i, 3])
    z = pc[2]
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = camera.fx * pc[0] / zs + camera.cx
    v = camera.fy * pc[1] / zs + camera.cy
    return ((z > 1e-6) & (z <= view_distance_m)
            & (u >= 0.0) & (u <= camera.width - 1.0)
            & (v >= 0.0) & (v <= camera.height - 1.0))


@torch.no_grad()
def _freespace_fused(consecutive_ms, last_occupied_ms, high_confidence,
                     state, tsdf_distance, tsdf_weight, T_L_C, time_ms,
                     last_update_ms, origin_b=None, *, camera: Camera,
                     voxel_size_m: float, params, view_distance_m: float,
                     max_blocks: int, dims_b=None, slot_bucket: int = 0):
    """The freespace state machine with its 26-neighbourhood occupancy
    check, on the three channels in place. Two forms:

      * dims_b given (a block region covering the allocated AABB, at
        `origin_b` i32[3]): every pool row (or the prefix
        `[:slot_bucket]`, exact while allocation stays inside it;
        check_slot_bucket() verifies) with a per-voxel frustum test, and
        the neighbourhood check as the dense-region dilation
        `dilate_occupancy_dense` (kernel dilate_dense);
      * dims_b None (no region known yet): the view batch of a max-distance
        pseudo-depth frame, its halo by `gather_halo_sliced` and a
        separable slice-max.

    A voxel counts as occupied when any voxel of its 3^3 neighbourhood
    is; the state machine then sees it at a distance below the threshold
    (threshold - 1 m), a free one far (1000 m)."""
    cap = tsdf_distance.shape[0]
    dev = tsdf_distance.device
    thr = params.max_tsdf_distance_for_occupancy_m
    occ_far = (torch.full((), thr - 1.0, device=dev),
               torch.full((), 1e3, device=dev))
    if dims_b is not None:
        sb = min(slot_bucket, cap) if slot_bucket else cap
        bidx_b = state.block_index_of_slot[:sb]
        tsdf_b, w_b = tsdf_distance[:sb], tsdf_weight[:sb]
        in_view = _fullpool_in_view(
            bidx_b, T_L_C, camera=camera, voxel_size_m=voxel_size_m,
            view_distance_m=view_distance_m)
        in_view &= (torch.arange(sb, device=dev) < state.alloc_count)[:, None]
        if params.check_neighborhood:
            occ = ((tsdf_b < thr) & (w_b > 1e-6)).float()
            occ_d = dilate_occupancy_dense(
                occ, None, origin_b, dims_b=dims_b,
                block_index_of_slot=bidx_b, alloc_count=state.alloc_count)
            eff = torch.where(occ_d > 0.5, *occ_far)
        else:
            eff = tsdf_b
        update_freespace_fullpool(
            consecutive_ms[:sb], last_occupied_ms[:sb], high_confidence[:sb],
            eff, w_b, in_view, time_ms, last_update_ms, params=params)
        return consecutive_ms, last_occupied_ms, high_confidence

    pseudo = torch.full((camera.height, camera.width), view_distance_m,
                        device=dev)
    grid, origin = view_ops.touched_block_grid(
        pseudo, T_L_C, camera=camera, voxel_size_m=voxel_size_m,
        max_distance_m=view_distance_m, truncation_m=2 * voxel_size_m)
    slots, bidx, _ = wg.view_batch(state, grid, origin, max_blocks=max_blocks)
    d_rows = None
    if params.check_neighborhood:
        occ = ((tsdf_distance < thr) & (tsdf_weight > 1e-6)).float()
        pad = gather_halo_sliced(occ.reshape(cap, B, B, B),
                                 wg.neighbor_slots_of(state, bidx))
        t = torch.maximum(torch.maximum(pad[..., 0:8], pad[..., 1:9]),
                          pad[..., 2:10])
        t = torch.maximum(torch.maximum(t[:, :, 0:8], t[:, :, 1:9]),
                          t[:, :, 2:10])
        dil = torch.maximum(torch.maximum(t[:, 0:8], t[:, 1:9]), t[:, 2:10])
        d_rows = torch.where(dil.reshape(-1, VOXELS_PER_BLOCK) > 0.5,
                             *occ_far)
    return update_freespace(
        consecutive_ms, last_occupied_ms, high_confidence, tsdf_distance,
        tsdf_weight, slots, bidx, T_L_C, time_ms, last_update_ms,
        camera=camera, voxel_size_m=voxel_size_m, params=params,
        distance_rows=d_rows)


def _norm3_exact(v) -> torch.Tensor:
    """`core/types.py::norm3` with a correctly rounded root."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return sqrt32(fma(z, z, fma(y, y, x * x)))


@torch.no_grad()
def _clear_outside_radius_fused(state, channels, dirty, esdf_dirty, removed,
                                center_m, radius_m: float, *,
                                voxel_size_m: float, max_free: int,
                                reset_extra=()):
    """Free every live block whose center lies farther than `radius_m`
    from `center_m` (f32[3] on the device)."""
    dist = _norm3_exact(_block_centers(state, voxel_size_m) - center_m[None])
    dead = wg.live_slot_mask(state) & (dist > float(np.float32(radius_m)))
    return _free_mask(state, channels, dirty, esdf_dirty, removed, dead,
                      max_free=max_free, reset_extra=reset_extra)


@torch.no_grad()
def _clear_shapes_fused(state, distance, weight, dirty, esdf_dirty, spheres,
                        aabbs, *, voxel_size_m: float) -> None:
    """Unobserve (weight and distance 0) the TSDF voxels of live blocks
    inside spheres `f32[Ks, 4]` (center, radius; radius <= 0 inert) or
    boxes `f32[Ka, 6]` (lo, hi; empty boxes inert), and mark their blocks
    dirty; all in place."""
    centers = voxel_centers_for_blocks(state.block_index_of_slot,
                                       voxel_size_m)
    inside = torch.zeros(centers.shape[:2], dtype=torch.bool,
                         device=centers.device)
    for k in range(spheres.shape[0]):
        d = centers - spheres[k, :3]
        d2 = fma(d[..., 2], d[..., 2], fma(d[..., 1], d[..., 1],
                                           d[..., 0] * d[..., 0]))
        r = spheres[k, 3]
        inside |= (r > 0) & (d2 <= r * r)
    for k in range(aabbs.shape[0]):
        lo, hi = aabbs[k, :3], aabbs[k, 3:]
        inb = torch.all((centers >= lo) & (centers <= hi), dim=-1)
        inside |= torch.all(hi > lo) & inb
    inside &= wg.live_slot_mask(state)[:, None]
    cleared = torch.any(inside, dim=1)
    weight.masked_fill_(inside, 0.0)
    distance.masked_fill_(inside, 0.0)
    dirty |= cleared
    esdf_dirty |= cleared


def _mark(n: int, idx, keep) -> torch.Tensor:
    """bool[n], True at idx where keep (a drop-scatter without a sync)."""
    out = torch.zeros((n + 1,), dtype=torch.bool, device=idx.device)
    i = torch.where(keep, idx, n).long()
    # A tensor value: a Python scalar here is copied from the host.
    out.index_put_((i,), torch.ones_like(i, dtype=torch.bool))
    return out[:n]


def _smallest(keys, n_out: int) -> torch.Tensor:
    """The `n_out` smallest of `keys` in ascending order, _BIG-padded (a
    radix sort: on the card far cheaper than a top-k of this size)."""
    keys = torch.sort(keys).values[:n_out]
    if keys.shape[0] < n_out:
        keys = torch.cat([keys, torch.full((n_out - keys.shape[0],), _BIG,
                                           dtype=keys.dtype,
                                           device=keys.device)])
    return keys


def _first_ids(mask, n_out: int) -> torch.Tensor:
    """The first `n_out` indices where `mask` (ascending), _BIG-padded."""
    ids = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    return _smallest(torch.where(mask, ids, _BIG), n_out)


@torch.no_grad()
def _compact_dirty_impl(state, dirty, *, max_blocks: int, extra=None):
    """Dirty slots plus their -1-side neighbours as a static-size batch
    (slots i32[max_blocks], block indices i32[max_blocks, 3]); padding
    carries slot == capacity and block index 0.

    A cube re-meshes when any block of its positive octant changed, so each
    dirty cell contributes itself minus every {0,1}^3 offset; candidates
    outside the world grid drop (they do not wrap). `extra` (bool[cap])
    slots join without that expansion (the mesh path's pending backlog).
    Candidates are deduplicated and kept in ascending cell order.
    """
    cap = dirty.shape[0]
    dims_t = state.slot_grid.shape
    dev = dirty.device
    live = torch.arange(cap, device=dev) < state.alloc_count

    def cells_of(mask):
        keys = _first_ids(mask, max_blocks)
        ok = keys < _BIG
        cells = (state.block_index_of_slot[torch.where(ok, keys, 0).long()]
                 - state.origin_block)
        return cells, ok & wg._in_grid(cells, dims_t)

    cells_d, ok_d = cells_of(dirty & live)
    offs = device_constant(wg.OCTANT_OFFSETS, dev)
    cand = [(cells_d[None] - offs[:, None]).reshape(-1, 3)]
    cand_ok = [ok_d.repeat(8)]
    if extra is not None:
        cells_e, ok_e = cells_of(extra & live & ~dirty)
        cand.append(cells_e)
        cand_ok.append(ok_e)
    cand = torch.cat(cand)
    okc = torch.cat(cand_ok) & wg._in_grid(cand, dims_t)
    lin = (cand[:, 0] * dims_t[1] + cand[:, 1]) * dims_t[2] + cand[:, 2]
    lin = torch.where(okc, lin, 0)
    alloc_ok = state.slot_grid.reshape(-1)[lin.long()] >= 0
    keys_sorted = torch.sort(torch.where(okc & alloc_ok, lin, _BIG)).values
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       keys_sorted[1:] != keys_sorted[:-1]]) \
        & (keys_sorted < _BIG)
    ckeys = _smallest(torch.where(first, keys_sorted, _BIG), max_blocks)
    n = first.sum(dtype=torch.int32)
    lane = torch.arange(max_blocks, device=dev) < torch.clamp_max(n,
                                                                  max_blocks)
    cidx = torch.where(lane & (ckeys < _BIG), ckeys, 0)
    cell = torch.stack([cidx // (dims_t[1] * dims_t[2]),
                        (cidx // dims_t[2]) % dims_t[1], cidx % dims_t[2]], -1)
    slot = state.slot_grid[cell[:, 0].long(), cell[:, 1].long(),
                           cell[:, 2].long()]
    slots = torch.where(lane & (slot >= 0), slot, cap)
    bidx = torch.where((lane & (slots < cap))[:, None],
                       cell + state.origin_block, 0)
    return slots, bidx


@torch.no_grad()
def _surface_batch(state, dirty, pending, tsdf_distance, tsdf_weight, *,
                   min_weight: float, max_blocks: int,
                   max_surface_blocks: int = 0, slot_bucket: int = 0):
    """The mesh step's batches: compact dirty -> surface-crossing subset.

    The dirty + neighbour batch (max_blocks) feeds only the cheap crossing
    test; the kernel runs on a second compaction of just the crossing blocks
    (max_surface_blocks, default max(max_blocks // 4, 256)), dirty rows
    first. Crossing rows beyond that budget go to `pending` and rejoin the
    next batch without neighbour expansion. `slot_bucket` restricts the
    crossing test's per-slot sign summaries to the pool prefix (exact while
    allocation stays inside it; check_slot_bucket() verifies).

    Returns (surf_nbr8 i32[ms, 8], surf_valid i32[ms], surf_bidx,
    surf_slots, clear_bidx i32[max_blocks, 3], clear_rows bool[max_blocks],
    new_dirty, new_pending): `clear_*` lists batched blocks with no surface
    crossing, whose mesh-layer entries are stale."""
    cap = tsdf_distance.shape[0]
    dev = dirty.device
    ms = min(max_surface_blocks or max(max_blocks // 4, 256), max_blocks)
    slots, bidx = _compact_dirty_impl(state, dirty, max_blocks=max_blocks,
                                      extra=pending)
    nbr8 = wg.neighbor_slots8_of(state, bidx)
    in_batch = slots < cap
    sb = slot_bucket if 0 < slot_bucket < cap else cap
    crossing = in_batch & surface_crossing(
        tsdf_distance[:sb], tsdf_weight[:sb], nbr8, min_weight=min_weight)

    # Crossing rows -> surface batch, dirty rows first.
    rows = torch.arange(max_blocks, dtype=torch.int32, device=dev)
    row_dirty = in_batch & dirty[slots.clamp(0, cap - 1).long()]
    prio = rows + torch.where(row_dirty, 0, max_blocks)
    keys2 = _smallest(torch.where(crossing, prio, _BIG), ms)
    rowsel = torch.where(keys2 < _BIG, torch.remainder(keys2, max_blocks),
                         0).long()
    n_cross = crossing.sum(dtype=torch.int32)
    lane2 = torch.arange(ms, device=dev) < torch.clamp_max(n_cross, ms)
    surf_slots = torch.where(lane2, slots[rowsel], cap)
    surf_bidx = torch.where(lane2[:, None], bidx[rowsel], 0)
    surf_nbr8 = torch.where(lane2[:, None], nbr8[rowsel], -1)

    # Every batched slot's dirty bit clears (its mesh work is done now or
    # recorded in pending); crossing rows the budget skipped become
    # pending.
    selected = _mark(max_blocks, rowsel, lane2)
    overflow = crossing & ~selected
    batched_bits = _mark(cap, slots, in_batch)
    overflow_bits = _mark(cap, slots, overflow)
    new_dirty = dirty & ~batched_bits
    new_pending = (pending & ~batched_bits) | overflow_bits
    clear_rows = in_batch & ~crossing
    return (surf_nbr8, (surf_slots < cap).to(torch.int32), surf_bidx,
            surf_slots, bidx, clear_rows, new_dirty, new_pending)


@torch.no_grad()
def _mesh_dirty_fused(state, dirty, pending, tsdf_distance, tsdf_weight,
                      color_rows, *, min_weight: float, max_blocks: int,
                      with_color: bool, max_surface_blocks: int = 0,
                      slot_bucket: int = 0):
    """`_surface_batch` -> marching cubes (kernel marching_cubes, halo read
    in place). Returns (verts_e, colors_e | None, table, surf_bidx,
    surf_slots, clear_bidx, clear_rows, new_dirty, new_pending)."""
    nbr8, valid, *rest = _surface_batch(
        state, dirty, pending, tsdf_distance, tsdf_weight,
        min_weight=min_weight, max_blocks=max_blocks,
        max_surface_blocks=max_surface_blocks, slot_bucket=slot_bucket)
    verts_e, colors_e, table = marching_cubes_fused(
        tsdf_distance, tsdf_weight, color_rows, nbr8, valid,
        min_weight=min_weight, with_color=with_color)
    return (verts_e, colors_e, table, *rest)


def _esdf_stats(state, esdf_dirty):
    """Live count + allocated/dirty block AABBs (device tensors)."""
    bi = state.block_index_of_slot
    big = 1 << 20
    live = wg.live_slot_mask(state)
    full = torch.full_like(bi, big)
    a_lo = torch.amin(torch.where(live[:, None], bi, full), dim=0)
    a_hi = torch.amax(torch.where(live[:, None], bi, -full), dim=0)
    dirty = esdf_dirty & live
    d_lo = torch.amin(torch.where(dirty[:, None], bi, full), dim=0)
    d_hi = torch.amax(torch.where(dirty[:, None], bi, -full), dim=0)
    return (live.sum(dtype=torch.int32), a_lo, a_hi, d_lo, d_hi,
            dirty.sum(dtype=torch.int32))


def _esdf_sites(layer_a, layer_b, *, voxel_size_m: float, esdf_params,
                sites_from: str):
    """(is_site, is_inside, observed) bool[n, 512] of the projective layer:
    `layer_a`/`layer_b` are (tsdf_distance, tsdf_weight), or with
    sites_from="occupancy" (occupancy_log_odds, occupancy_observed)."""
    if sites_from == "occupancy":
        return esdf_ops.esdf_sites_from_occupancy(
            layer_a, layer_b > 0, occupied_log_odds_threshold=float(
                esdf_params.occupied_log_odds_threshold))
    return esdf_ops.esdf_sites_from_tsdf(
        layer_a, layer_b, voxel_size_m=voxel_size_m,
        max_site_distance_vox=float(esdf_params.max_site_distance_vox),
        min_weight=float(esdf_params.min_weight))


@torch.no_grad()
def _esdf_solve(state, layer_a, layer_b, origin_b, *, dims_b, band: int,
                voxel_size_m: float, esdf_params, sites_from: str = "tsdf"):
    """sites -> exact banded EDT over the region: (sq, is_inside, observed).

    The channels (`_esdf_sites`) may be a pool prefix `[:n]`; the solve
    then covers the slots below n only (exact when alloc_count <= n)."""
    n = layer_a.shape[0]
    is_site, is_inside, observed = _esdf_sites(
        layer_a, layer_b, voxel_size_m=voxel_size_m, esdf_params=esdf_params,
        sites_from=sites_from)
    sq = esdf_from_sites_dense(
        is_site, state.block_index_of_slot[:n],
        torch.clamp_max(state.alloc_count, n), origin_b,
        dims_b=dims_b, band=band)
    return sq, is_inside, observed


def _voxel_z_band_mask(state, min_height_m: float, max_height_m: float, *,
                       voxel_size_m: float) -> torch.Tensor:
    """bool[cap, 512]: the voxel centre's z, (bz*8 + lz + 0.5) * voxel in
    float32 as the reference computes it, lies in [min_height_m,
    max_height_m] (the bounds rounded to float32)."""
    bi = state.block_index_of_slot
    lz = (torch.arange(VOXELS_PER_BLOCK, device=bi.device) % B).float()
    z = (bi[:, 2:3].float() * B + lz + 0.5) * float(np.float32(voxel_size_m))
    return ((z >= float(np.float32(min_height_m)))
            & (z <= float(np.float32(max_height_m))))


@torch.no_grad()
def _esdf2d_solve(state, layer_a, layer_b, origin_b, min_height_m: float,
                  max_height_m: float, *, dims_b, band: int,
                  voxel_size_m: float, esdf_params, sites_from: str):
    """The 2-D ESDF of the height band over a region of (Nx, Ny) blocks at
    world block `origin_b` (i32[2 or 3], its x and y): sites -> band mask
    -> the two planar passes (kernels edt_pass1, edt_pass), and the
    band's inside / observed collapses. Returns (sq2d f32[X, Y],
    inside2d bool[X, Y], observed2d bool[X, Y]); no host sync."""
    is_site, is_inside, observed = _esdf_sites(
        layer_a, layer_b, voxel_size_m=voxel_size_m, esdf_params=esdf_params,
        sites_from=sites_from)
    args = (_voxel_z_band_mask(state, min_height_m, max_height_m,
                               voxel_size_m=voxel_size_m),
            state.block_index_of_slot, state.alloc_count, origin_b)
    return (esdf_2d_from_sites(is_site, *args, dims_b=dims_b, band=band),
            collapse_2d_mask(is_inside, *args, dims_b=dims_b),
            collapse_2d_mask(observed, *args, dims_b=dims_b))


class DeviceMapper:
    def __init__(self, voxel_size_m: float,
                 params: Optional[MapperParams] = None,
                 world: Optional[wg.WorldGridConfig] = None,
                 enable_color: bool = True,
                 projective_layer: Optional[ProjectiveLayerType] = None,
                 max_blocks_per_frame: int = 4096,
                 enable_freespace: bool = False,
                 device=None):
        """`projective_layer` OCCUPANCY keeps a log-odds occupancy layer
        (f32 log-odds, u8 observed) in place of the TSDF, and no color.
        `enable_freespace` (TSDF layer only) adds the freespace channels
        that `update_freespace` keeps and dynamic detection reads."""
        self.device = resolve_device(device)
        self.voxel_size_m = float(voxel_size_m)
        self.params = params or MapperParams()
        self.world_config = world or wg.WorldGridConfig()
        self.state = wg.create_world_grid(self.world_config, self.device)
        self.max_blocks_per_frame = max_blocks_per_frame
        self.projective_layer = projective_layer or ProjectiveLayerType.TSDF
        self._is_occupancy = (self.projective_layer
                              == ProjectiveLayerType.OCCUPANCY)
        cap = self.world_config.capacity
        dev = self.device

        shape = (cap, VOXELS_PER_BLOCK)
        if self._is_occupancy:
            self.channels: Dict[str, torch.Tensor] = {
                "occupancy_log_odds": torch.zeros(shape, device=dev),
                "occupancy_observed": torch.zeros(shape, dtype=torch.uint8,
                                                  device=dev)}
            enable_color = False
        else:
            self.channels = {
                "tsdf_distance": torch.zeros(shape, device=dev),
                "tsdf_weight": torch.zeros(shape, device=dev)}
            if enable_freespace:
                self.channels.update({
                    "freespace_consecutive_ms": torch.zeros(shape,
                                                            device=dev),
                    "freespace_last_occupied_ms": torch.full(shape, -1e9,
                                                             device=dev),
                    "freespace_high_confidence": torch.full(
                        shape, bool(self.params.freespace
                                    .initialize_to_high_confidence_freespace),
                        dtype=torch.bool, device=dev)})
        self.channels.update({
            "esdf_sq_dist": torch.full(shape, esdf_ops.INF_SQ, device=dev),
            "esdf_is_inside": torch.zeros(shape, dtype=torch.bool, device=dev),
            "esdf_observed": torch.zeros(shape, dtype=torch.bool, device=dev),
        })
        if enable_color:
            # Planar r/g/b (0-255) and weight: the mesh kernel reads each
            # channel's pool rows directly.
            for name in COLOR_CHANNELS:
                self.channels[name] = torch.zeros(shape, device=dev)
        self.dirty = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.esdf_dirty = torch.zeros((cap,), dtype=torch.bool, device=dev)
        # Crossing blocks the mesh surface budget skipped (re-mesh backlog).
        self.mesh_pending = torch.zeros((cap,), dtype=torch.bool, device=dev)
        # Ring of freed block indices (decay, clearing) for removed-block
        # publishing: entry i % cap holds the i-th freed block.
        self.removed_log = torch.zeros((cap, 3), dtype=torch.int32,
                                       device=dev)
        self.removed_count = torch.zeros((), dtype=torch.int32, device=dev)
        self._removed_read = 0  # host cursor into the ring
        # What the last mesh-layer update drained (device_io): the removed
        # block keys (the ring is read once), the re-meshed keys and the
        # bytes of mesh rows it copied to the host.
        self.last_removed_keys = []
        self.last_meshed_keys = []
        self.last_mesh_host_bytes = 0
        # The last depth view (TSDF decay keeps its voxels).
        self.last_depth_T_L_C = None
        self.last_depth_camera: Optional[Camera] = None
        # (block indices, rows) of batched blocks with no surface crossing
        # since the last take_mesh_clear_keys().
        self._mesh_clear_pending = []
        self.mesh_layer = MeshLayer(self.voxel_size_m, self.params.mesh)
        # True once a full-AABB ESDF solve has run (incremental updates are
        # only exact relative to a previous full solve).
        self._esdf_has_full = False
        # Host-tracked block AABBs (np arrays or None): allocated
        # high-water and dirty-since-last-ESDF, from host pose geometry.
        # Poses given as device tensors make the region unknown; the next
        # ESDF update then reads the allocated AABB back once.
        self._aabb_lo = self._aabb_hi = None
        self._dirty_lo = self._dirty_hi = None
        self._region_unknown = False
        # The 2-D ESDF (update_esdf_2d): ((origin x, y blocks), sq2d,
        # inside2d, observed2d) or None; its band; the frame (origin, dims,
        # band) of the last solve, whose change forces a new solve; and its
        # own dirty window, so that a 3-D update does not take the 2-D
        # field's changes away, or the other way round.
        self.esdf_2d = None
        self.esdf_2d_frame_heights = None
        self._esdf2d_frame = None
        self._dirty2d_lo = self._dirty2d_hi = None
        # Smallest slot bucket of replays not yet checked (0: none).
        self._slot_bucket_pending = 0
        # Time of the last freespace update (ms; f32 on the device, so
        # that a replay's last frame time needs no readback).
        self._freespace_last_update_ms = torch.zeros((), device=dev)

    # ---------------------------------------------------------------- sizes
    @property
    def capacity(self) -> int:
        return self.world_config.capacity

    def refresh_count(self) -> int:
        """The live block count (one scalar device->host read)."""
        return int(self.state.alloc_count) - int(self.state.free_count)

    def block_count(self) -> int:
        return self.refresh_count()

    def _reset_extra(self):
        """Per-channel reset overrides for freed slots: freespace starts
        as `initialize_to_high_confidence_freespace` says."""
        if "freespace_high_confidence" in self.channels:
            return (("freespace_high_confidence",
                     bool(self.params.freespace
                          .initialize_to_high_confidence_freespace)),)
        return ()

    def _view_bounds(self):
        """Workspace-bounds params, or None when unbounded."""
        v = self.params.view
        return (None if v.workspace_bounds_type
                == view_ops.WorkspaceBoundsType.UNBOUNDED else v)

    def _tensor(self, x, dtype):
        """`x` on the mapper's device. Host arrays go through pinned memory
        with an asynchronous copy, so that no step waits on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        t = torch.tensor(np.asarray(x), dtype=dtype)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # ------------------------------------------------------------ integrate
    def integrate_depth(self, depth, T_L_C, camera: Camera,
                        mask=None, mask_mode: int = 1) -> None:
        """Fuse one depth frame; the step makes no host sync.

        `mask` (u8[H,W], optional) restricts integration: mask_mode=1
        integrates unmasked pixels (background), 2 the masked ones
        (foreground).
        """
        if not isinstance(T_L_C, torch.Tensor):
            self._touch_region(np.asarray(T_L_C), camera)
        else:
            self._region_unknown = True
        depth = self._tensor(depth, torch.float32)
        T_L_C = self._tensor(T_L_C, torch.float32)
        mm = 0 if mask is None else int(mask_mode)
        mask_t = None if mask is None else self._tensor(mask, torch.uint8)
        if self._is_occupancy:
            self.state = _integrate_occupancy_frame(
                self.state, self.channels["occupancy_log_odds"],
                self.channels["occupancy_observed"], self.dirty,
                self.esdf_dirty, depth, T_L_C, mask_t, camera=camera,
                voxel_size_m=self.voxel_size_m, params=self.params.occupancy,
                max_blocks=self.max_blocks_per_frame, mask_mode=mm,
                view_params=self._view_bounds())
        else:
            self.state = _integrate_frame(
                self.state, self.channels["tsdf_distance"],
                self.channels["tsdf_weight"], self.dirty, self.esdf_dirty,
                depth, T_L_C, mask_t, camera=camera,
                voxel_size_m=self.voxel_size_m, params=self.params.projective,
                max_blocks=self.max_blocks_per_frame, mask_mode=mm,
                view_params=self._view_bounds())
        self.last_depth_T_L_C = T_L_C
        self.last_depth_camera = camera

    # ------------------------------------------------------------ freespace
    def _time(self, t) -> torch.Tensor:
        """A time in ms as an f32 scalar on the device (a fill kernel for
        a host number: no host->device copy)."""
        if isinstance(t, torch.Tensor):
            return t.to(device=self.device, dtype=torch.float32)
        return torch.full((), float(t), device=self.device)

    def update_freespace(self, time_ms, T_L_C, camera: Camera) -> None:
        """The freespace state machine over the current view at `time_ms`
        (a mapper without freespace channels ignores the call). With the
        block region known on the host, the full-pool form over that
        region (kernel dilate_dense), else the view-batch form. No host
        sync."""
        if "freespace_consecutive_ms" not in self.channels:
            return
        if not self._region_unknown and self._aabb_lo is not None:
            origin, dims = self.esdf_region(margin_blocks=0)
            origin_b = device_ints(origin, torch.int32, self.device)
            dims_b = tuple(int(d) for d in dims)
        else:
            origin_b, dims_b = None, None
        t = self._time(time_ms)
        ch = self.channels
        _freespace_fused(
            ch["freespace_consecutive_ms"], ch["freespace_last_occupied_ms"],
            ch["freespace_high_confidence"], self.state, ch["tsdf_distance"],
            ch["tsdf_weight"], self._tensor(T_L_C, torch.float32), t,
            self._freespace_last_update_ms, origin_b, camera=camera,
            voxel_size_m=self.voxel_size_m, params=self.params.freespace,
            view_distance_m=float(
                self.params.projective.max_integration_distance_m),
            max_blocks=self.max_blocks_per_frame, dims_b=dims_b)
        self._freespace_last_update_ms = t

    def integrate_pointcloud(self, points, T_L_S, lidar, timestamps_s=None,
                             T_L_S_end=None) -> None:
        """Fuse one lidar scan `f32[N, 3]` (sensor frame) taken at T_L_S:
        with `timestamps_s` (per point, from scan start) and `T_L_S_end`,
        motion compensation into the scan-end frame first; then the range
        image, the lidar view grid, allocation and spherical TSDF fusion
        (kernel tsdf_lidar_fuse). The step makes no host sync. A TSDF layer
        only."""
        if self._is_occupancy:
            raise NotImplementedError(
                "lidar integration requires a TSDF projective layer")
        if not isinstance(T_L_S, torch.Tensor):
            self._touch_lidar_region(np.asarray(T_L_S), lidar)
        else:
            self._region_unknown = True
        points = self._tensor(points, torch.float32)
        T_L_S = self._tensor(T_L_S, torch.float32)
        if timestamps_s is not None and T_L_S_end is not None:
            T_L_S_end = self._tensor(T_L_S_end, torch.float32)
            points = motion_compensate_pointcloud(
                points, self._tensor(timestamps_s, torch.float32), T_L_S,
                T_L_S_end, lidar)
            T_L_S = T_L_S_end
        self.state = _integrate_lidar_frame(
            self.state, self.channels["tsdf_distance"],
            self.channels["tsdf_weight"], self.dirty, self.esdf_dirty,
            pointcloud_to_range_image(points, lidar), T_L_S, lidar=lidar,
            voxel_size_m=self.voxel_size_m, params=self.params.projective,
            max_blocks=self.max_blocks_per_frame,
            view_params=self._view_bounds())

    def _touch_lidar_region(self, T_L_S_np: np.ndarray, lidar) -> None:
        """Fold the lidar's range cube around its origin into the
        host-side AABBs (no device work)."""
        bs = self.voxel_size_m * B
        r = min(self.params.projective.max_integration_distance_m,
                lidar.max_valid_range_m)
        o = np.asarray(T_L_S_np, np.float64)[:3, 3]
        lo = np.floor((o - r) / bs).astype(np.int64) - 1
        hi = np.floor((o + r) / bs).astype(np.int64) + 1
        w_lo, w_hi = self._world_bounds()
        self._touch_block_aabb(np.maximum(lo, w_lo), np.minimum(hi, w_hi))

    # --------------------------------------------------------- decay / clear
    def _removed(self):
        return self.removed_log, self.removed_count

    def _touch_allocated(self) -> None:
        """A map-wide change: the next ESDF update re-solves the whole
        allocated AABB (host-side, no device sync)."""
        if self._aabb_lo is not None:
            self._touch_block_aabb(self._aabb_lo, self._aabb_hi)

    def decay(self, max_free: int = 4096) -> None:
        """Decay the projective layer (occupancy log-odds toward the
        prior, or TSDF weights outside the last depth view) and free the
        fully decayed blocks; their slots recycle through the free stack
        and their block indices go to the removed ring. No host sync."""
        if self._is_occupancy:
            self.state, self.removed_count = _decay_occupancy_fused(
                self.state, self.channels, self.dirty, self.esdf_dirty,
                self._removed(), params=self.params.occupancy_decay,
                max_free=max_free, dealloc_threshold=1e-3,
                reset_extra=self._reset_extra())
        else:
            has_view = (self.last_depth_T_L_C is not None
                        and self.last_depth_camera is not None)
            T = (self.last_depth_T_L_C if has_view
                 else torch.eye(4, dtype=torch.float32, device=self.device))
            self.state, self.removed_count = _decay_tsdf_fused(
                self.state, self.channels, self.dirty, self.esdf_dirty,
                self._removed(), T, camera=self.last_depth_camera,
                voxel_size_m=self.voxel_size_m, params=self.params.tsdf_decay,
                max_free=max_free, has_view=has_view,
                reset_extra=self._reset_extra(),
                view_distance_m=float(
                    self.params.projective.max_integration_distance_m))
        self._touch_allocated()

    def clear_outside_radius(self, center_m, radius_m: float,
                             max_free: int = 8192) -> None:
        """Free every block whose center lies farther than `radius_m` from
        `center_m` (host (x, y, z) or a device f32[3]). No host sync."""
        center = self._tensor(center_m, torch.float32)
        self.state, self.removed_count = _clear_outside_radius_fused(
            self.state, self.channels, self.dirty, self.esdf_dirty,
            self._removed(), center, float(radius_m),
            voxel_size_m=self.voxel_size_m, max_free=max_free,
            reset_extra=self._reset_extra())
        self._touch_allocated()

    def clear_tsdf_inside_shapes(self, spheres=(), aabbs=(),
                                 max_shapes: int = 8) -> None:
        """Unobserve the TSDF voxels inside spheres ((cx, cy, cz), r) and
        boxes ((lo xyz), (hi xyz)), at most `max_shapes` of each; an
        occupancy mapper ignores the call. No host sync."""
        if self._is_occupancy:
            return
        sp = [(*c, r) for c, r in list(spheres)[:max_shapes]]
        ab = [(*lo, *hi) for lo, hi in list(aabbs)[:max_shapes]]
        _clear_shapes_fused(
            self.state, self.channels["tsdf_distance"],
            self.channels["tsdf_weight"], self.dirty, self.esdf_dirty,
            self._tensor(np.reshape(np.asarray(sp, np.float64), (-1, 4)),
                         torch.float32),
            self._tensor(np.reshape(np.asarray(ab, np.float64), (-1, 6)),
                         torch.float32),
            voxel_size_m=self.voxel_size_m)
        self._touch_allocated()

    @property
    def color_enabled(self) -> bool:
        return "color_r" in self.channels

    def _color_channels(self):
        return tuple(self.channels[k] for k in COLOR_CHANNELS)

    def integrate_color(self, color_image, T_L_C, camera: Camera,
                        depth=None) -> None:
        """Fuse one color frame `u8/f32[H, W, 3]` into the colors of the
        allocated blocks in its frustum (no allocation; kernel color_fuse);
        the step makes no host sync. `depth` (`f32[Hd, Wd]`, optional) is
        the occlusion depth, sampled at uv * Hd / H; without it no voxel is
        occluded. A mapper without color channels ignores the frame."""
        if not self.color_enabled:
            return
        T_L_C = self._tensor(T_L_C, torch.float32)
        color_image = self._image(color_image)
        depth = (torch.zeros((1, 1), device=self.device) if depth is None
                 else self._tensor(depth, torch.float32))
        _integrate_color_frame(
            self._color_channels(), self.dirty,
            self.channels["tsdf_distance"], self.channels["tsdf_weight"],
            self.state, color_image, depth, T_L_C, camera=camera,
            voxel_size_m=self.voxel_size_m, params=self.params.projective,
            max_blocks=self.max_blocks_per_frame)

    def _image(self, image) -> torch.Tensor:
        """A color image (or a stack of them) on the device, u8 kept u8; a
        host array goes through pinned memory, as `_tensor`'s do."""
        if isinstance(image, torch.Tensor):
            dtype = torch.uint8 if image.dtype == torch.uint8 \
                else torch.float32
            return image.to(device=self.device, dtype=dtype)
        image = np.asarray(image)
        return self._tensor(image, torch.uint8 if image.dtype == np.uint8
                            else torch.float32)

    # ----------------------------------------------------------- region AABB
    def _world_bounds(self):
        lo = np.asarray(self.world_config.origin_block, np.int64)
        hi = lo + np.asarray(self.world_config.dims, np.int64) - 1
        return lo, hi

    def _touch_region(self, T_L_C_np: np.ndarray, camera: Camera) -> None:
        """Fold one view's frustum block-AABB into the host-side dirty and
        allocated-high-water AABBs (no device work)."""
        lo, hi = view_ops.frustum_block_aabb(
            T_L_C_np, camera,
            self.params.projective.max_integration_distance_m,
            self.voxel_size_m)
        w_lo, w_hi = self._world_bounds()
        self._touch_block_aabb(np.maximum(lo, w_lo), np.minimum(hi, w_hi))

    def _touch_block_aabb(self, lo, hi) -> None:
        if np.any(hi < lo):
            return
        if self._aabb_lo is None:
            self._aabb_lo, self._aabb_hi = lo.copy(), hi.copy()
        else:
            self._aabb_lo = np.minimum(self._aabb_lo, lo)
            self._aabb_hi = np.maximum(self._aabb_hi, hi)
        if self._dirty_lo is None:
            self._dirty_lo, self._dirty_hi = lo.copy(), hi.copy()
        else:
            self._dirty_lo = np.minimum(self._dirty_lo, lo)
            self._dirty_hi = np.maximum(self._dirty_hi, hi)
        if self._dirty2d_lo is None:
            self._dirty2d_lo, self._dirty2d_hi = lo.copy(), hi.copy()
        else:
            self._dirty2d_lo = np.minimum(self._dirty2d_lo, lo)
            self._dirty2d_hi = np.maximum(self._dirty2d_hi, hi)

    def _refresh_region_from_device(self) -> bool:
        """One device->host read of the allocated AABB (used only when
        poses arrived as device tensors). Returns False if empty."""
        stats = [t.cpu().numpy() for t in
                 _esdf_stats(self.state, self.esdf_dirty)]
        if int(stats[0]) == 0:
            return False
        self._touch_block_aabb(np.asarray(stats[1], np.int64),
                               np.asarray(stats[2], np.int64))
        self._region_unknown = False
        return True

    # ----------------------------------------------------------------- esdf
    @property
    def esdf_band_vox(self) -> int:
        """Propagation band in voxels."""
        return int(np.ceil(self.params.esdf.max_esdf_distance_m
                           / self.voxel_size_m))

    def update_esdf(self, full: Optional[bool] = None) -> None:
        """Exact ESDF update via the dense banded EDT.

        full=None (default): the first update solves the whole allocated
        AABB; later updates solve only the dirty-block AABB + band margin
        (exact — a distance can only change within `band` of a changed
        site) and splice the result. full=True forces a whole-map solve.
        """
        band = self.esdf_band_vox
        mb = (band + 7) // 8  # band margin in blocks
        if self._region_unknown and not self._refresh_region_from_device():
            return
        if self._aabb_lo is None:
            return  # nothing ever integrated
        a_lo, a_hi = self._aabb_lo, self._aabb_hi
        if full is None:
            full = not self._esdf_has_full
        if not full and self._dirty_lo is None:
            return  # nothing changed since the last update
        if full or self._dirty_lo is None:
            c_lo, c_hi = a_lo, a_hi
            r_lo, r_hi = a_lo, a_hi
        else:
            d_lo, d_hi = self._dirty_lo, self._dirty_hi
            # Compute region C = dirty AABB + band (clipped to the map, but
            # always covering the dirty blocks); read region R = C + band.
            c_lo = np.minimum(np.maximum(d_lo - mb, a_lo), d_lo)
            c_hi = np.maximum(np.minimum(d_hi + mb, a_hi), d_hi)
            r_lo = np.minimum(np.maximum(c_lo - mb, a_lo), c_lo)
            r_hi = np.maximum(np.minimum(c_hi + mb, a_hi), c_hi)
        dims_b = tuple(_bucket_blocks_coarse(int(h - l + 1))
                       for l, h in zip(r_lo, r_hi))
        dev = self.device
        sq_new, is_inside, observed = _esdf_solve(
            self.state, *self._esdf_layers(),
            device_ints(r_lo, torch.int32, dev),
            dims_b=dims_b, band=band, voxel_size_m=self.voxel_size_m,
            esdf_params=self.params.esdf,
            sites_from="occupancy" if self._is_occupancy else "tsdf")
        # Splice the compute region's blocks into the persistent channel.
        bi = self.state.block_index_of_slot
        lo = device_ints(c_lo, torch.int32, dev)
        hi = device_ints(c_hi, torch.int32, dev)
        live = (torch.arange(self.capacity, device=dev)
                < self.state.alloc_count)
        in_c = live & torch.all((bi >= lo[None, :]) & (bi <= hi[None, :]),
                                dim=1)
        old = self.channels["esdf_sq_dist"]
        old.copy_(torch.where(in_c[:, None], sq_new, old))
        self.channels["esdf_is_inside"].copy_(is_inside)
        self.channels["esdf_observed"].copy_(observed)
        self.esdf_dirty.zero_()
        self._dirty_lo = self._dirty_hi = None
        self._esdf_has_full = self._esdf_has_full or full

    def _esdf_layers(self):
        """The projective layer's two channels the ESDF takes its sites
        from."""
        if self._is_occupancy:
            return (self.channels["occupancy_log_odds"],
                    self.channels["occupancy_observed"])
        return self.channels["tsdf_distance"], self.channels["tsdf_weight"]

    # -------------------------------------------------------------- 2-D esdf
    def _esdf2d_frame_of(self, min_height_m: float, max_height_m: float):
        """(origin x, origin y, dims_b, min, max): the allocated AABB's xy
        extent, each axis rounded up to its coarse bucket, and the band."""
        a_lo, a_hi = self._aabb_lo, self._aabb_hi
        dims_b = tuple(_bucket_blocks_coarse(int(a_hi[a] - a_lo[a] + 1))
                       for a in (0, 1))
        return (int(a_lo[0]), int(a_lo[1]), dims_b, float(min_height_m),
                float(max_height_m))

    def _solve_esdf_2d(self, frame) -> None:
        ox, oy, dims_b, lo, hi = frame
        field = _esdf2d_solve(
            self.state, *self._esdf_layers(),
            device_ints((ox, oy), torch.int32, self.device), lo, hi,
            dims_b=dims_b, band=self.esdf_band_vox,
            voxel_size_m=self.voxel_size_m, esdf_params=self.params.esdf,
            sites_from="occupancy" if self._is_occupancy else "tsdf")
        self.esdf_2d = ((ox, oy), *field)
        self.esdf_2d_frame_heights = (lo, hi)
        self._esdf2d_frame = frame
        self._dirty2d_lo = self._dirty2d_hi = None

    def update_esdf_2d(self, min_height_m: float, max_height_m: float,
                       full: Optional[bool] = None) -> None:
        """The 2-D ESDF (EsdfMode 2d): sites restricted to the height band
        [min_height_m, max_height_m], planar distances, over the allocated
        AABB's xy extent (coarse-bucketed). Stored as `self.esdf_2d` =
        ((origin x, y blocks), sq2d f32[X, Y], inside2d, observed2d) for
        the 2-D slicer.

        With nothing changed since the last solve in the same frame
        (origin, dims and band), the call returns at once; otherwise the
        whole frame is solved again (its fixed shape beats a smaller
        dirty window). No host sync unless poses arrived as device
        tensors."""
        if self._region_unknown and not self._refresh_region_from_device():
            return
        if self._aabb_lo is None:
            return
        frame = self._esdf2d_frame_of(min_height_m, max_height_m)
        if full is None:
            full = self._esdf2d_frame != frame
        if not full and self._dirty2d_lo is None:
            return  # nothing changed since the last 2-D solve
        self._solve_esdf_2d(frame)

    def integrate_depth_with_esdf2d(self, depth, T_L_C, camera: Camera,
                                    min_height_m: float,
                                    max_height_m: float) -> bool:
        """The online tick: integrate one depth frame, then solve the 2-D
        ESDF over the frame the new AABB gives, with no host sync between
        or within them. Returns True when it ran; False (nothing done) for
        an occupancy layer, a pose given as a device tensor or an unknown
        region that reads back empty: the caller then falls back to
        integrate_depth() + update_esdf_2d()."""
        if self._is_occupancy or isinstance(T_L_C, torch.Tensor):
            return False
        if self._region_unknown and not self._refresh_region_from_device():
            return False
        # The frame covers the blocks this call allocates.
        self._touch_region(np.asarray(T_L_C), camera)
        if self._aabb_lo is None:
            return False
        frame = self._esdf2d_frame_of(min_height_m, max_height_m)
        T = self._tensor(T_L_C, torch.float32)
        self.state = _integrate_frame(
            self.state, self.channels["tsdf_distance"],
            self.channels["tsdf_weight"], self.dirty, self.esdf_dirty,
            self._tensor(depth, torch.float32), T, camera=camera,
            voxel_size_m=self.voxel_size_m, params=self.params.projective,
            max_blocks=self.max_blocks_per_frame,
            view_params=self._view_bounds())
        self.last_depth_T_L_C = T
        self.last_depth_camera = camera
        self._solve_esdf_2d(frame)
        return True

    # --------------------------------------------------------------- replay
    def esdf_region(self, margin_blocks: int = 2, mult: int = 4):
        """(origin, dims) covering the current allocated AABB + margin,
        dims rounded up to a multiple of `mult` blocks."""
        if self._region_unknown or self._aabb_lo is None:
            self._refresh_region_from_device()
        if self._aabb_lo is None:
            return np.zeros(3, np.int64), (8, 8, 8)
        a_lo, a_hi = self._aabb_lo, self._aabb_hi
        origin = a_lo - margin_blocks
        dims = tuple(_bucket_blocks(int(h - l + 1 + 2 * margin_blocks), mult)
                     for l, h in zip(a_lo, a_hi))
        return origin, dims

    @torch.no_grad()
    def replay_frames(self, depths, T_L_Cs, camera: Camera, *,
                      esdf_every: int = 0, mesh_every: int = 0,
                      colors=None, color_every: int = 0,
                      esdf_region=None, mesh_max_blocks: int = 2048,
                      mesh_surface_blocks: int = 0,
                      slot_bucket: int = 0) -> None:
        """Replay N depth frames (the offline / benchmarking loop), step for
        step as the reference's replay scan.

        Every frame is integrated. With `colors` (`u8/f32[N, H, W, 3]`),
        every `color_every`-th frame also fuses its color frame: in the same
        pass over the depth frame's batch (kernel tsdf_color_fuse) when the
        color and depth frames are aligned, otherwise over the color
        frustum's batch after the TSDF step (kernel color_fuse, the depth
        frame as occlusion depth). Every `esdf_every` frames the ESDF is
        re-solved over a fixed region, `esdf_region=(origin_blocks,
        dims_blocks)` or by default the current AABB + margin. Every
        `mesh_every` frames the dirty blocks are meshed
        (`_mesh_dirty_fused` with `mesh_max_blocks` /
        `mesh_surface_blocks`); the soup is dropped, the dirty and pending
        bookkeeping kept. The loop makes no host sync once the frames are
        on the device.

        `slot_bucket` (optional) restricts the ESDF's pool-shaped stages
        (site extraction, seeding, gather, channel writes) and the mesh
        step's sign summaries to the pool prefix `[:slot_bucket]`.
        Allocation is prefix-dense (recycling keeps the high-water mark),
        so this is exact while the replay's final `alloc_count` stays
        within the bucket; `check_slot_bucket()` verifies that after the
        replay (one readback, outside any timing).
        """
        if self._is_occupancy:
            raise ValueError("replay_frames replays a TSDF layer; feed an "
                             "occupancy mapper with integrate_depth")
        depths = self._tensor(depths, torch.float32)
        T_L_Cs = self._tensor(T_L_Cs, torch.float32)
        run_color = (color_every > 0 and colors is not None
                     and self.color_enabled)
        if run_color:
            colors = self._image(colors)
            fuse_color = tuple(colors.shape[1:3]) == tuple(depths.shape[1:3])
        run_esdf = esdf_every > 0
        if run_esdf:
            origin, dims = (self.esdf_region() if esdf_region is None
                            else esdf_region)
            dims = tuple(int(d) for d in dims)
            origin_t = device_ints(origin, torch.int32, self.device)
        ch = self.channels
        sb = slot_bucket if 0 < slot_bucket < self.capacity else self.capacity
        color_rows = (self._color_channels()[:3] if self.color_enabled
                      else None)
        for k in range(depths.shape[0]):
            color_now = run_color and (k + 1) % color_every == 0
            self.state = _integrate_frame(
                self.state, ch["tsdf_distance"], ch["tsdf_weight"],
                self.dirty, self.esdf_dirty, depths[k], T_L_Cs[k],
                camera=camera, voxel_size_m=self.voxel_size_m,
                params=self.params.projective,
                max_blocks=self.max_blocks_per_frame,
                color=((colors[k], self._color_channels())
                       if color_now and fuse_color else None))
            if color_now and not fuse_color:
                _integrate_color_frame(
                    self._color_channels(), self.dirty, ch["tsdf_distance"],
                    ch["tsdf_weight"], self.state, colors[k], depths[k],
                    T_L_Cs[k], camera=camera, voxel_size_m=self.voxel_size_m,
                    params=self.params.projective,
                    max_blocks=self.max_blocks_per_frame)
            if run_esdf and (k + 1) % esdf_every == 0:
                sq, ins, obs = _esdf_solve(
                    self.state, ch["tsdf_distance"][:sb],
                    ch["tsdf_weight"][:sb], origin_t, dims_b=dims,
                    band=self.esdf_band_vox, voxel_size_m=self.voxel_size_m,
                    esdf_params=self.params.esdf)
                ch["esdf_sq_dist"][:sb].copy_(sq)
                ch["esdf_is_inside"][:sb].copy_(ins)
                ch["esdf_observed"][:sb].copy_(obs)
                self.esdf_dirty.zero_()
            if mesh_every > 0 and (k + 1) % mesh_every == 0:
                out = _mesh_dirty_fused(
                    self.state, self.dirty, self.mesh_pending,
                    ch["tsdf_distance"], ch["tsdf_weight"], color_rows,
                    min_weight=float(self.params.mesh.min_weight),
                    max_blocks=int(mesh_max_blocks),
                    with_color=self.color_enabled,
                    max_surface_blocks=int(mesh_surface_blocks),
                    slot_bucket=sb)
                self.dirty, self.mesh_pending = out[-2], out[-1]
        if sb < self.capacity:
            prev = self._slot_bucket_pending
            self._slot_bucket_pending = min(prev, sb) if prev else sb
        # Fold the replayed extent into the host-tracked region. Poses are
        # device tensors here, so use the solved region (or mark unknown).
        if run_esdf:
            w_lo, w_hi = self._world_bounds()
            lo = np.maximum(np.asarray(origin, np.int64), w_lo)
            hi = np.minimum(np.asarray(origin, np.int64)
                            + np.asarray(dims, np.int64) - 1, w_hi)
            self._touch_block_aabb(lo, hi)
            self._esdf_has_full = True
        else:
            self._region_unknown = True

    def check_slot_bucket(self) -> None:
        """Verify that slot_bucket-restricted replays stayed exact: the slot
        high-water mark must not exceed the smallest bucket used since the
        last check (one scalar readback)."""
        sb = self._slot_bucket_pending
        if not sb:
            return
        hw = int(self.state.alloc_count)
        if hw > sb:
            raise AssertionError(
                f"slot_bucket {sb} exceeded: alloc high-water {hw}; ESDF "
                "results for slots beyond the bucket are stale")
        self._slot_bucket_pending = 0

    # ----------------------------------------------------------------- mesh
    def update_mesh_dirty_device(self, max_blocks: int = 2048,
                                 return_slots: bool = False):
        """Incremental marching cubes over the dirty blocks (and their
        -1-side neighbours, whose cubes read the changed voxels) plus the
        pending backlog, through the marching_cubes kernel; no host sync.

        Returns (verts bf16[Ns, 3, 16, 512] block-local voxel units with
        SENTINEL in empty slots, colors bf16 | None, mask bool[Ns, 16, 512],
        block indices i32[Ns, 3]) and, with `return_slots`, the slots.
        `ops.mesh_cuda.local_to_world_verts` gives meters. Batched blocks
        without a surface crossing are queued for take_mesh_clear_keys().
        """
        (verts_e, colors_e, table, bidx, slots, clear_bidx, clear_rows,
         self.dirty, self.mesh_pending) = _mesh_dirty_fused(
            self.state, self.dirty, self.mesh_pending,
            self.channels["tsdf_distance"], self.channels["tsdf_weight"],
            (self._color_channels()[:3] if self.color_enabled
             else None),
            min_weight=float(self.params.mesh.min_weight),
            max_blocks=max_blocks, with_color=self.color_enabled)
        # Slot -> edge resolution at this (publish) cadence.
        verts, colors = resolve_edge_soup(verts_e, colors_e, table,
                                          with_color=self.color_enabled)
        self._mesh_clear_pending.append((clear_bidx, clear_rows))
        mask = verts[:, 0] >= 0
        if return_slots:
            return verts, colors, mask, bidx, slots
        return verts, colors, mask, bidx

    def take_mesh_clear_keys(self) -> list:
        """The block keys whose batch rows had no surface crossing in the
        mesh updates since the last call (their mesh-layer entries are
        stale); one small readback per queued update."""
        pending, self._mesh_clear_pending = self._mesh_clear_pending, []
        keys = []
        for bidx, rows in pending:
            bidx_np, rows_np = bidx.cpu().numpy(), rows.cpu().numpy()
            keys.extend(tuple(int(v) for v in bidx_np[i])
                        for i in np.nonzero(rows_np)[0])
        return keys

    def _mesh_chunk(self, slots, bidx):
        """Full-map marching cubes (ops/mesh.py) for one block chunk."""
        cap = self.capacity
        nbrs = wg.neighbor_slots_of(self.state, bidx)
        grid = (cap, B, B, B)
        if self.color_enabled:
            color_grid = torch.stack(self._color_channels()[:3],
                                     dim=-1).reshape(grid + (3,))
        else:
            color_grid = torch.zeros(grid + (3,), device=self.device)
        verts, colors, valid = marching_cubes_blocks(
            self.channels["tsdf_distance"].reshape(grid),
            self.channels["tsdf_weight"].reshape(grid), color_grid, nbrs,
            bidx, voxel_size_m=self.voxel_size_m,
            min_weight=float(self.params.mesh.min_weight))
        return verts, colors, valid & (slots < cap)[:, None, None]

    def update_mesh_device(self, chunk: int = 2048):
        """Marching cubes over every allocated block (the cold full-map
        path). Returns a generator of (verts, colors, valid, block indices)
        per chunk of `chunk` slots, built lazily; the dirty and pending
        bookkeeping is cleared at once (one scalar readback)."""
        count = int(self.state.alloc_count)
        self.dirty.zero_()
        self.mesh_pending.zero_()
        return self._mesh_chunks_lazy(count, chunk)

    def _mesh_chunks_lazy(self, count: int, chunk: int):
        for start in range(0, max(count, 1), chunk):
            slots, bidx, _ = wg.allocated_batch_range(
                self.state, start, max_blocks=min(chunk, self.capacity))
            verts, colors, valid = self._mesh_chunk(slots, bidx)
            yield verts, colors, valid, bidx

    def export_mesh(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full-map mesh to the host (cold path): welded (vertices f32[V, 3],
        colors u8[V, 3], triangles i32[T, 3]) from the mesh layer."""
        for verts, colors, valid, bidx in self.update_mesh_device():
            verts, colors = verts.cpu().numpy(), colors.cpu().numpy()
            valid, bidx_np = valid.cpu().numpy(), bidx.cpu().numpy()
            for i in range(bidx_np.shape[0]):
                m = valid[i].reshape(-1)
                if not m.any():
                    continue
                self.mesh_layer.update_block(
                    tuple(bidx_np[i]), verts[i].reshape(-1, 3, 3)[m],
                    colors[i].reshape(-1, 3, 3)[m])
        return self.mesh_layer.as_arrays()

    # ---------------------------------------------------------------- state
    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The allocator state and the channels as numpy arrays, under the
        reference DeviceMapper's names (WorldGridState fields, channels,
        mesh_pending, removed_log and removed_count), copied. A freespace
        mapper adds `freespace_last_update_ms` (the reference's
        `_freespace_last_update_ms`)."""
        out = self.state.to_numpy()
        extra = dict(self.channels, mesh_pending=self.mesh_pending,
                     removed_log=self.removed_log,
                     removed_count=self.removed_count)
        if "freespace_consecutive_ms" in self.channels:
            extra["freespace_last_update_ms"] = (
                self._freespace_last_update_ms)
        # Copies: every step updates these tensors in place.
        out.update({k: np.array(v.cpu().numpy()) for k, v in extra.items()})
        return out

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Load a map saved by `state_arrays` or built from the reference
        DeviceMapper (`np.asarray` of its WorldGridState fields and its
        channels, same names). Keys this mapper does not hold are ignored.
        The host-tracked region becomes unknown, so the next ESDF update
        reads the allocated AABB back and solves it in full."""
        self.state = wg.WorldGridState.from_numpy(arrays, self.device)
        for k, v in self.channels.items():
            if k in arrays:
                v.copy_(torch.tensor(np.asarray(arrays[k]), dtype=v.dtype))
        self.mesh_pending.copy_(torch.tensor(
            np.asarray(arrays.get("mesh_pending", False)), dtype=torch.bool
        ).expand_as(self.mesh_pending))
        for k in ("removed_log", "removed_count"):
            t = getattr(self, k)
            t.copy_(torch.tensor(np.asarray(arrays.get(k, 0)),
                                 dtype=torch.int32).expand_as(t))
        self._freespace_last_update_ms = torch.tensor(
            float(np.asarray(arrays.get("freespace_last_update_ms", 0.0))),
            dtype=torch.float32, device=self.device)
        self.dirty.zero_()
        self.esdf_dirty.zero_()
        self._reset_host_tracking()
        self._removed_read = int(np.asarray(arrays.get("removed_count", 0)))

    def _reset_host_tracking(self) -> None:
        """Forget the host-tracked regions and the ESDF frames: the next
        ESDF update reads the allocated AABB back and solves it in full."""
        self._aabb_lo = self._aabb_hi = None
        self._dirty_lo = self._dirty_hi = None
        self._dirty2d_lo = self._dirty2d_hi = None
        self._region_unknown = True
        self._esdf_has_full = False
        self.esdf_2d = None
        self.esdf_2d_frame_heights = None
        self._esdf2d_frame = None
