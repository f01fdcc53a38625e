"""DeviceMapper: the device-resident depth -> TSDF -> ESDF path
(port of isaac_ros_nvblox_tpu/mapper/device_mapper.py, TSDF layer with
ESDF; color, mesh and freespace come in later slices).

    integrate_depth:  touched-grid -> allocate -> view batch -> TSDF fusion
                      (kernel tsdf_fuse) -> dirty bits; no host sync
    update_esdf:      exact banded separable EDT (kernels edt_pass1,
                      edt_pass) over the allocated AABB, or over the dirty
                      AABB + band, spliced into the ESDF channels
    replay_frames:    the offline loop over N frames with ESDF updates at
                      a fixed cadence over a fixed region

State lives on the mapper's device as tensors: the WorldGrid allocator and
the pool channels `f32/bool[cap, 512]`, which every step updates in place
(the reference donates the same buffers). The host tracks block AABBs from
the poses it is given, so the ESDF update needs no readback unless poses
arrive as device tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import (VOXELS_PER_BLOCK,
                                                   device_ints,
                                                   resolve_device,
                                                   set_rows_drop)
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
from isaac_ros_nvblox_tpu_torch.ops import view as view_ops
from isaac_ros_nvblox_tpu_torch.ops.esdf_dense import esdf_from_sites_dense
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda

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


@torch.no_grad()
def _integrate_frame(state, distance, weight, dirty, esdf_dirty, depth,
                     T_L_C, mask=None, *, camera: Camera, voxel_size_m: float,
                     params, max_blocks: int, mask_mode: int = 0,
                     view_params=None):
    """view grid -> allocate -> view batch -> TSDF fuse -> dirty bits.

    Updates the pool channels and dirty flags in place and returns the new
    allocator state. mask_mode: 0 = no mask, 1 = integrate unmasked pixels
    (background), 2 = integrate masked pixels (foreground).
    """
    if mask_mode == 1:
        depth = torch.where(mask > 0, torch.zeros_like(depth), depth)
    elif mask_mode == 2:
        depth = torch.where(mask > 0, depth, torch.zeros_like(depth))
    grid, origin = view_ops.touched_block_grid(
        depth, T_L_C, camera=camera, voxel_size_m=voxel_size_m,
        max_distance_m=params.max_integration_distance_m,
        truncation_m=params.truncation_m(voxel_size_m))
    if view_params is not None:
        grid = view_ops.apply_workspace_bounds_to_grid(
            grid, origin, voxel_size_m=voxel_size_m, params=view_params)
    state, slots, bidx, _ = wg.allocate_and_batch(
        state, grid, origin, max_blocks=max_blocks)
    integrate_tsdf_cuda(distance, weight, slots, bidx, depth, T_L_C,
                        camera=camera, voxel_size_m=voxel_size_m,
                        params=params)
    set_rows_drop(dirty, slots, True)
    set_rows_drop(esdf_dirty, slots, True)
    return state


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


@torch.no_grad()
def _esdf_solve(state, tsdf_distance, tsdf_weight, origin_b, *, dims_b,
                band: int, voxel_size_m: float, esdf_params):
    """sites -> exact banded EDT over the region: (sq, is_inside, observed).

    The channels may be a pool prefix `[:n]`; the solve then covers the
    slots below n only (exact when alloc_count <= n)."""
    n = tsdf_distance.shape[0]
    is_site, is_inside, observed = esdf_ops.esdf_sites_from_tsdf(
        tsdf_distance, tsdf_weight, voxel_size_m=voxel_size_m,
        max_site_distance_vox=float(esdf_params.max_site_distance_vox),
        min_weight=float(esdf_params.min_weight))
    sq = esdf_from_sites_dense(
        is_site, state.block_index_of_slot[:n],
        torch.clamp_max(state.alloc_count, n), origin_b,
        dims_b=dims_b, band=band)
    return sq, is_inside, observed


class DeviceMapper:
    def __init__(self, voxel_size_m: float,
                 params: Optional[MapperParams] = None,
                 world: Optional[wg.WorldGridConfig] = None,
                 max_blocks_per_frame: int = 4096,
                 device=None):
        self.device = resolve_device(device)
        self.voxel_size_m = float(voxel_size_m)
        self.params = params or MapperParams()
        self.world_config = world or wg.WorldGridConfig()
        self.state = wg.create_world_grid(self.world_config, self.device)
        self.max_blocks_per_frame = max_blocks_per_frame
        cap = self.world_config.capacity
        dev = self.device

        shape = (cap, VOXELS_PER_BLOCK)
        self.channels: Dict[str, torch.Tensor] = {
            "tsdf_distance": torch.zeros(shape, device=dev),
            "tsdf_weight": torch.zeros(shape, device=dev),
            "esdf_sq_dist": torch.full(shape, esdf_ops.INF_SQ, device=dev),
            "esdf_is_inside": torch.zeros(shape, dtype=torch.bool, device=dev),
            "esdf_observed": torch.zeros(shape, dtype=torch.bool, device=dev),
        }
        self.dirty = torch.zeros((cap,), dtype=torch.bool, device=dev)
        self.esdf_dirty = torch.zeros((cap,), dtype=torch.bool, device=dev)
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
        # Smallest slot bucket of replays not yet checked (0: none).
        self._slot_bucket_pending = 0

    # ---------------------------------------------------------------- sizes
    @property
    def capacity(self) -> int:
        return self.world_config.capacity

    def refresh_count(self) -> int:
        """The live block count (one scalar device->host read)."""
        return int(self.state.alloc_count) - int(self.state.free_count)

    def block_count(self) -> int:
        return self.refresh_count()

    def _view_bounds(self):
        """Workspace-bounds params, or None when unbounded."""
        v = self.params.view
        return (None if v.workspace_bounds_type
                == view_ops.WorkspaceBoundsType.UNBOUNDED else v)

    def _tensor(self, x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

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
        self.state = _integrate_frame(
            self.state, self.channels["tsdf_distance"],
            self.channels["tsdf_weight"], self.dirty, self.esdf_dirty,
            depth, T_L_C, mask_t, camera=camera,
            voxel_size_m=self.voxel_size_m, params=self.params.projective,
            max_blocks=self.max_blocks_per_frame, mask_mode=mm,
            view_params=self._view_bounds())

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
            self.state, self.channels["tsdf_distance"],
            self.channels["tsdf_weight"],
            torch.as_tensor(r_lo, dtype=torch.int32, device=dev),
            dims_b=dims_b, band=band, voxel_size_m=self.voxel_size_m,
            esdf_params=self.params.esdf)
        # Splice the compute region's blocks into the persistent channel.
        bi = self.state.block_index_of_slot
        lo = torch.as_tensor(c_lo, dtype=torch.int32, device=dev)
        hi = torch.as_tensor(c_hi, dtype=torch.int32, device=dev)
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
                      esdf_region=None, slot_bucket: int = 0) -> None:
        """Replay N depth frames (the offline / benchmarking loop).

        Every frame is integrated; every `esdf_every` frames the ESDF is
        re-solved over a fixed region, `esdf_region=(origin_blocks,
        dims_blocks)` or by default the current AABB + margin. The loop
        makes no host sync once `depths` and `T_L_Cs` are on the device.
        Mesh and color cadences belong to later slices and raise here.

        `slot_bucket` (optional) restricts the ESDF's pool-shaped stages
        (site extraction, seeding, gather, channel writes) to the pool
        prefix `[:slot_bucket]`. Allocation is prefix-dense (recycling
        keeps the high-water mark), so this is exact while the replay's
        final `alloc_count` stays within the bucket; `check_slot_bucket()`
        verifies that after the replay (one readback, outside any timing).
        """
        if mesh_every or color_every or colors is not None:
            raise NotImplementedError(
                "replay_frames: mesh and color cadences are not ported yet")
        depths = self._tensor(depths, torch.float32)
        T_L_Cs = self._tensor(T_L_Cs, torch.float32)
        run_esdf = esdf_every > 0
        if run_esdf:
            origin, dims = (self.esdf_region() if esdf_region is None
                            else esdf_region)
            dims = tuple(int(d) for d in dims)
            origin_t = device_ints(origin, torch.int32, self.device)
        ch = self.channels
        sb = slot_bucket if 0 < slot_bucket < self.capacity else self.capacity
        for k in range(depths.shape[0]):
            self.state = _integrate_frame(
                self.state, ch["tsdf_distance"], ch["tsdf_weight"],
                self.dirty, self.esdf_dirty, depths[k], T_L_Cs[k],
                camera=camera, voxel_size_m=self.voxel_size_m,
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
        if run_esdf and sb < self.capacity:
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

    # ---------------------------------------------------------------- state
    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The allocator state and the channels as numpy arrays, under the
        reference DeviceMapper's names (WorldGridState fields + channels)."""
        out = self.state.to_numpy()
        out.update({k: v.cpu().numpy() for k, v in self.channels.items()})
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
        self.dirty.zero_()
        self.esdf_dirty.zero_()
        self._aabb_lo = self._aabb_hi = None
        self._dirty_lo = self._dirty_hi = None
        self._region_unknown = True
        self._esdf_has_full = False
