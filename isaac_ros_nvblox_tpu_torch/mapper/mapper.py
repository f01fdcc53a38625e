"""Mapper: the host-table debug backend (port of
isaac_ros_nvblox_tpu/mapper/mapper.py).

Reference: nvblox `Mapper` (nvblox/mapper/mapper.h) owns the TSDF, color,
occupancy, ESDF, freespace and mesh layers over one block set and exposes
`integrateDepth`, `integrateColor`, `updateEsdf`, `updateColorMesh`, decay
and clearing.

All voxel layers share one BlockTable + BlockPool (`core/block_pool.py`):
each `integrate*` call is the view test (device), the allocation (a host
dict; the view is read back) and the fusion (device) over the batch of
slots, padded to a power-of-two bucket with the slot `capacity` (dropped).
Depth goes through `integrate_tsdf_cuda` (kernel tsdf_fuse on the card,
the plain `ops/tsdf.py::integrate_tsdf` on the CPU); color, occupancy,
freespace, the iterative ESDF (`ops/esdf.py::update_esdf`) and the f32
marching cubes (`ops/mesh.py::mesh_dirty_blocks`) are the reference's
functions in plain PyTorch on the mapper's device. Meshing tracks dirty
blocks: those a frame touched and their -x/-y/-z neighbours, whose
marching-cubes halo overlaps them.

The production path is `mapper/device_mapper.py`; this backend syncs with
the host at every allocation by design.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.block_pool import (NEIGHBOR_OFFSETS,
                                                        BlockPool, BlockTable,
                                                        pad_to_bucket)
from isaac_ros_nvblox_tpu_torch.core.types import (block_size_m,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.mapper.params import (MapperParams,
                                                      ProjectiveLayerType)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
from isaac_ros_nvblox_tpu_torch.ops import view as view_ops
from isaac_ros_nvblox_tpu_torch.ops.color import integrate_color as color_fn
from isaac_ros_nvblox_tpu_torch.ops.decay import (
    deallocate_fully_decayed_blocks, decay_occupancy, decay_tsdf)
from isaac_ros_nvblox_tpu_torch.ops.freespace import update_freespace
from isaac_ros_nvblox_tpu_torch.ops.mesh import MeshLayer, mesh_dirty_blocks
from isaac_ros_nvblox_tpu_torch.ops.occupancy import integrate_occupancy
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda
from isaac_ros_nvblox_tpu_torch.utils.timing import Timer

# The neighbours whose marching-cubes halo reaches a block: dx, dy, dz <= 0.
_MESH_HALO_COLS = [n for n, (dx, dy, dz) in enumerate(NEIGHBOR_OFFSETS.tolist())
                   if dx <= 0 and dy <= 0 and dz <= 0]


class Mapper:
    """One map: shared block pool + all integrators, on `device` (`cuda`
    unless the caller asks for another).

    `enable_*` flags choose the channels (the dynamic foreground mapper
    needs occupancy only; the static TSDF mapper tsdf/color/esdf/freespace).
    """

    def __init__(self, voxel_size_m: float,
                 params: Optional[MapperParams] = None,
                 projective_layer: ProjectiveLayerType = ProjectiveLayerType.TSDF,
                 capacity: int = 16384,
                 enable_color: bool = True,
                 enable_esdf: bool = True,
                 enable_freespace: bool = False,
                 name: str = "mapper",
                 device=None):
        self.name = name
        self.voxel_size_m = float(voxel_size_m)
        self.params = params or MapperParams()
        self.projective_layer = projective_layer
        self.table = BlockTable(capacity)

        specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        init: Dict[str, float] = {}
        if projective_layer == ProjectiveLayerType.TSDF:
            specs["tsdf_distance"] = ((), torch.float32)
            specs["tsdf_weight"] = ((), torch.float32)
        else:
            specs["occupancy_log_odds"] = ((), torch.float32)
            specs["occupancy_observed"] = ((), torch.uint8)
        if enable_color:
            specs["color_rgb"] = ((3,), torch.float32)
            specs["color_weight"] = ((), torch.float32)
        if enable_esdf:
            specs["esdf_site"] = ((3,), torch.float32)
            specs["esdf_sq_dist"] = ((), torch.float32)
            init["esdf_sq_dist"] = esdf_ops.INF_SQ
            specs["esdf_is_site"] = ((), torch.bool)
            specs["esdf_is_inside"] = ((), torch.bool)
            specs["esdf_observed"] = ((), torch.bool)
        if enable_freespace:
            specs["freespace_consecutive_ms"] = ((), torch.float32)
            specs["freespace_last_occupied_ms"] = ((), torch.float32)
            init["freespace_last_occupied_ms"] = -1e9
            specs["freespace_high_confidence"] = ((), torch.bool)

        self.pool = BlockPool(self.table, specs, init, device=device)
        self.device = self.pool.device
        self.mesh_layer = MeshLayer(self.voxel_size_m, self.params.mesh)
        self.last_meshed_keys: list = []
        self._mesh_dirty: Set[int] = set()       # slots
        self._cleared_blocks: list = []           # indices removed since last mesh
        self._last_freespace_update_ms: float = 0.0
        self.last_depth_T_L_C: Optional[np.ndarray] = None
        self.last_depth_camera: Optional[Camera] = None

    # ------------------------------------------------------------ allocation
    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype).contiguous()
        return torch.tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _padded_batch(self, slots: np.ndarray, indices: np.ndarray
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(slots, block indices) padded to a bucket; padding slots are the
        capacity (dropped by the scatters)."""
        n_pad = pad_to_bucket(len(slots))
        slots_p = np.full((n_pad,), self.table.capacity, np.int32)
        slots_p[:len(slots)] = slots
        idx_p = np.zeros((n_pad, 3), np.int32)
        idx_p[:len(slots)] = indices
        return (self._tensor(slots_p, torch.int32),
                self._tensor(idx_p, torch.int32))

    def _allocate_view(self, depth, T_L_C, camera: Camera,
                       max_distance_m: float, truncation_m: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        idx = view_ops.blocks_in_view(
            depth, T_L_C, camera=camera, voxel_size_m=self.voxel_size_m,
            max_distance_m=max_distance_m, truncation_m=truncation_m,
            params=self.params.view)
        self.pool.ensure_capacity(needed_free=len(idx))
        slots, fresh = self.table.allocate(idx)
        if fresh.any():
            self.pool.reset_slots(slots[fresh])
        slots_d, idx_d = self._padded_batch(slots, idx)
        return slots_d, idx_d, slots

    # ------------------------------------------------------------- integrate
    def integrate_depth(self, depth, T_L_C, camera: Camera) -> int:
        """Fuse a depth frame into the projective layer. Returns #blocks."""
        p = self.params.projective
        depth = self._tensor(depth)
        T_L_C = self._tensor(T_L_C)
        with Timer(f"{self.name}/integrate_depth/allocate"):
            slots_d, idx_d, slots = self._allocate_view(
                depth, T_L_C, camera, p.max_integration_distance_m,
                p.truncation_m(self.voxel_size_m))
        with Timer(f"{self.name}/integrate_depth/kernel"):
            if self.projective_layer == ProjectiveLayerType.TSDF:
                integrate_tsdf_cuda(
                    self.pool["tsdf_distance"], self.pool["tsdf_weight"],
                    slots_d, idx_d, depth, T_L_C, camera=camera,
                    voxel_size_m=self.voxel_size_m, params=p)
            else:
                integrate_occupancy(
                    self.pool["occupancy_log_odds"],
                    self.pool["occupancy_observed"],
                    slots_d, idx_d, depth, T_L_C, camera=camera,
                    voxel_size_m=self.voxel_size_m,
                    params=self.params.occupancy)
        self._mark_mesh_dirty(slots)
        self.last_depth_T_L_C = T_L_C.cpu().numpy()
        self.last_depth_camera = camera
        return int(len(slots))

    def integrate_color(self, color_image, T_L_C, camera: Camera,
                        depth=None) -> int:
        """Fuse a color frame onto the surface voxels of the allocated
        blocks in its view (no allocation). Returns #blocks."""
        if "color_rgb" not in self.pool.channels:
            return 0
        if self.projective_layer != ProjectiveLayerType.TSDF:
            raise ValueError("color integration requires a TSDF layer")
        p = self.params.projective
        T_L_C = self._tensor(T_L_C)
        if not isinstance(color_image, torch.Tensor):
            color_image = torch.from_numpy(np.ascontiguousarray(color_image))
        color_image = color_image.to(self.device)
        if depth is None:
            depth = torch.zeros((1, 1), device=self.device)  # no occlusion test
        else:
            depth = self._tensor(depth)
        if depth.shape[0] > 1:
            view_depth = depth
        else:
            view_depth = torch.full((camera.height, camera.width),
                                    float(p.max_integration_distance_m),
                                    device=self.device)
        idx_view = view_ops.blocks_in_view(
            view_depth, T_L_C, camera=camera, voxel_size_m=self.voxel_size_m,
            max_distance_m=p.max_integration_distance_m,
            truncation_m=p.truncation_m(self.voxel_size_m),
            params=self.params.view)
        slots_np = np.asarray(
            [self.table.slot_of(tuple(b)) for b in idx_view.tolist()],
            np.int32)
        keep = slots_np >= 0
        slots_np = slots_np[keep]
        if slots_np.size == 0:
            return 0
        slots_d, idx_d = self._padded_batch(slots_np, idx_view[keep])
        with Timer(f"{self.name}/integrate_color/kernel"):
            color_fn(self.pool["color_rgb"], self.pool["color_weight"],
                     self.pool["tsdf_distance"], self.pool["tsdf_weight"],
                     slots_d, idx_d, color_image, depth, T_L_C, camera=camera,
                     voxel_size_m=self.voxel_size_m, params=p)
        self._mark_mesh_dirty(slots_np)
        return int(slots_np.size)

    def update_freespace(self, time_ms: float, T_L_C=None,
                         camera: Optional[Camera] = None) -> None:
        """Update the freespace layer from the current TSDF + last view."""
        if "freespace_consecutive_ms" not in self.pool.channels:
            return
        T_L_C = T_L_C if T_L_C is not None else self.last_depth_T_L_C
        camera = camera or self.last_depth_camera
        if T_L_C is None or camera is None:
            return
        slots_np = self.table.allocated_slots()
        if slots_np.size == 0:
            return
        slots_d, idx_d = self._padded_batch(
            slots_np, self.table.block_indices[slots_np])
        update_freespace(
            self.pool["freespace_consecutive_ms"],
            self.pool["freespace_last_occupied_ms"],
            self.pool["freespace_high_confidence"],
            self.pool["tsdf_distance"], self.pool["tsdf_weight"],
            slots_d, idx_d, self._tensor(T_L_C),
            torch.full((), float(time_ms), device=self.device),
            torch.full((), float(self._last_freespace_update_ms),
                       device=self.device),
            camera=camera, voxel_size_m=self.voxel_size_m,
            params=self.params.freespace)
        self._last_freespace_update_ms = time_ms

    # ----------------------------------------------------------------- esdf
    def update_esdf(self) -> int:
        """Recompute the ESDF from the projective layer. Returns #sweeps."""
        if "esdf_site" not in self.pool.channels:
            return 0
        sites_from = ("tsdf" if self.projective_layer == ProjectiveLayerType.TSDF
                      else "occupancy")
        with Timer(f"{self.name}/update_esdf"):
            return esdf_ops.update_esdf(
                self.pool, self.table, voxel_size_m=self.voxel_size_m,
                params=self.params.esdf, sites_from=sites_from)

    # ----------------------------------------------------------------- mesh
    def _mark_mesh_dirty(self, slots: np.ndarray) -> None:
        self._mesh_dirty.update(int(s) for s in slots)

    def update_mesh(self, update_full_layer: bool = False) -> int:
        """Marching cubes over dirty blocks (updateColorMesh). Returns the
        number of blocks re-meshed."""
        if self.projective_layer != ProjectiveLayerType.TSDF:
            return 0
        if update_full_layer:
            dirty = set(int(s) for s in self.table.allocated_slots())
        else:
            # A block's mesh reads the +1 halo, so blocks whose halo
            # overlaps a dirty block (its -1-side neighbours) are dirty too.
            dirty = set(self._mesh_dirty)
            for s in self._mesh_dirty:
                for ns in self.table.neighbors[s, _MESH_HALO_COLS].tolist():
                    if ns >= 0:
                        dirty.add(ns)
        dirty &= set(int(s) for s in self.table.allocated_slots())
        if self._cleared_blocks:
            self.mesh_layer.remove_blocks(self._cleared_blocks)
            self._cleared_blocks = []
        if not dirty:
            self.last_meshed_keys = []
            return 0
        order = np.asarray(sorted(dirty), np.int32)
        with Timer(f"{self.name}/update_mesh"):
            mesh_dirty_blocks(self.mesh_layer, self.pool, self.table, order)
        self.last_meshed_keys = [
            tuple(k) for k in self.table.block_indices[order].tolist()]
        self._mesh_dirty.clear()
        return len(dirty)

    # ---------------------------------------------------------------- decay
    def decay_tsdf(self) -> int:
        """Decay TSDF weights; frees the fully decayed blocks."""
        if self.projective_layer != ProjectiveLayerType.TSDF:
            return 0
        T = (self._tensor(self.last_depth_T_L_C)
             if self.last_depth_T_L_C is not None
             else torch.eye(4, device=self.device))
        d, w, block_max = decay_tsdf(
            self.pool["tsdf_distance"], self.pool["tsdf_weight"],
            self._tensor(self.table.block_indices, torch.int32), T,
            params=self.params.tsdf_decay, voxel_size_m=self.voxel_size_m,
            camera=self.last_depth_camera)
        self.pool["tsdf_distance"] = d
        self.pool["tsdf_weight"] = w
        n = deallocate_fully_decayed_blocks(
            self.pool, self.table, block_max.cpu().numpy(),
            self.params.tsdf_decay.decayed_weight_threshold)
        if n:
            self._note_deallocations()
        return n

    def decay_occupancy(self) -> int:
        if "occupancy_log_odds" not in self.pool.channels:
            return 0
        lo, block_max = decay_occupancy(
            self.pool["occupancy_log_odds"],
            params=self.params.occupancy_decay)
        self.pool["occupancy_log_odds"] = lo
        n = deallocate_fully_decayed_blocks(
            self.pool, self.table, block_max.cpu().numpy(), threshold=1e-3)
        if n:
            self._note_deallocations()
        return n

    def _note_deallocations(self) -> None:
        # Blocks may have vanished: remember them for the mesh layer.
        live = set(map(tuple, self.table.allocated_block_indices().tolist()))
        gone = [k for k in self.mesh_layer.blocks if k not in live]
        self._cleared_blocks.extend(gone)

    # ------------------------------------------------------------- clearing
    def clear_outside_radius(self, center_m, radius_m: float) -> int:
        """Free the blocks wholly outside a sphere (clearOutsideRadius,
        nvblox_node.cpp:1566-1583). Returns the count."""
        idx = self.table.allocated_block_indices()
        if idx.size == 0:
            return 0
        bs = block_size_m(self.voxel_size_m)
        centers = (idx.astype(np.float64) + 0.5) * bs
        dist = np.linalg.norm(centers - np.asarray(center_m), axis=1)
        # Keep blocks whose nearest corner could be inside the radius.
        margin = bs * np.sqrt(3) / 2
        gone = idx[dist - margin > radius_m]
        if gone.size == 0:
            return 0
        keys = [tuple(k) for k in gone.tolist()]
        slots = np.asarray([self.table.slot_of(k) for k in keys], np.int32)
        self.table.free(keys)
        self.pool.reset_slots(slots)
        self._cleared_blocks.extend(keys)
        return len(keys)

    def clear_tsdf_inside_shapes(self, spheres=(), aabbs=()) -> None:
        """Set the TSDF to free space (truncation distance, weight 1)
        inside spheres ((cx, cy, cz), r) and boxes ((lo xyz), (hi xyz))
        (clearTsdfInsideShapes, nvblox_node.cpp:1834)."""
        slots_np = self.table.allocated_slots()
        if slots_np.size == 0:
            return
        centers = voxel_centers_for_blocks(
            self._tensor(self.table.block_indices[slots_np], torch.int32),
            self.voxel_size_m)
        inside = torch.zeros(centers.shape[:2], dtype=torch.bool,
                             device=self.device)
        for c, r in spheres:
            d = torch.linalg.norm(centers - self._tensor(c), dim=-1)
            inside = inside | (d <= r)
        for lo, hi in aabbs:
            inside = inside | torch.all((centers >= self._tensor(lo))
                                        & (centers <= self._tensor(hi)),
                                        dim=-1)
        trunc = self.params.projective.truncation_m(self.voxel_size_m)
        s = self._tensor(slots_np, torch.int64)
        for name, value in (("tsdf_distance", trunc), ("tsdf_weight", 1.0)):
            ch = self.pool[name]
            ch[s] = torch.where(inside, torch.full((), float(np.float32(value)),
                                                   device=self.device), ch[s])
        self._mark_mesh_dirty(slots_np)
