"""ShardedDeviceMapper: the device-resident mapper split into spatial tiles
over a shard mesh (port of isaac_ros_nvblox_tpu/parallel/sharded_mapper.py).

Decomposition:
  * the world grid (Dx, Dy, Dz blocks) splits into a `shard_grid = (nx, ny)`
    grid of tiles of (Lx, Ly) owned block columns; a shard's local grid is
    (Lx + 2, Ly + 2, Dz), one ghost layer per side (the mesh halo and the
    integration overlap), shard s = sx * ny + sy;
  * per-shard state is a list over the mesh's local shards
    (`parallel/spatial.py`): `state[i]`, `channels[name][i]`, `dirty[i]`,
    `esdf_dirty[i]`, each on its shard's device and updated in place;
  * frames are broadcast; a host frustum-ball-vs-tile test (`_view_flags`)
    skips the shards a frame cannot touch, and each flagged shard runs the
    single-device frame step (mapper/device_mapper.py) on its own pool, so
    the frame steps make no host sync when poses come from the host;
  * ESDF: the exact dense separable EDT (ops/esdf_dense.py, kernels
    edt_pass1 / edt_pass) per tile over its owned columns plus ceil(band/8)
    halo blocks per inner side. Site bits (u8) arrive in two `ppermute`
    steps, y first, then x of the y-extended slab, which carries the
    diagonal corners. Every owned block's squared distance equals a single
    device's solve bit for bit (a distance depends only on the sites
    within `band` of it). The skip is decided on the host: the update runs
    when any frame flagged a shard since the last one (or a decay, a load,
    a device-tensor pose), a flag OR'd over processes by the mesh;
  * occupancy and TSDF / occupancy decay with slot recycling per shard;
  * meshing per shard over its dirty owned blocks (kernel marching_cubes;
    the ghost ring supplies the +1 halo); the host gathers owned-block
    triangle soup.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch import native
from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import (VOXELS_PER_BLOCK,
                                                   VOXELS_PER_SIDE,
                                                   device_ints,
                                                   set_rows_drop)
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as dm
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops import decay as decay_ops
from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
from isaac_ros_nvblox_tpu_torch.ops.detect_cuda import detect_dynamic
from isaac_ros_nvblox_tpu_torch.ops.mesh_cuda import (local_to_world_verts,
                                                      marching_cubes_fused,
                                                      resolve_edge_soup)
from isaac_ros_nvblox_tpu_torch.parallel.spatial import SpatialMesh

B = VOXELS_PER_SIDE
V = VOXELS_PER_BLOCK
_COLOR = ("color_r", "color_g", "color_b", "color_weight")


@dataclasses.dataclass(frozen=True)
class ShardedMapperConfig:
    n_shards: int = 8
    # Spatial decomposition (nx, ny); None = 1-D x-slabs (n_shards, 1).
    shard_grid: Optional[Tuple[int, int]] = None
    # Global world extent in blocks (x by nx, y by ny must divide evenly).
    global_dims: Tuple[int, int, int] = (64, 32, 16)
    origin_block: Tuple[int, int, int] = (-32, -16, -4)
    capacity_per_shard: int = 4096
    voxel_size_m: float = 0.05
    max_blocks_per_frame: int = 1024
    mesh_max_blocks: int = 512
    enable_color: bool = False
    enable_occupancy: bool = False
    enable_freespace: bool = False

    @property
    def grid(self) -> Tuple[int, int]:
        g = self.shard_grid or (self.n_shards, 1)
        if g[0] * g[1] != self.n_shards:
            raise ValueError(f"shard_grid {g} != n_shards {self.n_shards}")
        return g

    @property
    def tile_dims(self) -> Tuple[int, int]:
        nx, ny = self.grid
        if self.global_dims[0] % nx or self.global_dims[1] % ny:
            raise ValueError(
                f"global extent {self.global_dims[:2]} must divide evenly "
                f"into the {self.grid} shard grid")
        if self.global_dims[1] % 8 or self.global_dims[2] % 8:
            raise ValueError("global y/z extents must be multiples of 8 "
                             "blocks (EDT pass-kernel block constraint)")
        return (self.global_dims[0] // nx, self.global_dims[1] // ny)

    @property
    def slab_width(self) -> int:
        """Owned x width per shard (the 1-D decomposition's name)."""
        return self.tile_dims[0]


class ShardedDeviceMapper:
    def __init__(self, mesh: SpatialMesh, camera: Camera,
                 config: Optional[ShardedMapperConfig] = None,
                 params: Optional[MapperParams] = None):
        self.mesh = mesh
        self.camera = camera
        self.config = config or ShardedMapperConfig(n_shards=mesh.n_shards)
        self.params = params or MapperParams()
        c = self.config
        if c.n_shards != mesh.n_shards:
            raise ValueError(f"config.n_shards {c.n_shards} != mesh size "
                             f"{mesh.n_shards}")
        Lx, Ly = c.tile_dims
        cap = c.capacity_per_shard
        self.local_shards = list(mesh.local_shards)
        self.state: List[wg.WorldGridState] = []
        self.channels: Dict[str, List[torch.Tensor]] = {}
        self.dirty: List[torch.Tensor] = []
        self.esdf_dirty: List[torch.Tensor] = []
        shape = (cap, V)
        names = {"tsdf_distance": (torch.float32, 0.0),
                 "tsdf_weight": (torch.float32, 0.0),
                 "esdf_sq_dist": (torch.float32, esdf_ops.INF_SQ)}
        if c.enable_color:
            names.update({k: (torch.float32, 0.0) for k in _COLOR})
        if c.enable_occupancy:
            names["occupancy_log_odds"] = (torch.float32, 0.0)
            names["occupancy_observed"] = (torch.uint8, 0)
        if c.enable_freespace:
            names["freespace_consecutive_ms"] = (torch.float32, 0.0)
            names["freespace_last_occupied_ms"] = (torch.float32, -1e9)
            names["freespace_high_confidence"] = (torch.bool, False)
        self.channels = {k: [] for k in names}
        for s in self.local_shards:
            dev = mesh.device_of(s)
            sx, sy = self._tile_of(s)
            origin = (c.origin_block[0] + sx * Lx - 1,
                      c.origin_block[1] + sy * Ly - 1, c.origin_block[2])
            self.state.append(wg.create_world_grid(wg.WorldGridConfig(
                dims=(Lx + 2, Ly + 2, c.global_dims[2]), capacity=cap,
                origin_block=origin), dev))
            for k, (dtype, fill) in names.items():
                self.channels[k].append(
                    torch.full(shape, fill, dtype=dtype, device=dev))
            self.dirty.append(torch.zeros((cap,), dtype=torch.bool,
                                          device=dev))
            self.esdf_dirty.append(torch.zeros((cap,), dtype=torch.bool,
                                               device=dev))
        self._freespace_last_update_ms = [
            torch.zeros((), device=d) for d in mesh.local_devices]
        # Host skip flag of the ESDF update: set by every step that may
        # change the site set.
        self._esdf_pending = False

    # ------------------------------------------------------------- topology
    def _tile_of(self, s: int) -> Tuple[int, int]:
        return divmod(s, self.config.grid[1])

    def _perms(self, axis: str):
        """ppermute pairs along tile axis 'x' or 'y' (+ and - direction)."""
        nx, ny = self.config.grid
        fwd, bwd = [], []
        for s in range(self.config.n_shards):
            sx, sy = divmod(s, ny)
            if axis == "x":
                if sx + 1 < nx:
                    fwd.append((s, s + ny))
                    bwd.append((s + ny, s))
            elif sy + 1 < ny:
                fwd.append((s, s + 1))
                bwd.append((s + 1, s))
        return fwd, bwd

    def _view_flags(self, T_L_C) -> np.ndarray:
        """Host frustum-vs-tile test -> per-shard run flags i32[n_shards].

        Conservative ball test: a tile can see the frame iff its
        ghost-inclusive AABB meets the ball of radius max_integration
        (+ a block diagonal) around the camera origin. A pose given as a
        device tensor flags every shard."""
        c = self.config
        if isinstance(T_L_C, torch.Tensor):
            return np.ones((c.n_shards,), np.int32)
        Lx, Ly = c.tile_dims
        bs = c.voxel_size_m * B
        o = np.asarray(T_L_C, np.float64)[:3, 3]
        r = float(self.params.projective.max_integration_distance_m) \
            + bs * np.sqrt(3.0)
        flags = np.zeros((c.n_shards,), np.int32)
        for s in range(c.n_shards):
            sx, sy = self._tile_of(s)
            lo = np.asarray([(c.origin_block[0] + sx * Lx - 1) * bs,
                             (c.origin_block[1] + sy * Ly - 1) * bs,
                             c.origin_block[2] * bs])
            hi = lo + np.asarray([(Lx + 2) * bs, (Ly + 2) * bs,
                                  c.global_dims[2] * bs])
            d = np.maximum(np.maximum(lo - o, o - hi), 0.0)
            flags[s] = 1 if float(np.dot(d, d)) <= r * r else 0
        return flags

    # ------------------------------------------------------------- helpers
    def _per_device(self, x, dtype=torch.float32) -> Dict[torch.device,
                                                          torch.Tensor]:
        """`x` on each local device (`device_mapper._to_device`)."""
        return {dev: dm._to_device(x, dev, dtype)
                for dev in dict.fromkeys(self.mesh.local_devices)}

    def _each_flagged(self, flags):
        """(local index, device) of the local shards flagged; a flagged
        shard marks the ESDF for update."""
        if flags.any():
            self._esdf_pending = True
        return [(i, self.mesh.device_of(s))
                for i, s in enumerate(self.local_shards) if flags[s]]

    # ------------------------------------------------------------ integrate
    def integrate_depth(self, depth, T_L_C) -> None:
        """Fuse one depth frame into every shard it can touch: the
        single-device step (view grid -> allocate -> kernel tsdf_fuse ->
        dirty bits) per flagged shard; no host sync when T_L_C is a host
        array."""
        flags = self._view_flags(T_L_C)
        depths, Ts = self._per_device(depth), self._per_device(T_L_C)
        c, ch = self.config, self.channels
        for i, dev in self._each_flagged(flags):
            self.state[i] = dm._integrate_frame(
                self.state[i], ch["tsdf_distance"][i], ch["tsdf_weight"][i],
                self.dirty[i], self.esdf_dirty[i], depths[dev], Ts[dev],
                camera=self.camera, voxel_size_m=c.voxel_size_m,
                params=self.params.projective,
                max_blocks=c.max_blocks_per_frame)

    def integrate_depth_occupancy(self, depth, T_L_C) -> None:
        """Occupancy-layer integration on the shards (the single-device
        step per flagged shard, kernel occupancy_fuse)."""
        if "occupancy_log_odds" not in self.channels:
            raise ValueError("enable_occupancy=False")
        flags = self._view_flags(T_L_C)
        depths, Ts = self._per_device(depth), self._per_device(T_L_C)
        c, ch = self.config, self.channels
        for i, dev in self._each_flagged(flags):
            self.state[i] = dm._integrate_occupancy_frame(
                self.state[i], ch["occupancy_log_odds"][i],
                ch["occupancy_observed"][i], self.dirty[i],
                self.esdf_dirty[i], depths[dev], Ts[dev], camera=self.camera,
                voxel_size_m=c.voxel_size_m, params=self.params.occupancy,
                max_blocks=c.max_blocks_per_frame)

    def integrate_color(self, color, depth, T_L_C) -> None:
        """Fuse one color frame into the allocated blocks of its frustum
        on each shard it can touch: the single-device color step (no
        allocation; kernel color_fuse; the blocks marked mesh-dirty) per
        flagged shard, `depth` the occlusion depth. A mapper without color
        ignores it."""
        if "color_r" not in self.channels:
            return
        flags = self._view_flags(T_L_C)
        images = self._per_device(color, dm._image_dtype(color))
        depths, Ts = self._per_device(depth), self._per_device(T_L_C)
        c, ch = self.config, self.channels
        for i, s in enumerate(self.local_shards):
            if not flags[s]:
                continue
            dev = self.mesh.device_of(s)
            dm._integrate_color_frame(
                tuple(ch[k][i] for k in _COLOR), self.dirty[i],
                ch["tsdf_distance"][i], ch["tsdf_weight"][i], self.state[i],
                images[dev], depths[dev], Ts[dev], camera=self.camera,
                voxel_size_m=c.voxel_size_m, params=self.params.projective,
                max_blocks=c.max_blocks_per_frame)

    # ------------------------------------------------------------------ decay
    @torch.no_grad()
    def decay(self) -> None:
        """TSDF (+ occupancy) decay on every shard, then the fully decayed
        blocks are freed (at most min(1024, cap) a shard, lowest slots
        first) and their rows reset; their slots recycle."""
        c = self.config
        cap = c.capacity_per_shard
        pd, po = self.params.tsdf_decay, self.params.occupancy_decay
        ch = self.channels
        for i, state in enumerate(self.state):
            d, w, block_max_w = decay_ops.decay_tsdf(
                ch["tsdf_distance"][i], ch["tsdf_weight"][i],
                state.block_index_of_slot,
                torch.eye(4, device=state.alloc_count.device), params=pd,
                voxel_size_m=c.voxel_size_m, camera=None)
            ch["tsdf_distance"][i].copy_(d)
            ch["tsdf_weight"][i].copy_(w)
            dead = wg.live_slot_mask(state) & (
                block_max_w < float(np.float32(pd.decayed_weight_threshold)))
            if "occupancy_log_odds" in ch:
                lo, block_max = decay_ops.decay_occupancy(
                    ch["occupancy_log_odds"][i], params=po)
                ch["occupancy_log_odds"][i].copy_(lo)
                dead = dead & (block_max < float(np.float32(1e-3)))
            keys = dm._first_ids(dead, min(1024, cap))
            idx = torch.where(keys < dm._BIG, keys, -1)
            self.state[i] = wg.free_slots(state, idx)
            safe = torch.where(idx >= 0, idx, cap)
            for name, rows in ch.items():
                set_rows_drop(rows[i], safe, esdf_ops.INF_SQ
                              if name == "esdf_sq_dist" else 0)
            set_rows_drop(self.dirty[i], safe, False)
            # Freed blocks change the site set: their region re-solves.
            set_rows_drop(self.esdf_dirty[i], safe, True)
        self._esdf_pending = True

    # ----------------------------------------------------------------- esdf
    @property
    def esdf_band_vox(self) -> int:
        return int(np.ceil(self.params.esdf.max_esdf_distance_m
                           / self.config.voxel_size_m))

    def _halo(self) -> Tuple[int, int]:
        """Halo blocks per inner side (hx, hy): ceil(band/8) where the axis
        is split, else 0."""
        nx, ny = self.config.grid
        hb = (self.esdf_band_vox + 7) // 8
        return (hb if nx > 1 else 0), (hb if ny > 1 else 0)

    def _site_tiles(self) -> List[torch.Tensor]:
        """Each local shard's owned-tile site bits u8[Lx, Ly, Dz, 512]: the
        halo exchange ships site bits, not f32 seeds (the seed field is
        binary), a quarter of the bytes."""
        c = self.config
        Lx, Ly = c.tile_dims
        cap = c.capacity_per_shard
        ep = self.params.esdf
        out = []
        for i, state in enumerate(self.state):
            is_site, _, _ = esdf_ops.esdf_sites_from_tsdf(
                self.channels["tsdf_distance"][i],
                self.channels["tsdf_weight"][i],
                voxel_size_m=c.voxel_size_m,
                max_site_distance_vox=float(ep.max_site_distance_vox),
                min_weight=float(ep.min_weight))
            slots = state.slot_grid[1:Lx + 1, 1:Ly + 1, :]
            data = is_site[slots.clamp(0, cap - 1).long()]
            out.append((data & (slots >= 0)[..., None]).to(torch.uint8))
        return out

    def _exchange_halos(self, tiles: List[torch.Tensor]) -> List[torch.Tensor]:
        """Site tiles extended by the halos: y first, then x of the
        y-extended slabs (which carry the diagonal corners). A shard on
        the world's edge receives zeros (no sites) there."""
        Lx, Ly = self.config.tile_dims
        hx, hy = self._halo()
        mesh = self.mesh
        # (collectives, bytes moved between shards) of the last exchange.
        self.last_exchange = (0, 0)
        if hy:
            up, dn = self._perms("y")
            from_dn = mesh.ppermute([t[:, Ly - hy:] for t in tiles], up)
            from_up = mesh.ppermute([t[:, :hy] for t in tiles], dn)
            self.last_exchange = (2, (len(up) + len(dn))
                                  * from_dn[0].numel())
            tiles = [torch.cat([a, t, b], 1)
                     for a, t, b in zip(from_dn, tiles, from_up)]
        if hx:
            right, left = self._perms("x")
            from_l = mesh.ppermute([t[Lx - hx:] for t in tiles], right)
            from_r = mesh.ppermute([t[:hx] for t in tiles], left)
            n, nbytes = self.last_exchange
            self.last_exchange = (n + 2, nbytes + (len(right) + len(left))
                                  * from_l[0].numel())
            tiles = [torch.cat([a, t, b], 0)
                     for a, t, b in zip(from_l, tiles, from_r)]
        return tiles

    def _region_seeds(self, i: int, S: torch.Tensor):
        """Local shard i's ESDF region from its halo-extended site tile
        `S` (u8[Sx, Sy, Dz, 512]): (seeds f32[Sx*8, Sy*8, Dz*8], 0 at
        sites, INF elsewhere; origin_b i32[3], the world block of region
        cell 0: the owned tile's first cell minus the halo; dims_b)."""
        hx, hy = self._halo()
        Sx, Sy, Dz = S.shape[:3]
        dev = S.device
        seeds = torch.where(
            S.view(Sx, Sy, Dz, B, B, B).permute(0, 3, 1, 4, 2, 5)
            .reshape(Sx * B, Sy * B, Dz * B) > 0,
            torch.zeros((), device=dev),
            torch.full((), float(ed.INF), device=dev))
        origin_b = self.state[i].origin_block + device_ints(
            (1 - hx, 1 - hy, 0), torch.int32, dev)
        return seeds, origin_b, (Sx, Sy, Dz)

    @torch.no_grad()
    def update_esdf(self) -> None:
        """The sharded exact ESDF: site tiles, the two-step halo exchange,
        then per shard the dense solve over its region (kernels edt_pass1,
        edt_pass) gathered back to its live slots. Skipped when nothing
        changed since the last update (a host flag, OR'd over processes)."""
        if not self.mesh.any_host(self._esdf_pending):
            return
        band = self.esdf_band_vox
        tiles = self._exchange_halos(self._site_tiles())
        for i, (state, S) in enumerate(zip(self.state, tiles)):
            seeds, origin_b, dims_b = self._region_seeds(i, S)
            in_region, row = ed.region_rows(state.block_index_of_slot,
                                            state.alloc_count, origin_b,
                                            dims_b)
            solved = ed.solve_region(seeds, band,
                                     ed.needed_masks(row, dims_b, band))
            self.channels["esdf_sq_dist"][i].copy_(
                ed.gather_slots(solved, in_region, row, band))
            self.esdf_dirty[i].zero_()
        self._esdf_pending = False

    # ----------------------------------------------------------------- mesh
    def _owned(self, state) -> torch.Tensor:
        """bool[cap]: the slot's block lies in the shard's owned tile."""
        Lx, Ly = self.config.tile_dims
        local = state.block_index_of_slot - state.origin_block
        return ((local[:, 0] >= 1) & (local[:, 0] <= Lx)
                & (local[:, 1] >= 1) & (local[:, 1] <= Ly))

    @torch.no_grad()
    def update_mesh_dirty(self):
        """Incremental marching cubes over each shard's dirty owned blocks
        and their -1-side neighbours (kernel marching_cubes, halo rows read
        in place); the owned dirty bits clear. No host sync.

        Returns per local shard (verts bf16[mb, 3, 16, 512] block-local
        voxel units, SENTINEL in empty slots; colors bf16 | None; mask
        bool[mb, 16, 512]; block indices i32[mb, 3]; slots i32[mb],
        padding = capacity); `export_mesh_blocks` gathers them."""
        c = self.config
        cap = c.capacity_per_shard
        with_color = "color_r" in self.channels
        min_w = float(self.params.mesh.min_weight)
        out = []
        for i, state in enumerate(self.state):
            owned = self._owned(state)
            slots, bidx = dm._compact_dirty_impl(
                state, self.dirty[i] & owned, max_blocks=c.mesh_max_blocks)
            nbr8 = wg.neighbor_slots8_of(state, bidx)
            verts_e, colors_e, table = marching_cubes_fused(
                self.channels["tsdf_distance"][i],
                self.channels["tsdf_weight"][i],
                (tuple(self.channels[k][i] for k in _COLOR[:3])
                 if with_color else None),
                nbr8, (slots < cap).to(torch.int32), min_weight=min_w,
                with_color=with_color)
            verts, colors = resolve_edge_soup(verts_e, colors_e, table,
                                              with_color=with_color)
            self.dirty[i] &= ~owned
            out.append((verts, colors, verts[:, 0] >= 0, bidx, slots))
        return out

    def export_mesh_blocks(self):
        """Host: the owned-block triangle soup of this process's shards,
        {block key: (verts f32[T, 3, 3] meters, colors f32[T, 3, 3])}."""
        cap = self.config.capacity_per_shard
        out = {}
        for verts, colors, mask, bidx, slots in self.update_mesh_dirty():
            world, mask = local_to_world_verts(verts, bidx,
                                               self.config.voxel_size_m)
            cols = (torch.zeros_like(world) if colors is None
                    else colors.float())
            world_np, cols_np, mask_np, bidx_np, slots_np = (
                t.cpu().numpy() for t in (world, cols, mask, bidx, slots))
            offsets, v_flat, c_flat = native.compact_mesh_blocks(
                world_np, cols_np, mask_np)
            for j in range(bidx_np.shape[0]):
                if slots_np[j] >= cap:
                    continue
                a, b = int(offsets[j]), int(offsets[j + 1])
                out[tuple(int(v) for v in bidx_np[j])] = (
                    v_flat[a:b].reshape(-1, 3, 3),
                    c_flat[a:b].reshape(-1, 3, 3))
        return out

    # ------------------------------------------------------ frame routing
    def integrate_frames_routed(self, depths, T_L_Cs) -> None:
        """Routed multi-camera ingestion: one frame per shard, passed
        around a ring of ppermutes (n - 1 hops). Each shard uploads only
        its own camera's frame; a visiting frame integrates where the host
        flag says its frustum can touch the tile, so the map equals n
        broadcast integrate_depth calls. depths [n, H, W], T_L_Cs
        [n, 4, 4] (host arrays)."""
        c = self.config
        n = c.n_shards
        T_L_Cs = np.asarray(T_L_Cs)
        if np.shape(depths)[0] != n or T_L_Cs.shape[0] != n:
            raise ValueError(f"routed ingestion takes {n} frames")
        flags = np.stack([self._view_flags(T) for T in T_L_Cs])
        poses = self._per_device(T_L_Cs)
        ch = self.channels
        cur = [dm._to_device(depths[s], self.mesh.device_of(s),
                             torch.float32) for s in self.local_shards]
        # Shard s passes its frame to s - 1: after k hops it holds the
        # frame that started at shard (s + k) mod n.
        ring = [(s, (s - 1) % n) for s in range(n)]
        for k in range(n):
            for i, s in enumerate(self.local_shards):
                fid = (s + k) % n
                if not flags[fid, s]:
                    continue
                self.state[i] = dm._integrate_frame(
                    self.state[i], ch["tsdf_distance"][i],
                    ch["tsdf_weight"][i], self.dirty[i], self.esdf_dirty[i],
                    cur[i], poses[self.mesh.device_of(s)][fid],
                    camera=self.camera, voxel_size_m=c.voxel_size_m,
                    params=self.params.projective,
                    max_blocks=c.max_blocks_per_frame)
            if k < n - 1:
                cur = self.mesh.ppermute(cur, ring)
        if flags.any():
            self._esdf_pending = True

    # ---------------------------------------------------------- freespace
    def update_freespace(self, T_L_C, time_ms: float) -> None:
        """The freespace state machine on every shard at `time_ms` (ms):
        the full-pool form over the shard's whole local grid, its
        26-neighbourhood check by the dense dilation (kernel dilate_dense)
        reading the ghost ring, which carries the neighbour's integrated
        data (frames integrate into ghosts on both owners)."""
        if "freespace_consecutive_ms" not in self.channels:
            raise ValueError("enable_freespace=False")
        c = self.config
        Lx, Ly = c.tile_dims
        dims_b = (Lx + 2, Ly + 2, c.global_dims[2])
        Ts = self._per_device(T_L_C)
        ch = self.channels
        for i, state in enumerate(self.state):
            dev = self.mesh.device_of(self.local_shards[i])
            t = torch.full((), float(time_ms), device=dev)
            dm._freespace_fused(
                ch["freespace_consecutive_ms"][i],
                ch["freespace_last_occupied_ms"][i],
                ch["freespace_high_confidence"][i], state,
                ch["tsdf_distance"][i], ch["tsdf_weight"][i], Ts[dev], t,
                self._freespace_last_update_ms[i], state.origin_block,
                camera=self.camera, voxel_size_m=c.voxel_size_m,
                params=self.params.freespace,
                view_distance_m=float(
                    self.params.projective.max_integration_distance_m),
                max_blocks=c.max_blocks_per_frame, dims_b=dims_b)
            self._freespace_last_update_ms[i] = t

    # ----------------------------------------------------------- dynamics
    def detect_dynamic(self, depth, T_L_C) -> torch.Tensor:
        """The global dynamic-pixel mask bool[H, W] (on the first local
        device): each shard tests the pixels whose points land in its
        tile against its high-confidence freespace (kernel
        detect_dynamic); a psum ORs the shards' masks."""
        if "freespace_high_confidence" not in self.channels:
            raise ValueError("enable_freespace=False")
        depths = self._per_device(depth)
        Ts = self._per_device(T_L_C)
        max_depth = float(self.params.projective.max_integration_distance_m)
        masks = []
        for i, state in enumerate(self.state):
            dev = self.mesh.device_of(self.local_shards[i])
            masks.append(detect_dynamic(
                state, self.channels["freespace_high_confidence"][i],
                depths[dev], Ts[dev], camera=self.camera,
                voxel_size_m=self.config.voxel_size_m,
                max_depth_m=max_depth, subsample=2).to(torch.int32))
        return self.mesh.psum(masks)[0] > 0

    def dynamic_tick(self, depth, T_L_C, time_ms: float) -> torch.Tensor:
        """The sharded dynamic-mode step: detect -> masked split ->
        background TSDF -> foreground occupancy -> freespace update
        (enable_freespace + enable_occupancy). Returns the dynamic mask."""
        depth = next(iter(self._per_device(depth).values()))
        mask = self.detect_dynamic(depth, T_L_C)
        zero = torch.zeros((), device=depth.device)
        self.integrate_depth(torch.where(mask, zero, depth), T_L_C)
        self.integrate_depth_occupancy(torch.where(mask, depth, zero), T_L_C)
        self.update_freespace(T_L_C, time_ms)
        return mask

    # -------------------------------------------------------------- lidar
    def integrate_lidar(self, range_image, T_L_S, lidar) -> None:
        """Sharded spherical (lidar) TSDF integration: the single-device
        lidar step (kernel tsdf_lidar_fuse) per flagged shard, the ball
        test of `_view_flags` around the sensor (scans are
        omnidirectional)."""
        flags = self._view_flags(T_L_S if isinstance(T_L_S, torch.Tensor)
                                 else np.asarray(T_L_S))
        rimgs, Ts = self._per_device(range_image), self._per_device(T_L_S)
        c, ch = self.config, self.channels
        for i, dev in self._each_flagged(flags):
            self.state[i] = dm._integrate_lidar_frame(
                self.state[i], ch["tsdf_distance"][i], ch["tsdf_weight"][i],
                self.dirty[i], self.esdf_dirty[i], rimgs[dev], Ts[dev],
                lidar=lidar, voxel_size_m=c.voxel_size_m,
                params=self.params.projective,
                max_blocks=c.max_blocks_per_frame)

    # ------------------------------------------------------- 2D slice/costmap
    @torch.no_grad()
    def slice_esdf_2d(self, height_m: float,
                      unknown_value: float = 1000.0) -> np.ndarray:
        """The global 2-D ESDF distance slice f32[X*8, Y*8] in meters at
        `height_m`: per-shard tiles of the owned columns, gathered and
        assembled on the host (publish cadence)."""
        c = self.config
        ny = c.grid[1]
        Lx, Ly = c.tile_dims
        cap = c.capacity_per_shard
        vs = c.voxel_size_m
        hvox = int(np.floor(height_m / vs)) - c.origin_block[2] * 8
        hvox = int(np.clip(hvox, 0, c.global_dims[2] * 8 - 1))
        bz, lz = divmod(hvox, 8)
        tiles = []
        for i, state in enumerate(self.state):
            slot_col = state.slot_grid[1:Lx + 1, 1:Ly + 1, bz]      # [Lx, Ly]
            rows = self.channels["esdf_sq_dist"][i][
                slot_col.clamp(0, cap - 1).long()]                # [Lx, Ly, 512]
            img = rows.view(Lx, Ly, 8, 8, 8)[..., lz].permute(
                0, 2, 1, 3).reshape(Lx * 8, Ly * 8)
            have = (slot_col >= 0).repeat_interleave(8, 0) \
                .repeat_interleave(8, 1)
            tiles.append(torch.where(have, img,
                                     torch.full((), float(ed.INF),
                                                device=img.device)))
        tiles = [t.cpu().numpy() for t in self.mesh.all_gather(tiles)]
        out = np.empty((c.global_dims[0] * 8, c.global_dims[1] * 8),
                       np.float32)
        for s, tile in enumerate(tiles):
            sx, sy = divmod(s, ny)
            out[sx * Lx * 8:(sx + 1) * Lx * 8,
                sy * Ly * 8:(sy + 1) * Ly * 8] = tile
        dist = np.sqrt(np.minimum(out, 1e12)) * vs
        return np.where(out >= float(ed.INF), unknown_value, dist)

    # ------------------------------------------------------------- queries
    def owned_block_mask(self, shard: int) -> np.ndarray:
        """Host: which of the allocated slots [0, alloc_count) of `shard`
        (a local shard) hold owned, live (not ghost, not freed) blocks."""
        i = self.local_shards.index(shard)
        state = self.state[i]
        count = int(state.alloc_count)
        bidx = state.block_index_of_slot[:count]
        owned = self._owned(state)[:count]
        return (owned & (bidx[:, 0] < wg.FREED_BLOCK_SENTINEL)).cpu().numpy()

    def total_owned_blocks(self) -> int:
        """Owned live blocks over every shard (summed over processes)."""
        return self.mesh.sum_host(sum(int(self.owned_block_mask(s).sum())
                                      for s in self.local_shards))

    # ---------------------------------------------------------------- state
    def state_arrays(self) -> Dict[str, np.ndarray]:
        """This process's shards in the reference's stacked layout: each
        WorldGridState field, channel and the dirty flags as numpy
        `[n_local, ...]` (all shards in one process), copied. Occupancy's
        observed flags are bool, as the reference keeps them."""
        per = [st.to_numpy() for st in self.state]
        out = {k: np.stack([p[k] for p in per]) for k in per[0]}
        for k, rows in self.channels.items():
            a = np.stack([r.cpu().numpy() for r in rows])
            out[k] = a.astype(bool) if k == "occupancy_observed" else a
        out["dirty"] = np.stack([d.cpu().numpy() for d in self.dirty])
        out["esdf_dirty"] = np.stack([d.cpu().numpy()
                                      for d in self.esdf_dirty])
        if "freespace_consecutive_ms" in self.channels:
            out["freespace_last_update_ms"] = np.asarray(
                float(self._freespace_last_update_ms[0]), np.float32)
        return out

    def load_state_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Load a sharded map in the stacked layout of `state_arrays`, or
        one built from the reference's ShardedDeviceMapper (`np.asarray`
        of its stacked WorldGridState fields, channels and dirty flags,
        same names). A leading dimension of n_shards is indexed by the
        global shard (the whole map, every process loads its own rows),
        one of the local shard count by the local position (this
        process's `state_arrays`); any other raises. Keys this mapper does
        not hold are ignored. The next update_esdf solves where any loaded
        esdf_dirty flag is set."""
        n = int(np.shape(arrays["alloc_count"])[0])
        if n == self.config.n_shards:
            rows = list(self.local_shards)
        elif n == len(self.local_shards):
            rows = list(range(n))
        else:
            raise ValueError(
                f"stacked arrays hold {n} shards; this mapper has "
                f"{self.config.n_shards} ({len(self.local_shards)} local)")
        for i, (s, r) in enumerate(zip(self.local_shards, rows)):
            dev = self.mesh.device_of(s)
            self.state[i] = wg.WorldGridState.from_numpy(
                {k: np.asarray(arrays[k])[r]
                 for k in wg.WorldGridState.__dataclass_fields__}, dev)
            for k, ch in self.channels.items():
                if k in arrays:
                    ch[i].copy_(torch.tensor(np.asarray(arrays[k])[r])
                                .to(ch[i].dtype))
            for k in ("dirty", "esdf_dirty"):
                if k in arrays:
                    getattr(self, k)[i].copy_(torch.tensor(
                        np.asarray(arrays[k])[r], dtype=torch.bool))
                else:
                    getattr(self, k)[i].zero_()
            self._freespace_last_update_ms[i] = torch.tensor(
                float(np.asarray(arrays.get("freespace_last_update_ms",
                                            0.0))), device=dev)
        self._esdf_pending = bool(np.asarray(
            arrays.get("esdf_dirty", False)).any())
