"""Marching-cubes mesh integrator (port of isaac_ros_nvblox_tpu/ops/mesh.py).

`marching_cubes_blocks` is the full-map meshing function that
`DeviceMapper.update_mesh_device` / `export_mesh` run (plain tensor ops,
as the reference leaves it to XLA): for a batch of blocks it gathers the
+1 halo, looks each cube's corner signs up in the 256-case table of
ops/mesh_tables.py and emits a fixed-capacity triangle soup
`[N, 512, MAX_TRIS, 3, 3]` with a validity mask. `MeshLayer` is the host
store of welded per-block meshes (the weld of the native host library,
`native.weld_mesh`, as the reference's layer welds with its own).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import VOXELS_PER_SIDE, fma
from isaac_ros_nvblox_tpu_torch.ops.halo import gather_halo
from isaac_ros_nvblox_tpu_torch.ops.mesh_tables import (CORNERS,
                                                        MAX_TRIS_PER_CUBE,
                                                        build_tables)
from isaac_ros_nvblox_tpu_torch.native import weld_mesh

B = VOXELS_PER_SIDE


@dataclasses.dataclass(frozen=True)
class MeshIntegratorParams:
    min_weight: float = 1e-4    # mesh_integrator_min_weight
    weld_vertices: bool = True  # mesh_integrator_weld_vertices


@torch.no_grad()
def marching_cubes_blocks(tsdf_grid, weight_grid, color_grid, neighbor_slots,
                          block_indices, *, voxel_size_m: float,
                          min_weight: float):
    """Extract triangles for a batch of blocks.

    Args:
      tsdf_grid, weight_grid: `[cap, 8, 8, 8]` grid views of the TSDF pool.
      color_grid: `[cap, 8, 8, 8, 3]` colors (zeros without a color layer).
      neighbor_slots: `i32[N, 27]` neighbour rows (-1 = absent).
      block_indices: `i32[N, 3]`.

    Returns (verts f32[N, 512, MAX_TRIS, 3, 3] layer-frame meters,
    colors f32[N, 512, MAX_TRIS, 3, 3] 0-255, valid bool[N, 512, MAX_TRIS]).
    """
    dev = tsdf_grid.device
    tri_table, tri_counts, ea, eb = (torch.as_tensor(a, device=dev)
                                     for a in build_tables())
    ea_l, eb_l = ea.long(), eb.long()
    corners = CORNERS.tolist()

    d_pad = gather_halo(tsdf_grid, neighbor_slots, lo=0, hi=1, fill=0.0)
    w_pad = gather_halo(weight_grid, neighbor_slots, lo=0, hi=1, fill=0.0)
    c_pad = gather_halo(color_grid, neighbor_slots, lo=0, hi=1, fill=0.0)
    N = d_pad.shape[0]
    V = B ** 3

    def corner_stack(pad, dim):
        return torch.stack([pad[:, cx:cx + B, cy:cy + B, cz:cz + B]
                            for cx, cy, cz in corners], dim=dim)

    cd = corner_stack(d_pad, -1)                 # [N, 8, 8, 8, 8]
    cw = corner_stack(w_pad, -1)
    cc = corner_stack(c_pad, -2)                 # [N, 8, 8, 8, 8, 3]
    cube_ok = torch.all(cw >= min_weight, dim=-1)
    bits = (cd < 0.0).to(torch.int32)
    config = torch.sum(bits * (2 ** torch.arange(8, dtype=torch.int32,
                                                 device=dev)), dim=-1)
    config = torch.where(cube_ok, config, torch.zeros_like(config))
    cd = cd.reshape(N, V, 8)
    cc = cc.reshape(N, V, 8, 3)
    config = config.reshape(N, V).long()

    da, db = cd[..., ea_l], cd[..., eb_l]                       # [N, V, 12]
    denom = da - db
    t = torch.clamp(da / torch.where(torch.abs(denom) > 1e-12, denom,
                                     torch.full_like(denom, 1e-12)), 0.0, 1.0)
    c = torch.as_tensor(CORNERS, dtype=torch.float32, device=dev)
    pa, pb = c[ea_l], c[eb_l]                                   # [12, 3]
    edge_pos = pa + t[..., None] * (pb - pa)                    # [N, V, 12, 3]
    ca, cb = cc[:, :, ea_l], cc[:, :, eb_l]
    edge_col = fma(t[..., None], cb - ca, ca)

    tri_edges = tri_table[config]                               # [N, V, 15]
    n_tris = tri_counts[config]
    safe_edges = torch.clamp_min(tri_edges, 0).long()[..., None].expand(
        N, V, MAX_TRIS_PER_CUBE * 3, 3)
    verts_local = torch.gather(edge_pos, 2, safe_edges)
    colors = torch.gather(edge_col, 2, safe_edges)

    r = torch.arange(B, dtype=torch.float32, device=dev)
    base = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        1, V, 1, 3)
    block_origin = (block_indices.to(torch.float32) * B)[:, None, None, :]
    # TSDF samples sit at voxel centers: cube corner (0,0,0) is the center
    # of voxel `base`.
    verts = (verts_local + base + 0.5 + block_origin) * voxel_size_m
    verts = verts.reshape(N, V, MAX_TRIS_PER_CUBE, 3, 3)
    colors = colors.reshape(N, V, MAX_TRIS_PER_CUBE, 3, 3)
    tri_idx = torch.arange(MAX_TRIS_PER_CUBE, device=dev)
    valid = tri_idx[None, None, :] < n_tris[..., None]
    return verts, colors, valid


@dataclasses.dataclass
class MeshBlock:
    """Host mesh of one block."""
    vertices: np.ndarray   # f32[V, 3]
    colors: np.ndarray     # u8[V, 3]
    triangles: np.ndarray  # i32[T, 3] indices into vertices


class MeshLayer:
    """Host mesh store: block index -> MeshBlock. Welding (one vertex per
    quantized position) runs here, as the reference's weld_vertices
    option."""

    def __init__(self, voxel_size_m: float,
                 params: Optional[MeshIntegratorParams] = None):
        self.voxel_size_m = voxel_size_m
        self.params = params or MeshIntegratorParams()
        self.blocks: Dict[Tuple[int, int, int], MeshBlock] = {}

    def update_block(self, block_index, verts: np.ndarray,
                     colors: np.ndarray) -> None:
        """Replace one block's mesh from compacted triangle soup
        (verts/colors f32[T, 3, 3]); an empty soup removes the block."""
        key = tuple(int(v) for v in block_index)
        if verts.size == 0:
            self.blocks.pop(key, None)
            return
        if self.params.weld_vertices:
            vertices, cols, tris = weld_mesh(
                verts, colors, quantum=self.voxel_size_m / 1024.0)
        else:
            vertices = verts.reshape(-1, 3).astype(np.float32)
            cols = np.clip(colors.reshape(-1, 3), 0, 255).astype(np.uint8)
            tris = np.arange(vertices.shape[0], dtype=np.int32).reshape(-1, 3)
        self.blocks[key] = MeshBlock(vertices=vertices, colors=cols,
                                     triangles=tris)

    def remove_blocks(self, block_indices) -> None:
        for bi in block_indices:
            self.blocks.pop(tuple(int(v) for v in bi), None)

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All blocks concatenated: (vertices, colors, triangles)."""
        if not self.blocks:
            return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8),
                    np.zeros((0, 3), np.int32))
        vs, cs, ts = [], [], []
        offset = 0
        for mb in self.blocks.values():
            vs.append(mb.vertices)
            cs.append(mb.colors)
            ts.append(mb.triangles + offset)
            offset += mb.vertices.shape[0]
        return np.concatenate(vs), np.concatenate(cs), np.concatenate(ts)


def mesh_dirty_blocks(mesh_layer: MeshLayer, pool, table,
                      dirty_slots: np.ndarray, *,
                      color_channel: str = "color_rgb",
                      chunk: int = 256) -> None:
    """Marching cubes (`marching_cubes_blocks`, f32) over the host-table
    slots `dirty_slots` (`core/block_pool.py`), in chunks of `chunk`
    blocks; each block's soup goes to the mesh layer."""
    if dirty_slots.size == 0:
        return
    tsdf_grid = pool.voxel_grid_view("tsdf_distance")
    weight_grid = pool.voxel_grid_view("tsdf_weight")
    if color_channel in pool.channels:
        color_grid = pool.voxel_grid_view(color_channel)
    else:
        color_grid = torch.zeros((), device=tsdf_grid.device).expand(
            tsdf_grid.shape + (3,))
    dev = tsdf_grid.device
    for start in range(0, dirty_slots.size, chunk):
        sl = dirty_slots[start:start + chunk]
        bidx = table.block_indices[sl]
        verts, colors, valid = marching_cubes_blocks(
            tsdf_grid, weight_grid, color_grid,
            torch.as_tensor(table.neighbors[sl], device=dev),
            torch.as_tensor(bidx, device=dev),
            voxel_size_m=mesh_layer.voxel_size_m,
            min_weight=float(mesh_layer.params.min_weight))
        verts, colors, valid = (t.cpu().numpy()
                                for t in (verts, colors, valid))
        for i in range(sl.size):
            m = valid[i].reshape(-1)
            mesh_layer.update_block(tuple(bidx[i]),
                                    verts[i].reshape(-1, 3, 3)[m],
                                    colors[i].reshape(-1, 3, 3)[m])
