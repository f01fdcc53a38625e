"""Marching cubes on the card: wrapper of the `marching_cubes` CUDA kernel
(`csrc/marching_cubes.cu`), the port's counterpart of
isaac_ros_nvblox_tpu/ops/mesh_pallas.py, with that module's tensor-op
helpers.

  * `surface_crossing`: which batch blocks can emit triangles at all.
  * `marching_cubes_fused`: the kernel for CUDA tensors, its plain PyTorch
    version `marching_cubes_plain` for CPU tensors. Per block: one
    interpolated vertex (and color) per cube edge plus the per-cube table
    (triangle count + 15 edge ids), bfloat16, block-local voxel units.
  * `resolve_edge_soup`: per-edge planes + table -> the slot-indexed
    triangle soup, at publish cadence.
  * `local_to_world_verts`: block-local bf16 soup -> meters + mask.
  * `mesh_row_offsets` + `mesh_compact`: the soup's per-block CSR in
    meters on the card (kernel mesh_compact), so that only live vertices
    cross to the host; `mesh_compact_plain` for CPU tensors.

A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import device_constant, fma
from isaac_ros_nvblox_tpu_torch.ops.color_cuda import F32, I32
from isaac_ros_nvblox_tpu_torch.ops.mesh_tables import (CORNERS, EDGES,
                                                        MAX_TRIS_PER_CUBE,
                                                        build_tables)

V = 512
K_SLOTS = MAX_TRIS_PER_CUBE * 3      # 15 triangle-vertex slots
K_PAD = 16
SENTINEL = -1.0

# Columns of the OCTANT_OFFSETS directions in the 27-neighbourhood
# (core/world_grid.NEIGHBOR_OFFSETS) order.
NEIGHBOR_COLS = [int(np.flatnonzero((wg.NEIGHBOR_OFFSETS == d).all(1))[0])
                 for d in wg.OCTANT_OFFSETS]


@functools.lru_cache(maxsize=1)
def table_rows() -> np.ndarray:
    """i32[16, 256]: row 0 = triangle count per config, rows 1..15 = the
    edge id of each triangle-vertex slot (-1 padded)."""
    tri_table, tri_counts, _, _ = build_tables()
    return np.concatenate([tri_counts[None, :], tri_table.T]).astype(np.int32)


@functools.lru_cache(maxsize=1)
def kernel_lut() -> np.ndarray:
    """The kernel's int8 table: per config the 16 entries of
    `table_rows()`, then the 12 edges' first corners, then their second,
    zero padded to whole 16-byte words (the kernel stages it with 16-byte
    loads)."""
    ea = [e[0] for e in EDGES]
    eb = [e[1] for e in EDGES]
    lut = np.concatenate([table_rows().T.reshape(-1), ea, eb])
    return np.pad(lut, (0, -lut.size % 16)).astype(np.int8)


@functools.lru_cache(maxsize=1)
def _corner_source() -> np.ndarray:
    """i64[8, 512]: for cube corner c of the cube at lane v, the flat index
    row * 512 + lane of its voxel among the 8 halo rows (OCTANT_OFFSETS
    order): the block's own voxel, or the neighbour's the corner carries
    into."""
    lane = np.arange(V)
    lx, ly, lz = lane // 64, (lane // 8) % 8, lane % 8
    octant = {tuple(d): i for i, d in enumerate(wg.OCTANT_OFFSETS.tolist())}
    out = np.zeros((8, V), np.int64)
    for c, (cx, cy, cz) in enumerate(CORNERS.tolist()):
        px, py, pz = lx + cx, ly + cy, lz + cz
        row = np.asarray([octant[(a, b, d)] for a, b, d in
                          zip(px >> 3, py >> 3, pz >> 3)])
        out[c] = row * V + (px & 7) * 64 + (py & 7) * 8 + (pz & 7)
    return out


@torch.no_grad()
def surface_crossing(tsdf_rows, weight_rows, nbr8, *, min_weight: float):
    """bool[N]: the block's 8-row halo holds both a negative and a
    non-negative TSDF value among voxels with weight >= min_weight, the
    condition for marching cubes to emit any triangle. Per-slot sign
    summaries, OR'd over each row's 8 neighbours."""
    cap = tsdf_rows.shape[0]
    w_ok = weight_rows >= float(np.float32(min_weight))
    slot_neg = torch.any(w_ok & (tsdf_rows < 0.0), dim=1)
    slot_pos = torch.any(w_ok & (tsdf_rows >= 0.0), dim=1)
    packed = slot_neg.to(torch.int32) | (slot_pos.to(torch.int32) << 1)
    bits = torch.where(nbr8 >= 0, packed[nbr8.clamp(0, cap - 1).long()], 0)
    return torch.any((bits & 1) > 0, dim=1) & torch.any((bits & 2) > 0, dim=1)


@torch.no_grad()
def marching_cubes_plain(tsdf_rows, weight_rows, color_rows, nbr8, valid, *,
                         min_weight: float, with_color: bool):
    """Plain PyTorch version of the `marching_cubes` kernel; same contract
    as `marching_cubes_fused`."""
    dev = tsdf_rows.device
    cap = tsdf_rows.shape[0]
    N = nbr8.shape[0]
    mw = float(np.float32(min_weight))
    safe = nbr8.clamp(0, cap - 1).long()
    present = (nbr8 >= 0)[..., None]
    # An absent neighbour reads row 0's values with weight 0.
    d_rows = tsdf_rows[safe]                                    # [N, 8, V]
    w_rows = torch.where(present, weight_rows[safe], 0.0)
    w_ok = w_rows >= mw
    has_neg = torch.any((w_ok & (d_rows < 0.0)).reshape(N, -1), dim=1)
    has_pos = torch.any((w_ok & (d_rows >= 0.0)).reshape(N, -1), dim=1)
    live = ((valid != 0) & has_neg & has_pos)[:, None, None]

    src = torch.as_tensor(_corner_source().reshape(-1), device=dev)

    def corners(rows):
        return rows.reshape(N, 8 * V)[:, src].reshape(N, 8, V)

    cd, cw = corners(d_rows), corners(w_rows)
    cube_ok = torch.amin(cw, dim=1) >= mw                        # [N, V]
    config = torch.zeros((N, V), dtype=torch.int64, device=dev)
    for c in range(8):
        config |= (cd[:, c] < 0.0).to(torch.int64) << c
    config = torch.where(cube_ok, config, 0)
    tt = torch.as_tensor(table_rows(), device=dev)
    table = tt[:, config].permute(1, 0, 2).to(torch.float32)   # [N, 16, V]
    table[:, 0] = torch.where(cube_ok, table[:, 0], 0.0)

    ea = torch.as_tensor([e[0] for e in EDGES], device=dev)
    eb = torch.as_tensor([e[1] for e in EDGES], device=dev)
    da, db = cd[:, ea], cd[:, eb]                                # [N, 12, V]
    denom = da - db
    t = torch.clamp(da / torch.where(torch.abs(denom) > 1e-12, denom,
                                     torch.full_like(denom, 1e-12)), 0.0, 1.0)
    corner_f = torch.as_tensor(CORNERS, dtype=torch.float32, device=dev)
    pa, pb = corner_f[ea], corner_f[eb]                           # [12, 3]
    lane = torch.arange(V, device=dev)
    base = torch.stack([lane // 64, (lane // 8) % 8, lane % 8]).to(
        torch.float32)                                            # [3, V]
    sent = torch.full((N, K_PAD - 12, V), SENTINEL, device=dev)
    zero = torch.zeros((N, K_PAD - 12, V), device=dev)
    verts = torch.stack([torch.cat([
        pa[:, k, None] + t * (pb - pa)[:, k, None] + base[k] + 0.5, sent], 1)
        for k in range(3)], 1)                                    # [N,3,16,V]
    verts = torch.where(live[:, None], verts, SENTINEL)
    table = torch.where(live, table, 0.0)
    colors_e = None
    if with_color:
        cols = []
        for plane in color_rows:
            cc = corners(plane[safe])
            cols.append(torch.cat([fma(t, cc[:, eb] - cc[:, ea], cc[:, ea]),
                                   zero], 1))
        colors_e = torch.where(live[:, None], torch.stack(cols, 1), 0.0)
        colors_e = colors_e.to(torch.bfloat16)
    return verts.to(torch.bfloat16), colors_e, table.to(torch.bfloat16)


@torch.no_grad()
def marching_cubes_fused(tsdf_rows, weight_rows, color_rows, nbr8, valid, *,
                         min_weight: float, with_color: bool
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    torch.Tensor]:
    """Marching cubes over pool rows with the +1 halo read in place.

    Args:
      tsdf_rows, weight_rows: `f32[cap, 512]` pool channels.
      color_rows: (r, g, b) planar `f32[cap, 512]` channels, or None.
      nbr8: `i32[N, 8]` slots of the block and its 7 positive-octant
        neighbours (core/world_grid.OCTANT_OFFSETS order; -1 = absent).
      valid: `i32[N]` (0 = padding block).

    Returns:
      verts_e: `bf16[N, 3, 16, 512]` block-local voxel coordinates of the
        interpolated vertex on each cube edge (rows 0..11; rows 12..15
        SENTINEL). Blocks that are padding or whose halo has no sign
        crossing among voxels with weight >= min_weight are SENTINEL
        throughout.
      colors_e: `bf16[N, 3, 16, 512]` per-edge RGB (0-255), or None.
      table: `bf16[N, 16, 512]` row 0 = triangle count, rows 1..15 = edge
        id per triangle-vertex slot (all zero for such blocks).
    """
    if tsdf_rows.device.type == "cpu":
        return marching_cubes_plain(tsdf_rows, weight_rows, color_rows, nbr8,
                                    valid, min_weight=min_weight,
                                    with_color=with_color)
    what = "marching_cubes_fused"
    dev = tsdf_rows.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    cap = tsdf_rows.shape[0]
    N = nbr8.shape[0]
    planes = tuple(color_rows) if with_color else ()
    if (any(t.shape != (cap, 512) for t in (tsdf_rows, weight_rows) + planes)
            or nbr8.shape != (N, 8) or valid.shape != (N,)
            or len(planes) != (3 if with_color else 0)):
        raise ValueError(f"{what}: channels f32[cap, 512], nbr8 i32[N, 8], "
                         "valid i32[N], three color planes with color")
    kernels.check_tensors(
        what, dev, [("tsdf_rows", tsdf_rows, F32),
                    ("weight_rows", weight_rows, F32), ("nbr8", nbr8, I32),
                    ("valid", valid, I32)]
        + [(f"color plane {i}", p, F32) for i, p in enumerate(planes)])
    kernels.check_aligned(what, [("tsdf_rows", tsdf_rows),
                                 ("weight_rows", weight_rows)]
                          + [(f"color plane {i}", p)
                             for i, p in enumerate(planes)])
    verts = torch.empty((N, 3, K_PAD, V), dtype=torch.bfloat16, device=dev)
    colors = (torch.empty_like(verts) if with_color else None)
    table = torch.empty((N, K_PAD, V), dtype=torch.bfloat16, device=dev)
    ptrs = [p.data_ptr() for p in planes] or [None] * 3
    lib = kernels.library("marching_cubes")
    err = lib.marching_cubes(
        tsdf_rows.data_ptr(), weight_rows.data_ptr(), *ptrs, nbr8.data_ptr(),
        valid.data_ptr(), device_constant(kernel_lut(), dev).data_ptr(),
        verts.data_ptr(),
        colors.data_ptr() if with_color else None, table.data_ptr(), N, cap,
        float(np.float32(min_weight)), int(with_color),
        kernels.stream_handle(tsdf_rows))
    kernels.LAUNCHES["marching_cubes"] += 1
    kernels.check("marching_cubes", err, "marching_cubes launch")
    return verts, colors, table


@torch.no_grad()
def resolve_edge_soup(verts_e, colors_e, table, *, with_color: bool = True):
    """Per-edge vertex planes + table -> slot-indexed triangle soup
    (verts bf16[N, 3, 16, 512], colors bf16 | None), SENTINEL / 0 marking
    empty slots; slot s of a cube holds the vertex of edge table[1 + s]."""
    N = table.shape[0]
    n_tris = table[:, 0:1].to(torch.float32)                     # [N, 1, V]
    edges = table[:, 1:K_PAD].to(torch.float32)                  # [N, 15, V]
    slot_i = torch.arange(K_SLOTS, dtype=torch.float32,
                          device=table.device)[None, :, None]
    valid_s = ((slot_i < n_tris * 3.0) & (edges >= 0.0))[:, None]
    idx = edges.clamp(0, 11).long()[:, None].expand(N, 3, K_SLOTS, V)

    def soup(planes, empty):
        got = torch.gather(planes[:, :, :12].to(torch.float32), 2, idx)
        pad = torch.full((N, 3, K_PAD - K_SLOTS, V), empty,
                         device=table.device)
        return torch.cat([torch.where(valid_s, got, empty), pad],
                         2).to(torch.bfloat16)

    verts = soup(verts_e, SENTINEL)
    return verts, (soup(colors_e, 0.0) if with_color else None)


def local_to_world_verts(verts_local, block_indices, voxel_size_m: float):
    """bf16 block-local soup `[N, 3, 16, 512]` -> (f32 meters of the same
    shape, mask bool[N, 16, 512])."""
    mask = verts_local[:, 0] >= 0.0
    origin = block_indices.to(torch.float32) * 8.0
    world = (verts_local.to(torch.float32)
             + origin[:, :, None, None]) * voxel_size_m
    return world, mask


# ------------------------------------------------------------- compaction
def _live_slots(verts):
    """bool[N, 512, 16]: the soup's live slots in v-major, then slot,
    order (`local_to_world_verts`' mask, transposed)."""
    return (verts[:, 0] >= 0.0).transpose(1, 2)


def mesh_row_offsets_plain(verts) -> torch.Tensor:
    """Plain version of `mesh_row_offsets`."""
    counts = _live_slots(verts).reshape(verts.shape[0], -1).sum(1)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


@torch.no_grad()
def mesh_row_offsets(verts) -> torch.Tensor:
    """i64[N + 1]: row i's live vertices of the bf16 soup
    `[N, 3, 16, 512]` start at offsets[i] (an exclusive scan of each
    row's live slots, x >= 0). On the card: kernel mesh_compact's count
    and scan, no host sync."""
    if verts.device.type == "cpu":
        return mesh_row_offsets_plain(verts)
    what = "mesh_row_offsets"
    dev = verts.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    N = verts.shape[0]
    if verts.shape[1:] != (3, K_PAD, V):
        raise ValueError(f"{what}: verts bf16[N, 3, 16, 512]")
    kernels.check_tensors(what, dev, [("verts", verts, (torch.bfloat16,))])
    offsets = torch.empty((N + 1,), dtype=torch.int64, device=dev)
    lib = kernels.library("mesh_compact")
    err = lib.mesh_compact_offsets(verts.data_ptr(), offsets.data_ptr(), N,
                                   kernels.stream_handle(verts))
    kernels.LAUNCHES["mesh_offsets"] += 1
    kernels.check("mesh_compact", err, "mesh_compact_offsets launch")
    return offsets


def mesh_compact_plain(verts, colors, block_indices, offsets, n_live: int,
                       total: int, voxel_size_m: float):
    """Plain version of `mesh_compact`: `local_to_world_verts` on the
    live rows, their live slots gathered in v-major, then slot, order."""
    world, _ = local_to_world_verts(verts[:n_live], block_indices[:n_live],
                                    voxel_size_m)
    live = _live_slots(verts[:n_live])

    def pack(planes):
        return planes.permute(0, 3, 2, 1)[live]            # [total, 3]

    flat = [pack(world)]
    if colors is not None:
        flat.append(pack(colors[:n_live].to(torch.float32)))
    csr = torch.cat([offsets[:n_live + 1],
                     block_indices[:n_live].reshape(-1).to(torch.int64)])
    return csr, torch.stack(flat)


@torch.no_grad()
def mesh_compact(verts, colors, block_indices, offsets, n_live: int,
                 total: int, voxel_size_m: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first `n_live` rows of the soup as per-block CSR, meters on
    the device: what `native.compact_mesh_blocks` makes of
    `local_to_world_verts`' output, bit for bit.

    Args:
      verts, colors: bf16 `[N, 3, 16, 512]` (`update_mesh_dirty_device`;
        colors None without color).
      block_indices: `i32[N, 3]`.
      offsets: `i64[N + 1]` from `mesh_row_offsets`; `total` =
        offsets[n_live], the live rows' vertices.

    Returns:
      csr: `i64[n_live + 1 + 3 n_live]`, the live rows' offsets, then
        their block indices.
      flat: `f32[C, total, 3]`, the world vertices, then (C = 2) the
        colors; block i's at [offsets[i], offsets[i + 1]) in v-major, then
        slot, order.
    """
    dev = verts.device
    if dev.type == "cpu":
        return mesh_compact_plain(verts, colors, block_indices, offsets,
                                  n_live, total, voxel_size_m)
    what = "mesh_compact"
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    N = verts.shape[0]
    planes = [("verts", verts, (torch.bfloat16,))]
    if colors is not None:
        planes.append(("colors", colors, (torch.bfloat16,)))
    if (any(t.shape != (N, 3, K_PAD, V) for _, t, _ in planes)
            or block_indices.shape != (N, 3) or offsets.shape != (N + 1,)
            or not 0 <= n_live <= N):
        raise ValueError(f"{what}: verts and colors bf16[N, 3, 16, 512], "
                         "block_indices i32[N, 3], offsets i64[N + 1], "
                         "0 <= n_live <= N")
    kernels.check_tensors(what, dev, planes + [
        ("block_indices", block_indices, I32),
        ("offsets", offsets, (torch.int64,))])
    flat = torch.empty((1 + (colors is not None), total, 3),
                       dtype=torch.float32, device=dev)
    if n_live == 0:
        return torch.zeros((1,), dtype=torch.int64, device=dev), flat
    csr = torch.empty((4 * n_live + 1,), dtype=torch.int64, device=dev)
    lib = kernels.library("mesh_compact")
    err = lib.mesh_compact(
        verts.data_ptr(), None if colors is None else colors.data_ptr(),
        block_indices.data_ptr(), offsets.data_ptr(), n_live,
        float(np.float32(voxel_size_m)), flat[0].data_ptr(),
        flat[1].data_ptr() if colors is not None else None, csr.data_ptr(),
        kernels.stream_handle(verts))
    kernels.LAUNCHES["mesh_compact"] += 1
    kernels.check("mesh_compact", err, "mesh_compact launch")
    return csr, flat
