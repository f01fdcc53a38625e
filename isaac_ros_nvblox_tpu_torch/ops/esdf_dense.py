"""Dense separable ESDF: exact banded squared Euclidean distance transform
(port of isaac_ros_nvblox_tpu/ops/esdf_dense.py).

Over a region of blocks (the allocated or dirty AABB):

    dt(x,y,z) = min_{site s} (x-sx)^2 + (y-sy)^2 + (z-sz)^2

decomposes into three 1-D banded min-plus passes, each
`out[i] = min_{|k|<=band} in[i+k] + k^2`. A voxel within the band of a
site has per-axis offsets <= band, so the banded passes are exact there.

The in-region sites of live slots are seeded into a dense grid
`f32[Nx*8, Ny*8, Nz*8]` (0 at sites, INF elsewhere); the first pass
(`edt_pass1`, kernel `csrc/edt.cu` FIRST) turns the {0, INF} seeds into
squared 1-D distances, the other two (`edt_pass`) run the min-plus along
the remaining axes, and the result is gathered back per slot. Every finite
value is an integer below 2^24 in float32, so the order of passes and of
candidates cannot change a bit of the output: it equals the reference's
and its numpy `esdf_from_sites_reference` exactly.

`edt_pass1` / `edt_pass` launch their kernels for CUDA tensors and use the
plain PyTorch versions (loops over k on INF-padded shifted views) for CPU
tensors.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.core.types import set_rows_drop

INF = np.float32(1e12)
V = 512  # voxels per block


# ---------------------------------------------------------------------------
# The 1-D passes: plain versions and kernel wrappers
# ---------------------------------------------------------------------------

def _shifted_views(grid, axis: int, band: int):
    """(g, S, pad) with lines along the last dim of g and `pad` the lines
    INF-padded by `band` on both ends."""
    g = grid.movedim(axis, -1)
    return g, g.shape[-1], F.pad(g, (band, band), value=float(INF))


def edt_pass1_plain(grid, axis: int, band: int) -> torch.Tensor:
    """First pass on {0, INF} seeds: d = min_k in[i+k] + |k|, then
    d*d where d <= band, else INF."""
    g, S, pad = _shifted_views(grid, axis, band)
    acc = torch.full_like(g, float(INF))
    for k in range(-band, band + 1):
        acc = torch.minimum(acc, pad[..., k + band:k + band + S] + float(abs(k)))
    out = torch.where(acc <= float(band), acc * acc,
                      torch.full_like(acc, float(INF)))
    return out.movedim(-1, axis).contiguous()


def edt_pass_plain(grid, axis: int, band: int) -> torch.Tensor:
    """Banded 1-D min-plus: out[i] = min_{|k|<=band} in[i+k] + k^2."""
    g, S, pad = _shifted_views(grid, axis, band)
    acc = torch.full_like(g, float(INF))
    for k in range(-band, band + 1):
        acc = torch.minimum(acc, pad[..., k + band:k + band + S] + float(k * k))
    return acc.movedim(-1, axis).contiguous()


def _launch(grid, axis: int, band: int, first: bool) -> torch.Tensor:
    if (grid.device.type != "cuda" or grid.dtype != torch.float32
            or grid.dim() != 3):
        raise ValueError("edt pass: grid must be a CUDA f32[X, Y, Z] tensor")
    grid = grid.contiguous()
    out = torch.empty_like(grid)
    shape = grid.shape
    A = int(np.prod(shape[:axis], dtype=np.int64))
    S = int(shape[axis])
    B = int(np.prod(shape[axis + 1:], dtype=np.int64))
    name = "edt_pass1" if first else "edt_pass"
    err = kernels.library("edt").edt_pass_launch(
        grid.data_ptr(), out.data_ptr(), A, S, B, int(band), int(first),
        kernels.stream_handle(grid))
    kernels.LAUNCHES[name] += 1
    kernels.check("edt", err, f"{name} launch")
    return out


def edt_pass1(grid, axis: int, band: int) -> torch.Tensor:
    """First EDT pass along `axis` of a dense f32[X, Y, Z] seed grid."""
    if grid.device.type == "cpu":
        return edt_pass1_plain(grid, axis, band)
    return _launch(grid, axis, band, first=True)


def edt_pass(grid, axis: int, band: int) -> torch.Tensor:
    """Banded min-plus EDT pass along `axis` of a dense f32[X, Y, Z] grid."""
    if grid.device.type == "cpu":
        return edt_pass_plain(grid, axis, band)
    return _launch(grid, axis, band, first=False)


# ---------------------------------------------------------------------------
# Full update over a block region
# ---------------------------------------------------------------------------

def region_rows(block_index_of_slot, alloc_count, origin_b, dims_b):
    """(in_region bool[cap], row i32[cap]) — each live slot's row in the
    region's block-major order (cx, cy, cz), -1 outside the region."""
    cap = block_index_of_slot.shape[0]
    dev = block_index_of_slot.device
    Nx, Ny, Nz = dims_b
    origin_b = torch.as_tensor(origin_b, dtype=torch.int32, device=dev)
    cells = block_index_of_slot - origin_b[None, :]
    live = torch.arange(cap, device=dev) < alloc_count
    in_region = live
    for a, n in enumerate(dims_b):
        in_region = in_region & (cells[:, a] >= 0) & (cells[:, a] < n)
    row = (cells[:, 0] * Ny + cells[:, 1]) * Nz + cells[:, 2]
    return in_region, torch.where(in_region, row, torch.full_like(row, -1))


def seed_grid(is_site, in_region, row, dims_b) -> torch.Tensor:
    """Dense f32[Nx*8, Ny*8, Nz*8] region grid: 0 at in-region sites, INF
    elsewhere (including unallocated blocks)."""
    cap = is_site.shape[0]
    dev = is_site.device
    Nx, Ny, Nz = dims_b
    nb = Nx * Ny * Nz
    slot_of_row = torch.full((nb,), cap, dtype=torch.int32, device=dev)
    set_rows_drop(slot_of_row, row,
                  torch.arange(cap, dtype=torch.int32, device=dev))
    has = (slot_of_row < cap)[:, None]
    site = is_site[slot_of_row.clamp(0, cap - 1).long()] & has
    g = torch.where(site, torch.zeros((), device=dev),
                    torch.full((), float(INF), device=dev))
    return (g.view(Nx, Ny, Nz, 8, 8, 8).permute(0, 3, 1, 4, 2, 5)
            .reshape(Nx * 8, Ny * 8, Nz * 8))


def solve_region(grid, band: int) -> torch.Tensor:
    """The three passes over a seeded dense grid. Passes commute; they run
    shortest axis first (the reference's order, free here)."""
    order = [int(a) for a in np.argsort(grid.shape, kind="stable")]
    first, mid, last = order
    grid = edt_pass1(grid, first, band)
    grid = edt_pass(grid, mid, band)
    return edt_pass(grid, last, band)


@torch.no_grad()
def esdf_from_sites_dense(is_site, block_index_of_slot, alloc_count,
                          origin_b, *, dims_b: Tuple[int, int, int],
                          band: int) -> torch.Tensor:
    """Exact banded squared EDT for all allocated blocks in a region.

    Args:
      is_site: bool[cap, 512] surface-site mask (pool layout).
      block_index_of_slot: i32[cap, 3] world block index per slot.
      alloc_count: i32[] number of live slots.
      origin_b: i32[3] world block index of region cell (0,0,0).
      dims_b: region size in blocks (Nx, Ny, Nz).
      band: max propagation distance in voxels.

    Returns sq: f32[cap, 512] squared voxel distances (INF beyond band^2 or
    outside the region; 0 at sites).
    """
    dims_b = tuple(int(d) for d in dims_b)
    in_region, row = region_rows(block_index_of_slot, alloc_count, origin_b,
                                 dims_b)
    dense = solve_region(seed_grid(is_site, in_region, row, dims_b), band)
    return gather_slots(dense, in_region, row, band)


def gather_slots(dense, in_region, row, band: int) -> torch.Tensor:
    """Solved dense region -> f32[cap, 512] per slot: INF outside the
    region and beyond band^2."""
    X, Y, Z = dense.shape
    Nx, Ny, Nz = X // 8, Y // 8, Z // 8
    rows = (dense.view(Nx, 8, Ny, 8, Nz, 8).permute(0, 2, 4, 1, 3, 5)
            .reshape(Nx * Ny * Nz, V))
    sq = rows[row.clamp(min=0).long()]
    inf = torch.full((), float(INF), device=sq.device)
    sq = torch.where(in_region[:, None], sq, inf)
    return torch.where(sq <= float(band * band), sq, inf)


# ---------------------------------------------------------------------------
# Reference (numpy) implementation for exact-match tests
# ---------------------------------------------------------------------------

def esdf_from_sites_reference(is_site: np.ndarray, cells: np.ndarray,
                              n_alloc: int, dims_b: Tuple[int, int, int],
                              band: int) -> np.ndarray:
    """Brute separable EDT on a dense numpy grid (same candidates, same
    float32 arithmetic as esdf_from_sites_dense)."""
    cap = is_site.shape[0]
    Nx, Ny, Nz = dims_b
    X, Y, Z = Nx * 8, Ny * 8, Nz * 8
    dense = np.full((X, Y, Z), INF, np.float32)
    for s in range(min(n_alloc, cap)):
        cx, cy, cz = cells[s]
        if not (0 <= cx < Nx and 0 <= cy < Ny and 0 <= cz < Nz):
            continue
        blk = np.where(is_site[s].reshape(8, 8, 8), np.float32(0.0), INF)
        dense[cx * 8:cx * 8 + 8, cy * 8:cy * 8 + 8, cz * 8:cz * 8 + 8] = blk
    for axis in range(3):
        pad = [(0, 0)] * 3
        pad[axis] = (band, band)
        dp = np.pad(dense, pad, constant_values=INF)
        S = dense.shape[axis]
        out = np.full_like(dense, INF)
        for k in range(-band, band + 1):
            sl = [slice(None)] * 3
            sl[axis] = slice(k + band, k + band + S)
            out = np.minimum(out, dp[tuple(sl)] + np.float32(k * k))
        dense = out
    sq = np.full((cap, V), INF, np.float32)
    for s in range(min(n_alloc, cap)):
        cx, cy, cz = cells[s]
        if not (0 <= cx < Nx and 0 <= cy < Ny and 0 <= cz < Nz):
            continue
        blk = dense[cx * 8:cx * 8 + 8, cy * 8:cy * 8 + 8, cz * 8:cz * 8 + 8]
        sq[s] = blk.reshape(-1)
    return np.where(sq <= np.float32(band * band), sq, INF)
