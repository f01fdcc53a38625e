"""Dense separable ESDF: exact banded squared Euclidean distance transform
(port of isaac_ros_nvblox_tpu/ops/esdf_dense.py).

Over a region of blocks (the allocated or dirty AABB):

    dt(x,y,z) = min_{site s} (x-sx)^2 + (y-sy)^2 + (z-sz)^2

decomposes into three 1-D banded min-plus passes, each
`out[i] = min_{|k|<=band} in[i+k] + k^2`. A voxel within the band of a
site has per-axis offsets <= band, so the banded passes are exact there.

The in-region sites of live slots are seeded into a dense grid
`f32[Nx*8, Ny*8, Nz*8]` (0 at sites, INF elsewhere); the first pass
(`edt_pass1`, kernels `edt_sweep_*` in `csrc/edt.cu`) turns the seeds into
squared 1-D distances with two linear sweeps, the other two (`edt_pass`,
kernel `edt_minplus_kernel`) run the banded min-plus along the remaining
axes, and the result is gathered back per slot. Every finite value is an
integer below 2^24 in float32, so the order of passes and of candidates
cannot change a bit of the output: it equals the reference's and its numpy
`esdf_from_sites_reference` exactly.

Output pruning, as in the reference (`needed_masks`): only the allocated
blocks are gathered, so the last pass computes only those, the middle pass
only what the last reads (allocated blocks dilated by ceil(band/8) blocks
along the last axis) and the first what the middle reads. A pruned block
holds INF.

The 2-D ESDF (`esdf_2d_from_sites`, EsdfMode 2d) collapses the sites of a
height band onto one cell per (x, y) column and runs `edt_pass1` along x
and `edt_pass` along y on an f32[X, Y, 1] grid, unpruned.

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


def needed_voxels(needed, shape) -> torch.Tensor:
    """bool[X, Y, Z]: each voxel's byte of the block mask `needed`
    (bool or u8[ceil(X/8), ceil(Y/8), ceil(Z/8)])."""
    v = needed.bool()
    for a in range(3):
        v = v.repeat_interleave(8, dim=a)
    return v[:shape[0], :shape[1], :shape[2]]


def _prune(out, needed):
    if needed is None:
        return out
    return torch.where(needed_voxels(needed, out.shape), out,
                       torch.full((), float(INF), device=out.device))


def _banded_min(grid, axis: int, band: int, cost) -> torch.Tensor:
    """min_{|k|<=band} in[i+k] + cost(k) along `axis`, with lines along the
    last dim; the two buffers are reused across the 2*band+1 shifts."""
    g, S, pad = _shifted_views(grid, axis, band)
    acc = torch.full_like(g, float(INF))
    term = torch.empty_like(g)
    for k in range(-band, band + 1):
        torch.add(pad[..., k + band:k + band + S], float(cost(k)), out=term)
        torch.minimum(acc, term, out=acc)
    return acc


def edt_pass1_plain(grid, axis: int, band: int, needed=None) -> torch.Tensor:
    """First pass on non-negative input ({0, INF} seeds in a solve): d =
    min_k in[i+k] + |k|, then d*d where d <= band, else INF; INF in the
    blocks that `needed` marks 0."""
    acc = _banded_min(grid, axis, band, abs)
    out = torch.where(acc <= float(band), acc * acc,
                      torch.full_like(acc, float(INF)))
    return _prune(out.movedim(-1, axis).contiguous(), needed)


def edt_pass_plain(grid, axis: int, band: int, needed=None) -> torch.Tensor:
    """Banded 1-D min-plus: out[i] = min_{|k|<=band} in[i+k] + k^2; INF in
    the blocks that `needed` marks 0."""
    acc = _banded_min(grid, axis, band, lambda k: k * k)
    return _prune(acc.movedim(-1, axis).contiguous(), needed)


def _launch(grid, axis: int, band: int, first: bool, needed) -> torch.Tensor:
    if grid.device.type != "cuda":
        raise ValueError(f"edt pass: unsupported device {grid.device}")
    if grid.dtype != torch.float32 or grid.dim() != 3:
        raise ValueError("edt pass: grid must be a CUDA f32[X, Y, Z] tensor")
    grid = grid.contiguous()
    X, Y, Z = (int(d) for d in grid.shape)
    mask_ptr = None
    if needed is not None:
        blocks = tuple((d + 7) // 8 for d in (X, Y, Z))
        if tuple(needed.shape) != blocks:
            raise ValueError(f"edt pass: needed must have shape {blocks}, "
                             f"got {tuple(needed.shape)}")
        needed = needed.to(grid.device, torch.uint8).contiguous()
        mask_ptr = needed.data_ptr()
    out = torch.empty_like(grid)
    name = "edt_pass1" if first else "edt_pass"
    err = kernels.library("edt").edt_pass_launch(
        grid.data_ptr(), out.data_ptr(), mask_ptr, X, Y, Z, int(axis),
        int(band), int(first), kernels.stream_handle(grid))
    kernels.LAUNCHES[name] += 1
    kernels.check("edt", err, f"{name} launch")
    return out


def edt_pass1(grid, axis: int, band: int, needed=None) -> torch.Tensor:
    """First EDT pass along `axis` of a dense f32[X, Y, Z] grid of
    non-negative values (kernels edt_sweep_*). `needed`: optional block
    mask, bool/u8[ceil(X/8), ceil(Y/8), ceil(Z/8)]; the output is INF in
    the blocks it marks 0."""
    if grid.device.type == "cpu":
        return edt_pass1_plain(grid, axis, band, needed)
    return _launch(grid, axis, band, True, needed)


def edt_pass(grid, axis: int, band: int, needed=None) -> torch.Tensor:
    """Banded min-plus EDT pass along `axis` of a dense f32[X, Y, Z] grid
    of non-negative values (kernel edt_minplus_kernel); `needed` as in
    edt_pass1."""
    if grid.device.type == "cpu":
        return edt_pass_plain(grid, axis, band, needed)
    return _launch(grid, axis, band, False, needed)


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


def pass_order(dims) -> Tuple[int, int, int]:
    """(first, mid, last) pass axes: shortest axis first (the reference's
    order; passes commute)."""
    return tuple(int(a) for a in np.argsort(dims, kind="stable"))


def dilate_blocks(mask, axis: int, hb: int) -> torch.Tensor:
    """bool block mask dilated by `hb` blocks both ways along `axis`."""
    out = mask.clone()
    n = mask.shape[axis]
    for s in range(1, min(hb, n - 1) + 1):
        out.narrow(axis, s, n - s).logical_or_(mask.narrow(axis, 0, n - s))
        out.narrow(axis, 0, n - s).logical_or_(mask.narrow(axis, s, n - s))
    return out


def needed_masks(row, dims_b, band: int):
    """The reference's output pruning chain (esdf_from_sites_dense): block
    masks bool[Nx, Ny, Nz] (need_first, need_mid, need_last). The last pass
    needs the allocated blocks; each earlier pass what the next one reads,
    the next pass's mask dilated by Hb = ceil(band/8) blocks along the next
    pass's axis."""
    Nx, Ny, Nz = dims_b
    alloc = torch.zeros(Nx * Ny * Nz, dtype=torch.bool, device=row.device)
    set_rows_drop(alloc, row, True)             # row is -1 off the region
    need_last = alloc.view(Nx, Ny, Nz)
    _, mid, last = pass_order(dims_b)
    hb = (band + 7) // 8
    need_mid = dilate_blocks(need_last, last, hb)
    return dilate_blocks(need_mid, mid, hb), need_mid, need_last


def solve_region(grid, band: int, needed) -> torch.Tensor:
    """The three passes over a seeded dense grid, shortest axis first, each
    with its block mask of `needed` = (need_first, need_mid, need_last)
    (`needed_masks`): exact in the last mask's blocks, INF outside them."""
    first, mid, last = pass_order(grid.shape)
    nf, nm, nl = needed
    grid = edt_pass1(grid, first, band, nf)
    grid = edt_pass(grid, mid, band, nm)
    return edt_pass(grid, last, band, nl)


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
    dense = solve_region(seed_grid(is_site, in_region, row, dims_b), band,
                         needed_masks(row, dims_b, band))
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
# 2-D ESDF (EsdfMode 2d): sites collapsed over a height band, two passes
# ---------------------------------------------------------------------------

@torch.no_grad()
def collapse_2d_mask(mask, voxel_z_ok, block_index_of_slot, alloc_count,
                     origin_b, *, dims_b: Tuple[int, int]) -> torch.Tensor:
    """any() of a bool voxel mask `[cap, 512]` over the height-band voxels
    (`voxel_z_ok`) of each (x, y) column -> bool[Nx*8, Ny*8].

    Several z blocks of one column share a 2-D cell, so the per-slot column
    flags are summed into their cell's row (`index_add_`, no host sync);
    padding slots (at or beyond `alloc_count`) and slots outside the region
    go to a spare row that is dropped. `origin_b` holds the region's world
    block (x, y) in its first two entries."""
    cap = mask.shape[0]
    dev = mask.device
    Nx, Ny = (int(d) for d in dims_b)
    # Lane v = lx*64 + ly*8 + lz: an any() over each group of 8 lanes.
    col = torch.any((mask & voxel_z_ok).view(cap, 64, 8), dim=-1)
    cells = block_index_of_slot[:, :2] - origin_b[None, :2]
    live = ((torch.arange(cap, device=dev) < alloc_count)
            & (cells[:, 0] >= 0) & (cells[:, 0] < Nx)
            & (cells[:, 1] >= 0) & (cells[:, 1] < Ny))
    row = torch.where(live, cells[:, 0] * Ny + cells[:, 1], Nx * Ny).long()
    acc = torch.zeros((Nx * Ny + 1, 64), dtype=torch.int32, device=dev)
    acc.index_add_(0, row, col.to(torch.int32))
    return (acc[:-1] > 0).view(Nx, Ny, 8, 8).permute(0, 2, 1, 3).reshape(
        Nx * 8, Ny * 8)


@torch.no_grad()
def esdf_2d_from_sites(is_site, voxel_z_ok, block_index_of_slot, alloc_count,
                       origin_b, *, dims_b: Tuple[int, int],
                       band: int) -> torch.Tensor:
    """Exact banded 2-D squared EDT from height-band-restricted sites.

    The band's sites collapse onto one cell per (x, y) column
    (`collapse_2d_mask`), seeding a dense `f32[Nx*8, Ny*8, 1]` grid (0 at a
    site column, INF elsewhere); `edt_pass1` runs along x, `edt_pass` along
    y. There is no z pass and no output pruning: distances reach columns
    with no allocated block.

    Returns sq2d: f32[Nx*8, Ny*8] squared planar voxel distances (INF
    beyond band^2 or away from any site).
    """
    site = collapse_2d_mask(is_site, voxel_z_ok, block_index_of_slot,
                            alloc_count, origin_b, dims_b=dims_b)
    inf = torch.full((), float(INF), device=site.device)
    grid = torch.where(site, torch.zeros((), device=site.device), inf)
    grid = edt_pass1(grid[..., None].contiguous(), 0, band)
    sq2d = edt_pass(grid, 1, band)[..., 0]
    return torch.where(sq2d <= float(band * band), sq2d, inf)


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
