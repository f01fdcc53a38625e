"""Halo gathering and the 3^3 occupancy dilation (port of
isaac_ros_nvblox_tpu/ops/halo.py).

`gather_halo` gathers whole neighbour blocks by slot, then slices and
concatenates the faces, edges and corners the halo needs along each axis;
`gather_halo_sliced` gathers only those slices. `dilate_occupancy_dense`
assembles a pool channel into a dense block region, takes the 3x3x3 voxel
maximum there (`dilate_dense_grid`: kernel `dilate_dense`,
`csrc/dilate.cu`, on the card; `dilate_dense_grid_plain` for CPU tensors)
and gathers the rows back.
"""

from __future__ import annotations

import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.core.types import VOXELS_PER_SIDE

B = VOXELS_PER_SIDE


def gather_halo(grid_channel, neighbor_slots, *, lo: int = 1, hi: int = 1,
                fill=0.0) -> torch.Tensor:
    """Padded neighbourhoods `[N, B+lo+hi, B+lo+hi, B+lo+hi, ...]`.

    Args:
      grid_channel: pool channel as a grid view `[cap, 8, 8, 8, ...]`.
      neighbor_slots: `i32[N, 27]` neighbour slot rows (order of
        core/world_grid.NEIGHBOR_OFFSETS; -1 = absent). Entry 13 is the
        block itself.
      lo, hi: halo width on the negative / positive side (0 or 1).
      fill: value for absent neighbours.
    """
    cap = grid_channel.shape[0]
    trailing = grid_channel.shape[4:]
    N = neighbor_slots.shape[0]

    def blocks_of(col):
        ns = neighbor_slots[:, col]
        data = grid_channel[ns.clamp(0, cap - 1).long()]
        mask = (ns >= 0).reshape((N, 1, 1, 1) + (1,) * len(trailing))
        return torch.where(mask, data, torch.full((), fill,
                                                  dtype=data.dtype,
                                                  device=data.device))

    def src(d):
        if d == -1:
            return slice(B - lo, B)
        if d == 0:
            return slice(0, B)
        return slice(0, hi)

    ds = ([-1] if lo else []) + [0] + ([1] if hi else [])
    x_slabs = []
    for dx in ds:
        y_slabs = []
        for dy in ds:
            z_parts = [blocks_of((dx + 1) * 9 + (dy + 1) * 3 + (dz + 1))
                       [:, src(dx), src(dy), src(dz)] for dz in ds]
            y_slabs.append(torch.cat(z_parts, dim=3))
        x_slabs.append(torch.cat(y_slabs, dim=2))
    return torch.cat(x_slabs, dim=1)


def gather_halo_sliced(grid_channel, neighbor_slots, *, lo: int = 1,
                       hi: int = 1, fill=0.0) -> torch.Tensor:
    """`gather_halo` by sliced gathers: each neighbour contributes only the
    face, edge or corner the halo needs, written into a `fill`-initialised
    output. Same result."""
    cap = grid_channel.shape[0]
    P = B + lo + hi
    trailing = grid_channel.shape[4:]
    N = neighbor_slots.shape[0]
    out = torch.full((N, P, P, P) + trailing, fill, dtype=grid_channel.dtype,
                     device=grid_channel.device)

    def ranges(d):
        """(destination, source) slices along one axis."""
        if d == -1:
            return slice(0, lo), slice(B - lo, B)
        if d == 0:
            return slice(lo, lo + B), slice(0, B)
        return slice(lo + B, lo + B + hi), slice(0, hi)

    ds = ([-1] if lo else []) + [0] + ([1] if hi else [])
    for dx in ds:
        for dy in ds:
            for dz in ds:
                ns = neighbor_slots[:, (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)]
                (tx, sx), (ty, sy), (tz, sz) = ranges(dx), ranges(dy), \
                    ranges(dz)
                data = grid_channel[ns.clamp(0, cap - 1).long(), sx, sy, sz]
                mask = (ns >= 0).reshape((N,) + (1,) * (data.dim() - 1))
                out[:, tx, ty, tz] = torch.where(
                    mask, data, torch.full((), fill, dtype=data.dtype,
                                           device=data.device))
    return out


def _axis_max(d, cell_axis: int, lcoord, stride: int, fill: float):
    """max(d, its +1 and -1 voxel neighbours along one spatial axis) of a
    dense grid `[Cx, Cy, Cz, 512]`; neighbours outside the grid read
    `fill`. Interior voxels read a lane `stride` away, boundary voxels the
    adjacent cell's first or last plane."""
    cdim = d.shape[cell_axis]
    shape = [1, 1, 1, 1]
    shape[cell_axis] = cdim
    cidx = torch.arange(cdim, device=d.device).view(shape)
    f = torch.full((), fill, dtype=d.dtype, device=d.device)
    up = torch.where(lcoord < 7, torch.roll(d, -stride, dims=-1),
                     torch.roll(torch.roll(d, -1, dims=cell_axis),
                                7 * stride, dims=-1))
    up = torch.where((lcoord == 7) & (cidx == cdim - 1), f, up)
    dn = torch.where(lcoord > 0, torch.roll(d, stride, dims=-1),
                     torch.roll(torch.roll(d, 1, dims=cell_axis),
                                -7 * stride, dims=-1))
    dn = torch.where((lcoord == 0) & (cidx == 0), f, dn)
    return torch.maximum(d, torch.maximum(up, dn))


def dilate_dense_grid_plain(dense, fill: float = 0.0) -> torch.Tensor:
    """3x3x3 voxel max of a dense grid `f32[Cx, Cy, Cz, 512]` (lane =
    (lx*8 + ly)*8 + lz), neighbours outside the grid reading `fill`: the
    reference's separable `axis_max` chain (z, then y, then x)."""
    lane = torch.arange(512, device=dense.device)
    lx, ly, lz = lane // 64, (lane // 8) % 8, lane % 8
    out = _axis_max(dense, 2, lz, 1, fill)
    out = _axis_max(out, 1, ly, 8, fill)
    return _axis_max(out, 0, lx, 64, fill)


_F32 = (torch.float32,)


@torch.no_grad()
def dilate_dense_grid(dense, fill: float = 0.0) -> torch.Tensor:
    """`dilate_dense_grid_plain`, computed by kernel `dilate_dense` for a
    CUDA tensor (the plain version for a CPU tensor). Returns a new
    `f32[Cx, Cy, Cz, 512]` grid; a build or launch failure raises."""
    if dense.device.type == "cpu":
        return dilate_dense_grid_plain(dense, fill)
    what = "dilate_dense_grid"
    if dense.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dense.device}")
    if dense.dim() != 4 or dense.shape[3] != 512:
        raise ValueError(f"{what}: dense must be f32[Cx, Cy, Cz, 512], got "
                         f"{tuple(dense.shape)}")
    kernels.check_tensors(what, dense.device, [("dense", dense, _F32)])
    kernels.check_aligned(what, [("dense", dense)])
    out = torch.empty_like(dense)
    Cx, Cy, Cz = dense.shape[:3]
    lib = kernels.library("dilate")
    err = lib.dilate_dense(dense.data_ptr(), out.data_ptr(), Cx, Cy, Cz,
                           float(fill), kernels.stream_handle(dense))
    kernels.LAUNCHES["dilate_dense"] += 1
    kernels.check("dilate", err, "dilate_dense launch")
    return out


def assemble_dense_grid(values, block_index_of_slot, alloc_count, origin_b,
                        dims_b, fill=0.0):
    """Pool rows `values` (f32[cap, 512]) as a dense `[Cx, Cy, Cz, 512]`
    grid over the `dims_b` blocks at `origin_b` (i32[3]): the slot of each
    cell by a drop-scatter of the slot ids, then one row gather; cells
    without a live block read `fill`. Returns (grid, cell of each slot
    i64[cap] (n_cells outside the region), in-region mask bool[cap])."""
    cap = values.shape[0]
    dev = values.device
    Cx, Cy, Cz = (int(d) for d in dims_b)
    n_cells = Cx * Cy * Cz
    cells = block_index_of_slot - origin_b[None, :]
    live = torch.arange(cap, device=dev) < alloc_count
    in_r = (live & (cells[:, 0] >= 0) & (cells[:, 0] < Cx)
            & (cells[:, 1] >= 0) & (cells[:, 1] < Cy)
            & (cells[:, 2] >= 0) & (cells[:, 2] < Cz))
    lin = (cells[:, 0] * Cy + cells[:, 1]) * Cz + cells[:, 2]
    lin = torch.where(in_r, lin, n_cells).long()
    # Live blocks have distinct cells; every slot outside the region lands
    # on the extra entry n_cells, which is dropped.
    slot_of_cell = torch.full((n_cells + 1,), cap, dtype=torch.int32,
                              device=dev)
    slot_of_cell.index_put_((lin,), torch.arange(cap, dtype=torch.int32,
                                                 device=dev))
    slot_of_cell = slot_of_cell[:n_cells]
    dense = torch.where((slot_of_cell < cap)[:, None],
                        values[slot_of_cell.clamp_max(cap - 1).long()],
                        torch.full((), fill, dtype=values.dtype, device=dev))
    return dense.reshape(Cx, Cy, Cz, 512), lin, in_r


@torch.no_grad()
def dilate_occupancy_dense(values, state, origin_b, *, dims_b, fill=0.0,
                           block_index_of_slot=None, alloc_count=None
                           ) -> torch.Tensor:
    """3x3x3 box-max dilation of a pool channel over a dense block region:
    `assemble_dense_grid`, `dilate_dense_grid`, then the rows gathered
    back. Slots outside the region keep their own value. `state` may be
    None when the caller passes a pool prefix: then `block_index_of_slot`
    and `alloc_count` give its per-slot fields."""
    bidx = (state.block_index_of_slot if block_index_of_slot is None
            else block_index_of_slot)
    n_alloc = state.alloc_count if alloc_count is None else alloc_count
    dense, lin, in_r = assemble_dense_grid(values, bidx, n_alloc, origin_b,
                                           dims_b, fill)
    n_cells = dense[..., 0].numel()
    flat = dilate_dense_grid(dense, fill).reshape(n_cells, 512)
    out = flat[lin.clamp_max(n_cells - 1)]
    return torch.where(in_r[:, None], out, values)
