"""Device-resident block allocation: the WorldGrid
(port of isaac_ros_nvblox_tpu/core/world_grid.py).

A bounded world volume of blocks holds a dense `slot_grid: i32[Dx,Dy,Dz]`
(-1 = unallocated). Allocation and view compaction are tensor ops on the
device, with no host sync:

  * touched cells are compacted in ascending flat order by a sort of the
    masked iota (the reference's order, so pools compare row for row);
  * new cells take recycled slots first (LIFO from `free_stack`), then
    fresh slots `alloc_count + i`;
  * cells beyond the pool or the batch are dropped and counted in
    `overflow_count`.

The state's tensors keep the reference's int32 dtypes. `allocate_and_batch`
updates `slot_grid` and `block_index_of_slot` in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (device_constant,
                                                   resolve_device,
                                                   set_rows_drop)

# block_index_of_slot value marking a freed (recyclable) slot.
FREED_BLOCK_SENTINEL = 1 << 20

# The 27-neighbourhood order of the reference's core/block_pool.py
# (x-major, z-fastest; entry 13 is the block itself).
NEIGHBOR_OFFSETS: np.ndarray = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
     for dz in (-1, 0, 1)], dtype=np.int32)

# Self + the 7 positive-octant directions, in the mesh kernel's order
# (ops/mesh_cuda.py NEIGHBOR_COLS gives their NEIGHBOR_OFFSETS columns).
OCTANT_OFFSETS: np.ndarray = np.array(
    [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1),
     (0, 1, 1), (1, 1, 1)], dtype=np.int32)

_I32 = torch.int32


@dataclasses.dataclass
class WorldGridState:
    """Device state of the allocator. The live-block count is
    `alloc_count - free_count`."""
    slot_grid: torch.Tensor            # i32[Dx, Dy, Dz], -1 = unallocated
    block_index_of_slot: torch.Tensor  # i32[cap, 3] world block per slot
    alloc_count: torch.Tensor          # i32[] fresh-slot high-water mark
    overflow_count: torch.Tensor       # i32[] blocks dropped (pool/batch)
    origin_block: torch.Tensor         # i32[3] world block of grid cell 0
    free_stack: torch.Tensor           # i32[cap] recyclable slot ids
    free_count: torch.Tensor           # i32[] entries in free_stack

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Copies of the fields (the state is updated in place)."""
        return {f.name: np.array(getattr(self, f.name).cpu().numpy())
                for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, arrays, device) -> "WorldGridState":
        return cls(**{f.name: torch.tensor(np.asarray(arrays[f.name]),
                                           dtype=_I32, device=device)
                      for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class WorldGridConfig:
    dims: Tuple[int, int, int] = (128, 128, 32)
    capacity: int = 32768
    origin_block: Tuple[int, int, int] = (-64, -64, -8)


def create_world_grid(config: WorldGridConfig, device=None) -> WorldGridState:
    dev = resolve_device(device)

    def scalar():
        return torch.zeros((), dtype=_I32, device=dev)

    return WorldGridState(
        slot_grid=torch.full(config.dims, -1, dtype=_I32, device=dev),
        block_index_of_slot=torch.zeros((config.capacity, 3), dtype=_I32,
                                        device=dev),
        alloc_count=scalar(),
        overflow_count=scalar(),
        origin_block=torch.as_tensor(config.origin_block, dtype=_I32,
                                     device=dev),
        free_stack=torch.zeros((config.capacity,), dtype=_I32, device=dev),
        free_count=scalar(),
    )


def live_slot_mask(state: WorldGridState) -> torch.Tensor:
    """bool[cap]: slot holds a live (allocated, not freed) block."""
    cap = state.block_index_of_slot.shape[0]
    ar = torch.arange(cap, device=state.alloc_count.device)
    return ((ar < state.alloc_count)
            & (state.block_index_of_slot[:, 0] < FREED_BLOCK_SENTINEL))


def _mask_window(mask_grid, mask_origin_block, state: WorldGridState):
    """Align the touched mask with a window of the slot grid.

    Returns (touched bool[Wx, Wy, Wz], st i32[3]) with W = min(G, D) per
    axis: st is the window's start cell in the slot grid and touched[w] is
    the mask value of grid cell st + w (False outside the mask).
    """
    G = mask_grid.shape[0]
    D = state.slot_grid.shape
    W = tuple(min(G, d) for d in D)
    dev = mask_grid.device
    o = mask_origin_block - state.origin_block
    st = torch.stack([o[a].clamp(0, D[a] - W[a]) for a in range(3)])
    # Mask coordinate of window cell 0 along each axis, then a gather of
    # the window (cells outside the mask read False).
    m0 = st - o
    axes = []
    for a in range(3):
        c = m0[a] + torch.arange(W[a], device=dev)
        axes.append((c, (c >= 0) & (c < G)))
    ix, iy, iz = (c.clamp(0, G - 1).long() for c, _ in axes)
    inside = (axes[0][1][:, None, None] & axes[1][1][None, :, None]
              & axes[2][1][None, None, :])
    touched = mask_grid[ix[:, None, None], iy[None, :, None],
                        iz[None, None, :]] & inside
    return touched, st


@torch.no_grad()
def allocate_and_batch(state: WorldGridState, mask_grid, mask_origin_block,
                       *, max_blocks: int):
    """Allocate the touched cells and compact them into a view batch.

    Returns (state, slots i32[max_blocks], block_indices i32[max_blocks,3],
    n_valid i32[]). Padding and dropped entries carry slot == capacity.
    Touched cells beyond max_blocks are not allocated this frame (counted
    in overflow_count). `slot_grid` and `block_index_of_slot` are updated
    in place; the returned state holds the new counters.
    """
    cap = state.block_index_of_slot.shape[0]
    dev = mask_grid.device
    touched, st = _mask_window(mask_grid, mask_origin_block, state)
    Wx, Wy, Wz = touched.shape
    flat = touched.reshape(-1)
    M = flat.shape[0]
    big = 2 ** 30
    keys = torch.where(flat, torch.arange(M, dtype=_I32, device=dev),
                       torch.full((), big, dtype=_I32, device=dev))
    keys = torch.sort(keys).values[:max_blocks]
    if keys.shape[0] < max_blocks:
        keys = torch.cat([keys, torch.full((max_blocks - keys.shape[0],), big,
                                           dtype=_I32, device=dev)])
    idx = torch.where(keys < big, keys, M - 1)
    n_touched = flat.sum(dtype=_I32)
    n_sel = torch.clamp_max(n_touched, max_blocks)
    lane = torch.arange(max_blocks, device=dev) < n_sel
    safe_idx = torch.where(lane, idx, 0)
    cells = torch.stack([safe_idx // (Wy * Wz), (safe_idx // Wz) % Wy,
                         safe_idx % Wz], -1) + st
    cl = cells.long()
    current = state.slot_grid[cl[:, 0], cl[:, 1], cl[:, 2]]
    is_new = lane & (current < 0)
    order = torch.cumsum(is_new, 0, dtype=_I32) - 1
    # Recycle freed slots first (LIFO), then take fresh ones.
    reuse = is_new & (order < state.free_count)
    stack_idx = (state.free_count - 1 - order).clamp(0, cap - 1)
    recycled = state.free_stack[stack_idx.long()]
    fresh = state.alloc_count + (order - state.free_count)
    new_slot = torch.where(reuse, recycled, fresh)
    ok = is_new & (new_slot < cap)
    slots = torch.where(ok, new_slot,
                        torch.where(lane & ~is_new, current,
                                    torch.full_like(current, cap)))

    # Record the new slots (entries that are not ok are dropped).
    Dx, Dy, Dz = state.slot_grid.shape
    lin = (cells[:, 0] * Dy + cells[:, 1]) * Dz + cells[:, 2]
    set_rows_drop(state.slot_grid.view(-1),
                  torch.where(ok, lin, torch.full_like(lin, -1)), new_slot)
    world_block = cells + state.origin_block
    bidx = torch.where(lane[:, None], world_block, torch.zeros_like(world_block))
    set_rows_drop(state.block_index_of_slot,
                  torch.where(ok, new_slot, torch.full_like(new_slot, cap)),
                  world_block)

    n_ok = ok.sum(dtype=_I32)
    n_reused = reuse.sum(dtype=_I32)
    n_overflow = (is_new & ~ok).sum(dtype=_I32) + (n_touched - n_sel)
    state = dataclasses.replace(
        state,
        alloc_count=state.alloc_count + (n_ok - n_reused),
        overflow_count=state.overflow_count + n_overflow,
        free_count=state.free_count - n_reused)
    return state, slots, bidx, n_sel


@torch.no_grad()
def allocate_from_mask(state: WorldGridState, mask_grid, mask_origin_block
                       ) -> WorldGridState:
    """Allocate slots for the touched, in-grid, unallocated cells of a mask
    `bool[G, G, G]` whose cell 0 is world block `mask_origin_block` (i32[3]).

    The i-th new cell in flat mask order takes a recycled slot (LIFO from
    `free_stack`) or the fresh slot `alloc_count + i`; cells past capacity
    are dropped and counted in `overflow_count`. `slot_grid` and
    `block_index_of_slot` are updated in place; the returned state holds
    the new counters. No host sync.
    """
    cap = state.block_index_of_slot.shape[0]
    dev = mask_grid.device
    G = mask_grid.shape[0]
    D = state.slot_grid.shape
    r = torch.arange(G, dtype=_I32, device=dev)
    cells = (torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
             + (mask_origin_block - state.origin_block)).reshape(-1, 3)
    current = _slots_at(state, cells)
    is_new = mask_grid.reshape(-1) & _in_grid(cells, D) & (current < 0)
    order = torch.cumsum(is_new, 0, dtype=_I32) - 1
    # Recycle freed slots first (LIFO), then take fresh ones.
    reuse = order < state.free_count
    stack_idx = (state.free_count - 1 - order).clamp(0, cap - 1)
    recycled = state.free_stack[stack_idx.long()]
    fresh = state.alloc_count + (order - state.free_count)
    new_slot = torch.where(reuse, recycled, fresh)
    ok = is_new & (new_slot < cap)
    lin = (cells[:, 0] * D[1] + cells[:, 1]) * D[2] + cells[:, 2]
    set_rows_drop(state.slot_grid.view(-1),
                  torch.where(ok, lin, torch.full_like(lin, -1)), new_slot)
    set_rows_drop(state.block_index_of_slot,
                  torch.where(ok, new_slot, torch.full_like(new_slot, cap)),
                  cells + state.origin_block)
    n_ok = ok.sum(dtype=_I32)
    n_reused = (ok & reuse).sum(dtype=_I32)
    return dataclasses.replace(
        state,
        alloc_count=state.alloc_count + (n_ok - n_reused),
        overflow_count=state.overflow_count
        + (is_new & ~ok).sum(dtype=_I32),
        free_count=state.free_count - n_reused)


@torch.no_grad()
def free_slots(state: WorldGridState, slots_to_free) -> WorldGridState:
    """Deallocate the given slots `i32[N]` and recycle their storage.

    Clears their slot_grid cells, marks their rows with
    FREED_BLOCK_SENTINEL and pushes them onto `free_stack` in input order
    (allocation pops it LIFO). Out-of-range and already-freed entries are
    ignored. `slot_grid`, `block_index_of_slot` and `free_stack` are updated
    in place; the returned state holds the new `free_count`. Callers reset
    the freed rows' channels.
    """
    cap = state.block_index_of_slot.shape[0]
    safe = slots_to_free.clamp(0, cap - 1)
    bidx = state.block_index_of_slot[safe.long()]
    ok = ((slots_to_free >= 0) & (slots_to_free < cap)
          & (safe < state.alloc_count)
          & (bidx[:, 0] < FREED_BLOCK_SENTINEL))
    D = state.slot_grid.shape
    cells = bidx - state.origin_block
    c = [cells[:, a].clamp(0, D[a] - 1) for a in range(3)]
    lin = (c[0] * D[1] + c[1]) * D[2] + c[2]
    set_rows_drop(state.slot_grid.view(-1),
                  torch.where(ok, lin, torch.full_like(lin, -1)), -1)
    set_rows_drop(state.block_index_of_slot,
                  torch.where(ok, safe, torch.full_like(safe, cap)),
                  FREED_BLOCK_SENTINEL)
    order = torch.cumsum(ok, 0, dtype=_I32) - 1
    set_rows_drop(state.free_stack,
                  torch.where(ok, state.free_count + order,
                              torch.full_like(order, cap)), safe)
    return dataclasses.replace(
        state, free_count=state.free_count + ok.sum(dtype=_I32))


def _in_grid(cells, dims) -> torch.Tensor:
    """bool[...]: cells `i32[..., 3]` lie inside a grid of shape `dims`
    (compared axis by axis with Python ints: no host->device copy)."""
    ok = (cells[..., 0] >= 0) & (cells[..., 0] < dims[0])
    for a in (1, 2):
        ok = ok & (cells[..., a] >= 0) & (cells[..., a] < dims[a])
    return ok


def _slots_at(state: WorldGridState, cells) -> torch.Tensor:
    """slot_grid at cells `i32[..., 3]`; out-of-grid cells give -1."""
    D = state.slot_grid.shape
    safe = [cells[..., a].clamp(0, D[a] - 1).long() for a in range(3)]
    slots = state.slot_grid[safe[0], safe[1], safe[2]]
    return torch.where(_in_grid(cells, D), slots, torch.full_like(slots, -1))


@torch.no_grad()
def view_batch(state: WorldGridState, mask_grid, mask_origin_block, *,
               max_blocks: int):
    """Compact the touched, allocated cells into a static-size batch (no
    allocation).

    Returns (slots i32[max_blocks], block_indices i32[max_blocks, 3],
    n_valid i32[]), in ascending mask order. Padding entries carry
    slot == capacity and block index 0.
    """
    cap = state.block_index_of_slot.shape[0]
    dev = mask_grid.device
    G = mask_grid.shape[0]
    r = torch.arange(G, dtype=_I32, device=dev)
    world = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1) \
        + (mask_origin_block - state.origin_block)
    cells = world.reshape(-1, 3)
    slot = _slots_at(state, cells)
    good = mask_grid.reshape(-1) & (slot >= 0)
    M = good.shape[0]
    big = 2 ** 30
    keys = torch.where(good, torch.arange(M, dtype=_I32, device=dev),
                       torch.full((), big, dtype=_I32, device=dev))
    keys = torch.sort(keys).values[:max_blocks]
    if keys.shape[0] < max_blocks:
        keys = torch.cat([keys, torch.full((max_blocks - keys.shape[0],), big,
                                           dtype=_I32, device=dev)])
    idx = torch.where(keys < big, keys, M - 1).long()
    n_valid = good.sum(dtype=_I32)
    lane = torch.arange(max_blocks, device=dev) < n_valid
    slots = torch.where(lane, slot[idx], torch.full((), cap, dtype=_I32,
                                                     device=dev))
    bidx = torch.where(lane[:, None], cells[idx] + state.origin_block,
                       torch.zeros((), dtype=_I32, device=dev))
    return slots, bidx, n_valid


def neighbor_slots_of(state: WorldGridState, block_indices) -> torch.Tensor:
    """Neighbour slot rows `i32[N, 27]` for world block indices `i32[N, 3]`,
    in NEIGHBOR_OFFSETS order; out-of-world neighbours and unallocated
    cells give -1."""
    offs = device_constant(NEIGHBOR_OFFSETS, block_indices.device)
    cells = (block_indices - state.origin_block)[:, None, :] + offs[None]
    return _slots_at(state, cells)


def neighbor_slots8_of(state: WorldGridState, block_indices) -> torch.Tensor:
    """Self + positive-octant neighbour slots `i32[N, 8]` (OCTANT_OFFSETS
    order); out-of-world neighbours and unallocated cells give -1."""
    offs = device_constant(OCTANT_OFFSETS, block_indices.device)
    cells = (block_indices - state.origin_block)[:, None, :] + offs[None]
    return _slots_at(state, cells)


def allocated_batch(state: WorldGridState, *, max_blocks: int):
    """All allocated slots as a static-size batch, as full-map passes take
    them: `allocated_batch_range` from slot 0 (slots at or beyond
    alloc_count carry slot == capacity, block index 0; n is
    min(alloc_count, max_blocks))."""
    return allocated_batch_range(state, 0, max_blocks=max_blocks)


def allocated_batch_range(state: WorldGridState, start: int, *,
                          max_blocks: int):
    """Allocated slots [start, start + max_blocks) as a static-size batch:
    (slots i32[max_blocks], block_indices i32[max_blocks, 3], n i32[]).
    Slots at or beyond alloc_count carry slot == capacity, block index 0."""
    cap = state.block_index_of_slot.shape[0]
    dev = state.alloc_count.device
    slots = start + torch.arange(max_blocks, dtype=_I32, device=dev)
    valid = slots < state.alloc_count
    bidx = torch.where(valid[:, None],
                       state.block_index_of_slot[slots.clamp_max(cap - 1)
                                                 .long()],
                       torch.zeros((), dtype=_I32, device=dev))
    n = (state.alloc_count - start).clamp(0, max_blocks)
    return (torch.where(valid, slots, torch.full((), cap, dtype=_I32,
                                                  device=dev)), bidx, n)
