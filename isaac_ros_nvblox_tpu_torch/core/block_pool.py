"""Block pool of the host-table Mapper, the debug backend (port of
isaac_ros_nvblox_tpu/core/block_pool.py).

The reference stores each layer as a spatial hash of 8x8x8 voxel blocks.
Here, as in the JAX package's debug backend:

  * a **slot pool**: every voxel channel is a dense tensor
    `[capacity, 512, ...]` on the mapper's device (512 = 8^3 voxels, x-major,
    z fastest); it grows, keeping its contents, when the table runs out;
  * a **host index**: `dict[(bx, by, bz) -> slot]` plus a free list; block
    allocation is slot assignment on the host, so every allocation reads
    the view back from the device (by design: this is the debug backend);
  * a **neighbour table** `i32[capacity, 27]` with the slot of each block of
    a block's 27-neighbourhood (-1 if absent), kept up to date on every
    allocation and free, so that the ESDF sweeps and marching cubes gather
    halos by slot.

The device-resident allocator of the production path is
`core/world_grid.py`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (VOXELS_PER_BLOCK,
                                                   VOXELS_PER_SIDE,
                                                   block_size_m,
                                                   resolve_device)

# 27-neighbourhood offsets in a fixed order; index 13 is (0,0,0) == self.
NEIGHBOR_OFFSETS: np.ndarray = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)
SELF_NEIGHBOR_INDEX: int = 13


def pad_to_bucket(n: int, minimum: int = 64) -> int:
    """Round `n` up to a power-of-two bucket (batch shapes stay few)."""
    if n <= 0:
        return minimum
    b = minimum
    while b < n:
        b *= 2
    return b


class BlockTable:
    """Host block index: (bx, by, bz) -> slot, free list, neighbour table.

    One table is shared by all voxel layers of a mapper (they are allocated
    together by the view calculator, as the reference allocates its
    TSDF/color/mesh/ESDF blocks for the same view).
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._index: Dict[Tuple[int, int, int], int] = {}
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self.block_indices = np.zeros((self.capacity, 3), np.int32)
        self.allocated = np.zeros((self.capacity,), bool)
        self.neighbors = np.full((self.capacity, 27), -1, np.int32)
        self._generation = 0  # bumped on every allocate/free batch

    # ------------------------------------------------------------------ sizes
    @property
    def num_allocated(self) -> int:
        return self.capacity - len(self._free)

    @property
    def generation(self) -> int:
        return self._generation

    def __contains__(self, idx: Tuple[int, int, int]) -> bool:
        return tuple(int(v) for v in idx) in self._index

    def slot_of(self, idx: Tuple[int, int, int]) -> int:
        """Slot of block `idx`, or -1."""
        return self._index.get(tuple(int(v) for v in idx), -1)

    def allocated_slots(self) -> np.ndarray:
        return np.nonzero(self.allocated)[0].astype(np.int32)

    def allocated_block_indices(self) -> np.ndarray:
        return self.block_indices[self.allocated]

    # ------------------------------------------------------------- allocation
    def allocate(self, indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Ensure blocks exist; return (slots i32[M], newly_allocated
        bool[M]).

        `indices` is `i32[M, 3]` (duplicates allowed). Raises MemoryError
        when the capacity is exhausted: callers grow the pool first
        (`BlockPool.ensure_capacity`).
        """
        indices = np.asarray(indices, np.int32).reshape(-1, 3)
        slots = np.empty((indices.shape[0],), np.int32)
        fresh = np.zeros((indices.shape[0],), bool)
        new_any = False
        for i, key in enumerate(map(tuple, indices.tolist())):
            slot = self._index.get(key)
            if slot is None:
                if not self._free:
                    raise MemoryError(
                        f"BlockTable capacity {self.capacity} exhausted")
                slot = self._free.pop()
                self._index[key] = slot
                self.block_indices[slot] = key
                self.allocated[slot] = True
                self._wire_neighbors(key, slot)
                fresh[i] = True
                new_any = True
            slots[i] = slot
        if new_any:
            self._generation += 1
        return slots, fresh

    def free(self, indices: Iterable[Tuple[int, int, int]]) -> np.ndarray:
        """Deallocate blocks; returns the freed slots."""
        freed = []
        for key in indices:
            key = tuple(int(v) for v in key)
            slot = self._index.pop(key, None)
            if slot is None:
                continue
            self.allocated[slot] = False
            self._unwire_neighbors(key, slot)
            self._free.append(slot)
            freed.append(slot)
        if freed:
            self._generation += 1
        return np.asarray(freed, np.int32)

    def _wire_neighbors(self, key: Tuple[int, int, int], slot: int) -> None:
        bx, by, bz = key
        for n, (dx, dy, dz) in enumerate(NEIGHBOR_OFFSETS.tolist()):
            nslot = self._index.get((bx + dx, by + dy, bz + dz))
            self.neighbors[slot, n] = -1 if nslot is None else nslot
            if nslot is not None:
                # The reciprocal offset position: 26 - n.
                self.neighbors[nslot, 26 - n] = slot

    def _unwire_neighbors(self, key: Tuple[int, int, int], slot: int) -> None:
        bx, by, bz = key
        for n, (dx, dy, dz) in enumerate(NEIGHBOR_OFFSETS.tolist()):
            nslot = self._index.get((bx + dx, by + dy, bz + dz))
            if nslot is not None:
                self.neighbors[nslot, 26 - n] = -1
        self.neighbors[slot, :] = -1

    # -------------------------------------------------------------- geometry
    def aabb_of_allocated_blocks(self, voxel_size_m: float):
        """(min_m f64[3], max_m f64[3]) over allocated blocks, or None
        (getAABBOfAllocatedBlocks, esdf_and_gradients_conversions.cu:65)."""
        if self.num_allocated == 0:
            return None
        bs = block_size_m(voxel_size_m)
        idx = self.allocated_block_indices().astype(np.float64)
        return idx.min(axis=0) * bs, (idx.max(axis=0) + 1.0) * bs

    def grow(self, new_capacity: int) -> None:
        if new_capacity <= self.capacity:
            raise ValueError(f"grow: {new_capacity} <= {self.capacity}")
        extra = new_capacity - self.capacity
        self.block_indices = np.concatenate(
            [self.block_indices, np.zeros((extra, 3), np.int32)])
        self.allocated = np.concatenate([self.allocated,
                                         np.zeros((extra,), bool)])
        self.neighbors = np.concatenate(
            [self.neighbors, np.full((extra, 27), -1, np.int32)])
        self._free = (list(range(new_capacity - 1, self.capacity - 1, -1))
                      + self._free)
        self.capacity = new_capacity
        self._generation += 1


class BlockPool:
    """Named voxel channels over one shared BlockTable.

    Channels are tensors on `device` (`cuda` unless the caller asks for
    another) with leading shape `[capacity, 512]` plus optional trailing
    dims, e.g. `tsdf_distance: f32[cap, 512]`, `esdf_site:
    f32[cap, 512, 3]`; `channel_specs` maps each name to (trailing shape,
    torch dtype). Slots are reset to their fill values when allocated
    (`reset_slots`).
    """

    def __init__(self, table: BlockTable,
                 channel_specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 init_values: Optional[Dict[str, float]] = None,
                 device=None):
        self.table = table
        self.device = resolve_device(device)
        self.channel_specs = dict(channel_specs)
        self.init_values = dict(init_values or {})
        self.channels: Dict[str, torch.Tensor] = {}
        for name, (trailing, dtype) in self.channel_specs.items():
            self.channels[name] = self._filled(name, table.capacity, trailing,
                                               dtype)

    def _filled(self, name, rows, trailing, dtype) -> torch.Tensor:
        return torch.full((rows, VOXELS_PER_BLOCK) + tuple(trailing),
                          self.init_values.get(name, 0), dtype=dtype,
                          device=self.device)

    def reset_slots(self, slots: np.ndarray) -> None:
        """Re-initialize the given slots to their fill values."""
        if slots.size == 0:
            return
        s = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        for name, ch in self.channels.items():
            ch[s] = torch.full((), self.init_values.get(name, 0),
                               dtype=ch.dtype, device=self.device)

    def ensure_capacity(self, needed_free: int) -> None:
        """Grow table + channels if fewer than `needed_free` slots remain;
        the rows already allocated keep their contents."""
        free = self.table.capacity - self.table.num_allocated
        if free >= needed_free:
            return
        new_cap = max(self.table.capacity * 2,
                      self.table.capacity + needed_free)
        old_cap = self.table.capacity
        self.table.grow(new_cap)
        for name, arr in self.channels.items():
            pad = self._filled(name, new_cap - old_cap, arr.shape[2:],
                               arr.dtype)
            self.channels[name] = torch.cat([arr, pad], dim=0)

    # Convenience accessors -------------------------------------------------
    def __getitem__(self, name: str) -> torch.Tensor:
        return self.channels[name]

    def __setitem__(self, name: str, value: torch.Tensor) -> None:
        if value.shape != self.channels[name].shape:
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(self.channels[name].shape)}")
        self.channels[name] = value

    def gather(self, name: str, slots) -> torch.Tensor:
        return self.channels[name][torch.as_tensor(
            np.asarray(slots, np.int64), device=self.device)]

    def voxel_grid_view(self, name: str) -> torch.Tensor:
        """Channel reshaped to `[cap, 8, 8, 8, ...]` (x, y, z voxel order)."""
        arr = self.channels[name]
        return arr.view((arr.shape[0],) + (VOXELS_PER_SIDE,) * 3
                        + tuple(arr.shape[2:]))
