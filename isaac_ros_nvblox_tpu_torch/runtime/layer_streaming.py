"""Layer streaming with a bandwidth budget and block exclusion.

Reference: `serializeSelectedLayers(LayerTypeBitMask, bandwidth_mbps,
BlockExclusionParams{center, height, radius, block_size})`
(layer_publishing.cpp:702-711) — when streaming voxel/mesh blocks to
visualization, the reference limits output to a byte budget per publish and
prioritizes blocks near the robot, excluding blocks outside a radius or
above a height.

Same policy here, as a host-side block scheduler: callers hand it the dirty
block set each tick; `select_blocks` returns the subset to stream now,
spending a running byte budget and preferring never-streamed or
closest-first blocks. Unstreamed dirty blocks stay queued.

A copy of isaac_ros_nvblox_tpu/runtime/layer_streaming.py for the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class BlockExclusionParams:
    """Parity: BlockExclusionParams (layer_publishing.cpp:702-711)."""
    exclusion_center_m: Tuple[float, float] = (0.0, 0.0)
    exclusion_radius_m: float = -1.0   # < 0: no radius exclusion
    exclusion_height_m: float = -1.0   # < 0: no height exclusion


@dataclasses.dataclass
class StreamingParams:
    bandwidth_mbps: float = 30.0       # layer_streamer_bandwidth_limit_mbps
    bytes_per_block: int = 16 * 1024   # approx serialized block size


class LayerStreamer:
    """Budgeted, prioritized block streaming queue."""

    def __init__(self, block_size_m: float,
                 params: Optional[StreamingParams] = None,
                 exclusion: Optional[BlockExclusionParams] = None,
                 clock=time.monotonic):
        self.block_size_m = block_size_m
        self.params = params or StreamingParams()
        self.exclusion = exclusion or BlockExclusionParams()
        self._pending: Dict[Tuple[int, int, int], float] = {}  # idx -> t_dirty
        self._clock = clock
        self._last_publish_t: Optional[float] = None

    def mark_dirty(self, block_indices: Sequence) -> None:
        t = self._clock()
        for bi in block_indices:
            self._pending[tuple(int(v) for v in bi)] = t

    @property
    def num_pending(self) -> int:
        return len(self._pending)

    def _excluded(self, idx: np.ndarray) -> np.ndarray:
        centers = (idx.astype(np.float64) + 0.5) * self.block_size_m
        out = np.zeros(len(idx), bool)
        if self.exclusion.exclusion_radius_m > 0:
            c = np.asarray(self.exclusion.exclusion_center_m)
            d = np.linalg.norm(centers[:, :2] - c, axis=1)
            out |= d > self.exclusion.exclusion_radius_m
        if self.exclusion.exclusion_height_m > 0:
            out |= centers[:, 2] > self.exclusion.exclusion_height_m
        return out

    def select_blocks(self, max_blocks: Optional[int] = None) -> List[Tuple]:
        """Pick blocks to stream now within the bandwidth budget.

        Budget = bandwidth * elapsed-since-last-publish; closest-to-center
        blocks go first (the reference's proximity prioritization).
        Excluded blocks are dropped from the queue entirely.
        """
        if not self._pending:
            return []
        now = self._clock()
        elapsed = (0.1 if self._last_publish_t is None
                   else max(now - self._last_publish_t, 1e-3))
        self._last_publish_t = now
        budget_bytes = self.params.bandwidth_mbps * 1e6 / 8.0 * elapsed
        n_budget = max(int(budget_bytes // self.params.bytes_per_block), 1)
        if max_blocks is not None:
            n_budget = min(n_budget, max_blocks)

        idx = np.asarray(list(self._pending.keys()), np.int64).reshape(-1, 3)
        excluded = self._excluded(idx)
        for bi in idx[excluded]:
            self._pending.pop(tuple(bi), None)
        idx = idx[~excluded]
        if idx.size == 0:
            return []
        centers = (idx.astype(np.float64) + 0.5) * self.block_size_m
        c = np.asarray(self.exclusion.exclusion_center_m)
        order = np.argsort(np.linalg.norm(centers[:, :2] - c, axis=1))
        chosen = idx[order[:n_budget]]
        out = [tuple(bi) for bi in chosen.tolist()]
        for bi in out:
            self._pending.pop(bi, None)
        return out
