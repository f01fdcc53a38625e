"""Costmap layer: DistanceMapSlice -> navigation cost grid.

Reference: `NvbloxCostmapLayer` (nvblox_nav2/src/nvblox_costmap_layer.cpp:
33-328) — a Nav2 Costmap2D plugin that consumes the distance slice and
converts distances to costs: lethal inside obstacles, inflated cost within
an inflation radius, interpolated falloff, free beyond; max-merge into the
master grid.

This is the same contract without the ROS plugin scaffolding: a consumer
object subscribed to the message bus, producing a cost grid any planner can
query, with the reference's cost conversion (:184-212).

A copy of isaac_ros_nvblox_tpu/runtime/costmap.py for the port.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from isaac_ros_nvblox_tpu_torch.runtime.msgs import DistanceMapSlice

# Nav2 cost conventions (nav2_costmap_2d).
LETHAL_OBSTACLE = 254
INSCRIBED_INFLATED_OBSTACLE = 253
FREE_SPACE = 0
NO_INFORMATION = 255


@dataclasses.dataclass
class CostmapLayerParams:
    """Parity with the plugin's parameters (nvblox_costmap_layer.cpp:60-77)."""
    inflation_distance_m: float = 0.5
    max_obstacle_distance_m: float = 1.0
    min_distance_m: float = 0.0   # distances below -> lethal
    convert_unknown_to_free: bool = False
    cost_scaling_factor: float = 3.0


def distance_to_cost(distance_m: np.ndarray, unknown_value: float,
                     params: CostmapLayerParams) -> np.ndarray:
    """Vectorized mirror of NvbloxCostmapLayer cost conversion (:184-212).

    distance <= min_distance      -> LETHAL
    distance <  inflation         -> INSCRIBED
    distance <  max_obstacle_dist -> exponential falloff cost
    else                          -> FREE
    unknown                       -> NO_INFORMATION (or FREE if configured)
    """
    d = np.asarray(distance_m, np.float32)
    cost = np.full(d.shape, FREE_SPACE, np.uint8)
    falloff_zone = (d >= params.inflation_distance_m) \
        & (d < params.max_obstacle_distance_m)
    if falloff_zone.any():
        scaled = np.exp(-params.cost_scaling_factor
                        * (d[falloff_zone] - params.inflation_distance_m))
        cost[falloff_zone] = (scaled
                              * (INSCRIBED_INFLATED_OBSTACLE - 1)).astype(np.uint8)
    cost[(d > params.min_distance_m) & (d < params.inflation_distance_m)] = \
        INSCRIBED_INFLATED_OBSTACLE
    cost[d <= params.min_distance_m] = LETHAL_OBSTACLE
    unknown = d == unknown_value
    cost[unknown] = FREE_SPACE if params.convert_unknown_to_free \
        else NO_INFORMATION
    return cost


class NvbloxCostmapLayer:
    """Bus-subscribed costmap consumer with a max-merge master grid."""

    def __init__(self, bus, topic: str = "~/static_map_slice",
                 params: Optional[CostmapLayerParams] = None):
        self.params = params or CostmapLayerParams()
        self._lock = threading.Lock()
        self._slice: Optional[DistanceMapSlice] = None
        self._costs: Optional[np.ndarray] = None
        bus.subscribe(topic, self.slice_callback)

    def slice_callback(self, msg: DistanceMapSlice) -> None:
        """Parity: sliceCallback (nvblox_costmap_layer.cpp:224-296)."""
        with self._lock:
            self._slice = msg
            self._costs = distance_to_cost(msg.data, msg.unknown_value,
                                           self.params)

    @property
    def has_data(self) -> bool:
        return self._costs is not None

    def cost_at(self, x_m: float, y_m: float) -> int:
        """Query the cost at a world position (NO_INFORMATION outside)."""
        with self._lock:
            if self._slice is None:
                return NO_INFORMATION
            s = self._slice
            i = int(np.floor((x_m - s.origin_x_m) / s.resolution_m))
            j = int(np.floor((y_m - s.origin_y_m) / s.resolution_m))
            if not (0 <= i < s.width and 0 <= j < s.height):
                return NO_INFORMATION
            return int(self._costs[j, i])

    def update_costs(self, master_grid: np.ndarray, origin_x_m: float,
                     origin_y_m: float, resolution_m: float) -> None:
        """Max-merge our costs into a master grid (parity: updateCosts,
        nvblox_costmap_layer.cpp:161-222). master_grid is u8[H, W] in the
        master's frame; NO_INFORMATION cells in ours are skipped."""
        with self._lock:
            if self._slice is None:
                return
            s, costs = self._slice, self._costs
        H, W = master_grid.shape
        jj, ii = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        x = origin_x_m + (ii + 0.5) * resolution_m
        y = origin_y_m + (jj + 0.5) * resolution_m
        si = np.floor((x - s.origin_x_m) / s.resolution_m).astype(np.int64)
        sj = np.floor((y - s.origin_y_m) / s.resolution_m).astype(np.int64)
        in_bounds = (si >= 0) & (si < s.width) & (sj >= 0) & (sj < s.height)
        vals = np.full(master_grid.shape, NO_INFORMATION, np.uint8)
        vals[in_bounds] = costs[sj[in_bounds], si[in_bounds]]
        known = vals != NO_INFORMATION
        master_grid[known] = np.maximum(master_grid[known], vals[known])
