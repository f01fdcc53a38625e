"""ESDF slices -> 2-D distance images and occupancy grids (port of the
parts of isaac_ros_nvblox_tpu/ops/esdf_slicer.py that take no host block
table).

Reference: nvblox `EsdfSlicer` — `sliceLayersToCombinedDistanceImage`
(min-combine of the static and dynamic layers) and
`occupancyGridFromSliceImage` (trinarization); call-sites
nvblox_node.cpp:135-150, 836-844, 917-919. The slices themselves come from
the device mapper (`mapper/device_io.py`: `slice_esdf_device`,
`slice_esdf_2d_device`). Host numpy: these run on published images.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Occupancy grid values (Nav2/ROS convention, as nvblox's occupancy grid
# output): -1 unknown, 0 free, 100 occupied.
OCC_UNKNOWN = -1
OCC_FREE = 0
OCC_OCCUPIED = 100


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """Geometry of a 2-D slice: origin (meters), shape, height."""
    origin_x_m: float
    origin_y_m: float
    width: int   # pixels in x
    height: int  # pixels in y
    slice_height_m: float
    voxel_size_m: float


def combine_distance_images(slices, unknown_value: float = 1000.0
                            ) -> np.ndarray:
    """Min-combine aligned distance images `f32[H, W]`; a pixel stays
    unknown only where every image has it unknown."""
    out = None
    for img in slices:
        if out is None:
            out = img.copy()
        else:
            known_any = (out != unknown_value) | (img != unknown_value)
            combined = np.minimum(
                np.where(out == unknown_value, np.inf, out),
                np.where(img == unknown_value, np.inf, img))
            out = np.where(known_any, combined,
                           unknown_value).astype(np.float32)
    return out


def occupancy_grid_from_slice(distance_img: np.ndarray,
                              free_threshold_m: float,
                              unknown_value: float = 1000.0) -> np.ndarray:
    """Trinarize a distance slice into a Nav2-style occupancy grid
    `i8[H, W]`: distance >= threshold -> free, below -> occupied, unknown
    stays unknown."""
    grid = np.full(distance_img.shape, OCC_UNKNOWN, np.int8)
    known = distance_img != unknown_value
    grid[known & (distance_img >= free_threshold_m)] = OCC_FREE
    grid[known & (distance_img < free_threshold_m)] = OCC_OCCUPIED
    return grid
