"""ESDF slices -> 2-D distance images and occupancy grids (port of
isaac_ros_nvblox_tpu/ops/esdf_slicer.py).

Reference: nvblox `EsdfSlicer` — `sliceLayersToCombinedDistanceImage`
(min-combine of the static and dynamic layers) and
`occupancyGridFromSliceImage` (trinarization); call-sites
nvblox_node.cpp:135-150, 836-844, 917-919. The slices themselves come from
the device mapper (`mapper/device_io.py`: `slice_esdf_device`,
`slice_esdf_2d_device`) or, for the host-table `Mapper`, from
`slice_esdf_layer` below: a (pixel -> slot) image built on the host from
the BlockTable, then one gather at the slice height. The combiners and the
trinarization run in host numpy on published images.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (VOXELS_PER_SIDE,
                                                   block_size_m, sqrt32)

B = VOXELS_PER_SIDE

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


def compute_slice_spec(table, voxel_size_m: float, slice_height_m: float,
                       padding_px: int = 0) -> Optional[SliceSpec]:
    """The slice covering the allocated blocks' AABB of a BlockTable (None
    for an empty map)."""
    aabb = table.aabb_of_allocated_blocks(voxel_size_m)
    if aabb is None:
        return None
    lo, hi = aabb
    width = int(round((hi[0] - lo[0]) / voxel_size_m)) + 2 * padding_px
    height = int(round((hi[1] - lo[1]) / voxel_size_m)) + 2 * padding_px
    return SliceSpec(
        origin_x_m=float(lo[0]) - padding_px * voxel_size_m,
        origin_y_m=float(lo[1]) - padding_px * voxel_size_m,
        width=width, height=height,
        slice_height_m=slice_height_m, voxel_size_m=voxel_size_m)


def build_slot_image(table, spec: SliceSpec) -> np.ndarray:
    """Host `i32[height, width]`: the slot of the block holding each pixel
    at the slice height (-1 where unallocated)."""
    bs = block_size_m(spec.voxel_size_m)
    bz = int(np.floor(spec.slice_height_m / bs))
    xs = spec.origin_x_m + (np.arange(spec.width) + 0.5) * spec.voxel_size_m
    ys = spec.origin_y_m + (np.arange(spec.height) + 0.5) * spec.voxel_size_m
    bxs = np.floor(xs / bs).astype(np.int64)
    bys = np.floor(ys / bs).astype(np.int64)
    ub_x, inv_x = np.unique(bxs, return_inverse=True)
    ub_y, inv_y = np.unique(bys, return_inverse=True)
    slot_of = np.full((ub_y.size, ub_x.size), -1, np.int32)
    for iy, by in enumerate(ub_y.tolist()):
        for ix, bx in enumerate(ub_x.tolist()):
            slot_of[iy, ix] = table.slot_of((bx, by, bz))
    return slot_of[np.ix_(inv_y, inv_x)]


@torch.no_grad()
def slice_distance_image(esdf_sq_dist, esdf_is_inside, esdf_observed,
                         slot_image, origin_voxel_xy_mod, voxel_z: int, *,
                         voxel_size_m: float, max_distance_m: float,
                         unknown_value: float = 1000.0) -> torch.Tensor:
    """The signed metric distance at the slice height per pixel.

    Args:
      esdf_*: pool channels `[cap, 512]`.
      slot_image: `i32[H, W]` from build_slot_image (-1 = no block).
      origin_voxel_xy_mod: the slice origin's (x, y) voxel index mod 8.
      voxel_z: local z voxel index at the slice height.

    Unknown (unallocated or unobserved) pixels get `unknown_value`
    (DistanceMapSlice.unknown_value, esdf_slice_conversions.cu:81-109).
    """
    cap = esdf_sq_dist.shape[0]
    H, W = slot_image.shape
    dev = esdf_sq_dist.device
    lx = (torch.arange(W, device=dev)[None, :] + int(origin_voxel_xy_mod[0])
          ) % B
    ly = (torch.arange(H, device=dev)[:, None] + int(origin_voxel_xy_mod[1])
          ) % B
    vox = ((lx * B + ly) * B + int(voxel_z)).expand(H, W).reshape(-1)
    slot = slot_image.clamp(0, cap - 1).reshape(-1).long()
    sq = esdf_sq_dist[slot, vox].reshape(H, W)
    inside = esdf_is_inside[slot, vox].reshape(H, W)
    observed = esdf_observed[slot, vox].reshape(H, W)
    dist = sqrt32(torch.clamp_max(sq, 1e12)) * float(np.float32(voxel_size_m))
    dist = torch.clamp_max(dist, float(np.float32(max_distance_m)))
    dist = torch.where(inside, -dist, dist)
    known = (slot_image >= 0) & observed
    return torch.where(known, dist,
                       torch.full((), float(unknown_value), device=dev))


def slice_esdf_layer(pool, table, *, voxel_size_m: float,
                     slice_height_m: float, max_distance_m: float,
                     unknown_value: float = 1000.0,
                     spec: Optional[SliceSpec] = None
                     ) -> Optional[Tuple[SliceSpec, np.ndarray]]:
    """A host-table map's slice: spec, slot image and one gather ->
    (spec, f32[H, W] on the host), or None for an empty map."""
    if spec is None:
        spec = compute_slice_spec(table, voxel_size_m, slice_height_m)
    if spec is None:
        return None
    slot_image = torch.as_tensor(build_slot_image(table, spec),
                                 device=pool.device)
    gz = int(np.floor(spec.slice_height_m / voxel_size_m))
    ox = int(np.floor(spec.origin_x_m / voxel_size_m + 0.5)) % B
    oy = int(np.floor(spec.origin_y_m / voxel_size_m + 0.5)) % B
    img = slice_distance_image(
        pool["esdf_sq_dist"], pool["esdf_is_inside"], pool["esdf_observed"],
        slot_image, (ox, oy), gz % B, voxel_size_m=voxel_size_m,
        max_distance_m=max_distance_m, unknown_value=unknown_value)
    return spec, img.cpu().numpy()


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
