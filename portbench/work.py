"""The bytes a kernel's work needs, counted from what the inputs require
(the reference's replay says which blocks each frame or scan updates and
which region each ESDF solve covers), not from a program's launch shapes.

  * Projective TSDF fusion: each block a depth frame or a lidar scan must
    update, its 512 voxels' distance and weight read once and written
    once (4 x 4 B each), and the frame's image read once (f32 per pixel
    or range-image cell).
  * EDT: each voxel or cell of the region a solve must cover read once
    and written once as a float32 (the seeded grid in, the squared
    distance out).
"""

from __future__ import annotations

from typing import Dict

VOXELS_PER_BLOCK = 512
TSDF_BYTES_PER_VOXEL = 16      # distance and weight, read and written
F32 = 4


def tsdf_fuse_bytes(work: Dict, image_pixels: int,
                    range_image_cells: int) -> int:
    """Bytes of the window's depth frames and scans."""
    blocks = sum(work["depth_blocks"]) + sum(work.get("scan_blocks", []))
    images = (len(work["depth_blocks"]) * image_pixels
              + len(work.get("scan_blocks", [])) * range_image_cells)
    return blocks * VOXELS_PER_BLOCK * TSDF_BYTES_PER_VOXEL + images * F32


def edt_bytes(work: Dict) -> int:
    """Bytes of the window's ESDF solves: 2-D cells read and written once
    each; 3-D updates count the cells they read and those they write."""
    cells_rw = 2 * sum(work.get("esdf2d_cells", []))
    cells_3d = sum(work.get("esdf_cells", []))
    return (cells_rw + cells_3d) * F32
