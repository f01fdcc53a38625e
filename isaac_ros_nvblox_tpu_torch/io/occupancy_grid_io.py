"""Occupancy-grid PNG + YAML export in the Nav2 map_server format (port of
isaac_ros_nvblox_tpu/io/occupancy_grid_io.py).

Reference: `conversions::saveOccupancyGridAsPng` / `saveOccupancyGridYaml`
(nvblox_node.cpp:156-166: the shutdown hook exports the 2-D map).

The PNG is encoded here with zlib alone (no image library), byte for byte
as the reference's writer (imageio through Pillow) encodes an 8-bit gray
image: per row the adaptive filter of least absolute sum, deflate level 6
with the filtered strategy, IDAT chunks of max(65536, 4 * width) bytes.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from isaac_ros_nvblox_tpu_torch.ops.esdf_slicer import (OCC_FREE,
                                                        OCC_OCCUPIED)


def _png_filtered_rows(img: np.ndarray) -> bytes:
    """The filtered scanlines of a u8[H, W] image: each row gets the filter
    (none, sub, up, average, Paeth) whose bytes, read as signed, have the
    least absolute sum; ties go to the first of none, up, sub, average,
    Paeth."""
    cur = img.astype(np.int32)
    up = np.vstack([np.zeros((1, cur.shape[1]), np.int32), cur[:-1]])
    left = np.hstack([np.zeros((cur.shape[0], 1), np.int32), cur[:, :-1]])
    upleft = np.hstack([np.zeros((cur.shape[0], 1), np.int32), up[:, :-1]])
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    cands = np.stack([cur, cur - left, cur - up, cur - (left + up) // 2,
                      cur - paeth]) % 256
    cost = np.minimum(cands, 256 - cands).sum(axis=2)
    order = np.asarray([0, 2, 1, 3, 4])
    best = order[np.argmin(cost[order], axis=0)]
    rows = cands[best, np.arange(cur.shape[0])].astype(np.uint8)
    return np.hstack([best[:, None].astype(np.uint8), rows]).tobytes()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_gray8(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG of u8[H, W]."""
    H, W = img.shape
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(_png_filtered_rows(img)) + z.flush()
    step = max(65536, 4 * W)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
            + b"".join(_png_chunk(b"IDAT", data[i:i + step])
                       for i in range(0, len(data), step))
            + _png_chunk(b"IEND", b""))


def save_occupancy_grid_png(path, grid: np.ndarray) -> None:
    """Trinary grid i8[H, W] -> PGM-convention PNG: free 254 (white),
    occupied 0 (black), unknown 205 (gray); row 0 at the map's top."""
    img = np.full(grid.shape, 205, np.uint8)
    img[grid == OCC_FREE] = 254
    img[grid == OCC_OCCUPIED] = 0
    # y points up in the map: flip the rows.
    Path(path).write_bytes(encode_png_gray8(np.ascontiguousarray(img[::-1])))


def save_occupancy_grid_yaml(path, png_filename: str, resolution_m: float,
                             origin_x_m: float, origin_y_m: float,
                             occupied_thresh: float = 0.65,
                             free_thresh: float = 0.196) -> None:
    """Nav2 map_server YAML metadata."""
    text = (f"image: {png_filename}\n"
            f"resolution: {resolution_m}\n"
            f"origin: [{origin_x_m}, {origin_y_m}, 0.0]\n"
            f"negate: 0\n"
            f"occupied_thresh: {occupied_thresh}\n"
            f"free_thresh: {free_thresh}\n")
    Path(path).write_text(text)


def save_occupancy_grid(directory, name: str, grid: np.ndarray,
                        resolution_m: float, origin_x_m: float,
                        origin_y_m: float) -> None:
    """`<name>.png` and `<name>.yaml` in `directory`."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    save_occupancy_grid_png(d / f"{name}.png", grid)
    save_occupancy_grid_yaml(d / f"{name}.yaml", f"{name}.png", resolution_m,
                             origin_x_m, origin_y_m)
