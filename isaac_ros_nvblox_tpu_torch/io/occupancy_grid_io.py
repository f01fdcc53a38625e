"""Occupancy-grid PNG + YAML export in the Nav2 map_server format (port of
isaac_ros_nvblox_tpu/io/occupancy_grid_io.py).

Reference: `conversions::saveOccupancyGridAsPng` / `saveOccupancyGridYaml`
(nvblox_node.cpp:156-166: the shutdown hook exports the 2-D map).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from isaac_ros_nvblox_tpu_torch.ops.esdf_slicer import (OCC_FREE,
                                                        OCC_OCCUPIED)


def save_occupancy_grid_png(path, grid: np.ndarray) -> None:
    """Trinary grid i8[H, W] -> PGM-convention PNG: free 254 (white),
    occupied 0 (black), unknown 205 (gray); row 0 at the map's top."""
    import imageio.v2 as imageio
    img = np.full(grid.shape, 205, np.uint8)
    img[grid == OCC_FREE] = 254
    img[grid == OCC_OCCUPIED] = 0
    # y points up in the map: flip the rows.
    imageio.imwrite(Path(path), img[::-1])


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
