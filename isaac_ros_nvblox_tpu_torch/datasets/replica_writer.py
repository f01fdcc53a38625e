"""Write a Replica-format RGB-D sequence from the synthetic renderer (port
of isaac_ros_nvblox_tpu/datasets/replica_writer.py).

Produces the on-disk layout `datasets/replica.py` reads (traj.txt +
results/depth{i:06d}.png + frame{i:06d}.jpg + cam_params.json, the
NICE-SLAM/vMAP export the reference's replica loader reads,
fuser_node.cpp:48-65), so that the file loaders and the Fuser run end to
end with the analytic scene as ground truth. Depth PNGs are written with
zlib alone (`io/image_codec.py`); colors through the host's JPEG codec.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from isaac_ros_nvblox_tpu_torch.core.types import resolve_device
from isaac_ros_nvblox_tpu_torch.io.image_codec import write_jpeg, write_png
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.scene import (Scene, orbit_pose,
                                                     render_color,
                                                     render_depth)

DEPTH_SCALE = 6553.5  # Replica convention: depth_m = png_u16 / scale


def quantize_depth(depth: np.ndarray) -> np.ndarray:
    """Metric depth f32[H, W] -> the u16 levels of a Replica depth PNG."""
    return np.clip(depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)


def write_replica_sequence(root, scene: Scene, camera: Camera,
                           n_frames: int = 16, orbit_radius: float = 1.5,
                           orbit_height: float = 1.5,
                           target=(0.0, 0.0, 1.0), with_color: bool = True,
                           device=None) -> Path:
    """Render an orbit through `scene` on `device` (`cuda` unless asked
    otherwise) and write it Replica-style under `root`; without
    `with_color` the sequence is depth-only (no JPEG files)."""
    dev = resolve_device(device)
    root = Path(root)
    (root / "results").mkdir(parents=True, exist_ok=True)
    cam = {"fx": camera.fx, "fy": camera.fy, "cx": camera.cx,
           "cy": camera.cy, "w": camera.width, "h": camera.height,
           "scale": DEPTH_SCALE}
    (root / "cam_params.json").write_text(json.dumps({"camera": cam}))

    poses = []
    for i in range(n_frames):
        T = orbit_pose(2 * np.pi * i / n_frames, radius=orbit_radius,
                       height=orbit_height, target=target)
        poses.append(np.asarray(T, np.float64).reshape(-1))
        depth = render_depth(scene, camera, T, device=dev).cpu().numpy()
        write_png(root / "results" / f"depth{i:06d}.png",
                  quantize_depth(depth))
        if with_color:
            color = render_color(scene, camera, T, device=dev).cpu().numpy()
            write_jpeg(root / "results" / f"frame{i:06d}.jpg",
                       np.clip(color, 0, 255).astype(np.uint8))
    np.savetxt(root / "traj.txt", np.stack(poses))
    return root
