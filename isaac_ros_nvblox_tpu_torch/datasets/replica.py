"""File-based dataset loaders: Replica, Redwood, 3DMatch (port of
isaac_ros_nvblox_tpu/datasets/replica.py).

Reference: `datasets::{replica,redwood,threedmatch}::createFuser`
(fuser_node.cpp:48-65). Formats (standard public layouts):

  Replica (the NICE-SLAM/vMAP export used by nvblox):
    <root>/traj.txt              — one flattened 4x4 T_W_C per line
    <root>/results/depth{i:06d}.png — 16-bit depth, meters = png / scale
    <root>/results/frame{i:06d}.jpg — RGB
    <root>/cam_params.json       — {"camera": {fx, fy, cx, cy, w, h, scale}}

  3DMatch:
    <root>/camera-intrinsics.txt — 3x3 K
    <root>/seq-01/frame-{i:06d}.depth.png (16-bit, mm)
    <root>/seq-01/frame-{i:06d}.color.png
    <root>/seq-01/frame-{i:06d}.pose.txt — 4x4 T_W_C

  Redwood:
    <root>/depth/*.png (16-bit, mm), <root>/image/*.jpg, <root>/pose.log
    (trajectory-log format: "i i i" header + 4 lines of T_W_C per frame).

PNGs decode with zlib and the host unfilter library, JPEGs through the
host's codec (`io/image_codec.py`); a color file that exists and cannot be
decoded raises.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from isaac_ros_nvblox_tpu_torch.datasets.base import (DataLoader,
                                                      DataLoadResult, Frame)
from isaac_ros_nvblox_tpu_torch.io.image_codec import read_image
from isaac_ros_nvblox_tpu_torch.models.camera import Camera


class ReplicaDataLoader(DataLoader):
    def __init__(self, root, max_frames: Optional[int] = None,
                 frame_stride: int = 1):
        self.root = Path(root)
        cam_file = self.root / "cam_params.json"
        if cam_file.exists():
            cam = json.loads(cam_file.read_text())["camera"]
        else:  # Replica default (vMAP export)
            cam = {"fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5,
                   "w": 1200, "h": 680, "scale": 6553.5}
        self.camera = Camera(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"],
                             cy=cam["cy"], width=int(cam["w"]),
                             height=int(cam["h"]))
        self.depth_scale = float(cam.get("scale", 6553.5))
        self.poses = np.loadtxt(self.root / "traj.txt").reshape(-1, 4, 4)
        self.frame_stride = frame_stride
        n = self.poses.shape[0]
        self.num_frames = min(n, max_frames * frame_stride) if max_frames else n
        self._i = 0

    def load_next(self):
        if self._i >= self.num_frames:
            return DataLoadResult.NO_MORE_DATA, None
        i = self._i
        self._i += self.frame_stride
        depth_path = self.root / "results" / f"depth{i:06d}.png"
        color_path = self.root / "results" / f"frame{i:06d}.jpg"
        if not depth_path.exists():
            return DataLoadResult.BAD_FRAME, None
        depth = read_image(depth_path).astype(np.float32) / self.depth_scale
        color = read_image(color_path) if color_path.exists() else None
        T = self.poses[i].astype(np.float32)
        return DataLoadResult.SUCCESS, Frame(
            depth=depth, T_L_C=T, camera=self.camera, color=color,
            timestamp_s=i / 30.0)


class ThreeDMatchDataLoader(DataLoader):
    def __init__(self, root, seq: str = "seq-01",
                 max_frames: Optional[int] = None):
        self.root = Path(root)
        self.seq_dir = self.root / seq
        K = np.loadtxt(self.root / "camera-intrinsics.txt").reshape(3, 3)
        depth0 = read_image(sorted(self.seq_dir.glob("*.depth.png"))[0])
        h, w = depth0.shape[:2]
        self.camera = Camera(fx=float(K[0, 0]), fy=float(K[1, 1]),
                             cx=float(K[0, 2]), cy=float(K[1, 2]),
                             width=w, height=h)
        n = len(list(self.seq_dir.glob("*.depth.png")))
        self.num_frames = min(n, max_frames) if max_frames else n
        self._i = 0

    def load_next(self):
        if self._i >= self.num_frames:
            return DataLoadResult.NO_MORE_DATA, None
        i = self._i
        self._i += 1
        stem = self.seq_dir / f"frame-{i:06d}"
        try:
            depth = read_image(Path(str(stem) + ".depth.png")) \
                .astype(np.float32) / 1000.0
            T = np.loadtxt(Path(str(stem) + ".pose.txt")).astype(np.float32)
        except (FileNotFoundError, OSError):
            return DataLoadResult.BAD_FRAME, None
        if not np.all(np.isfinite(T)):
            return DataLoadResult.BAD_FRAME, None
        color_path = Path(str(stem) + ".color.png")
        color = read_image(color_path) if color_path.exists() else None
        return DataLoadResult.SUCCESS, Frame(
            depth=depth, T_L_C=T, camera=self.camera, color=color,
            timestamp_s=i / 30.0)


class RedwoodDataLoader(DataLoader):
    def __init__(self, root, max_frames: Optional[int] = None,
                 fx: float = 525.0, fy: float = 525.0,
                 cx: float = 319.5, cy: float = 239.5):
        self.root = Path(root)
        self.depth_files: List[Path] = sorted((self.root / "depth").glob("*.png"))
        self.color_files: List[Path] = sorted((self.root / "image").glob("*.jpg"))
        self.poses = self._read_pose_log(self.root / "pose.log")
        n = min(len(self.depth_files), len(self.poses))
        self.num_frames = min(n, max_frames) if max_frames else n
        d0 = read_image(self.depth_files[0])
        self.camera = Camera(fx=fx, fy=fy, cx=cx, cy=cy,
                             width=d0.shape[1], height=d0.shape[0])
        self._i = 0

    @staticmethod
    def _read_pose_log(path: Path) -> np.ndarray:
        lines = path.read_text().strip().splitlines()
        poses = []
        i = 0
        while i + 4 < len(lines) + 1 and i < len(lines):
            # header line "a b c" then 4 matrix rows
            rows = [list(map(float, lines[i + k + 1].split())) for k in range(4)]
            poses.append(rows)
            i += 5
        return np.asarray(poses, np.float32)

    def load_next(self):
        if self._i >= self.num_frames:
            return DataLoadResult.NO_MORE_DATA, None
        i = self._i
        self._i += 1
        depth = read_image(self.depth_files[i]).astype(np.float32) / 1000.0
        color = (read_image(self.color_files[i])
                 if i < len(self.color_files) else None)
        return DataLoadResult.SUCCESS, Frame(
            depth=depth, T_L_C=self.poses[i], camera=self.camera, color=color,
            timestamp_s=i / 30.0)
