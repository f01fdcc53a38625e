"""Recorded-sequence dataset, the rosbag-replay equivalent (port of
isaac_ros_nvblox_tpu/datasets/recorded.py).

Reference: `RosDataLoader` (nvblox_ros/src/lib/rosbag_data_loader.cpp:83-270)
adapts a rosbag2 into the Fuser's dataset interface: per-topic filtered
readers, static transforms preloaded, dynamic transforms streamed ahead of
images by `tf_lead_time_s`, nearest-pose matching.

Without ROS, the equivalent is a directory-of-npz "bag": one `meta.json` +
`frame_%06d.npz` files holding depth/color/timestamp plus `poses.npy`,
written by `SequenceRecorder` and replayed by `RecordedDataLoader`. Pose
resolution uses the online node's `runtime/transformer.py` (poses may be
stored sparsely at their own timestamps, like a /tf stream). The files are
the reference's: each package replays the other's recordings.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from isaac_ros_nvblox_tpu_torch.datasets.base import (DataLoader,
                                                      DataLoadResult, Frame)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.runtime.transformer import Transformer


class SequenceRecorder:
    def __init__(self, directory, camera: Camera):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.camera = camera
        self._poses = []  # (t, T) stream, like /tf
        self._n = 0

    def add_pose(self, timestamp_s: float, T_G_C: np.ndarray) -> None:
        self._poses.append((timestamp_s, np.asarray(T_G_C, np.float32)))

    def add_frame(self, timestamp_s: float, depth: np.ndarray,
                  color: Optional[np.ndarray] = None) -> None:
        payload = {"depth": np.asarray(depth, np.float32),
                   "timestamp_s": np.float64(timestamp_s)}
        if color is not None:
            payload["color"] = np.asarray(color, np.uint8)
        np.savez_compressed(self.dir / f"frame_{self._n:06d}.npz", **payload)
        self._n += 1

    def finish(self) -> None:
        meta = {
            "camera": {"fx": self.camera.fx, "fy": self.camera.fy,
                       "cx": self.camera.cx, "cy": self.camera.cy,
                       "width": self.camera.width,
                       "height": self.camera.height},
            "num_frames": self._n,
            "pose_timestamps": [t for t, _ in self._poses],
        }
        (self.dir / "meta.json").write_text(json.dumps(meta))
        np.save(self.dir / "poses.npy",
                np.stack([T for _, T in self._poses])
                if self._poses else np.zeros((0, 4, 4), np.float32))


class RecordedDataLoader(DataLoader):
    """Bag-style replay: the pose ("/tf") stream is fed to the Transformer
    incrementally, `tf_lead_time_s` ahead of the image stream, not
    preloaded (rosbag_data_loader.cpp:83-150: transforms are read ahead
    of images by tf_lead_time_s so interpolation brackets each frame
    stamp)."""

    def __init__(self, directory, timestamp_tolerance_s: float = 0.1,
                 tf_lead_time_s: float = 0.5):
        self.dir = Path(directory)
        meta = json.loads((self.dir / "meta.json").read_text())
        c = meta["camera"]
        self.camera = Camera(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                             width=c["width"], height=c["height"])
        self.num_frames = meta["num_frames"]
        self.tf_lead_time_s = tf_lead_time_s
        self.transformer = Transformer(
            timestamp_tolerance_s=timestamp_tolerance_s)
        self._pose_ts = [float(t) for t in meta["pose_timestamps"]]
        self._poses = np.load(self.dir / "poses.npy")
        self._pose_cursor = 0
        self._i = 0

    def _stream_tf_until(self, stamp_s: float) -> None:
        """Feed the pose stream up to stamp_s + tf_lead_time_s
        (RosDataLoader::loadNext's update_until = image stamp + lead)."""
        limit = stamp_s + self.tf_lead_time_s
        while (self._pose_cursor < len(self._pose_ts)
               and self._pose_ts[self._pose_cursor] <= limit):
            self.transformer.add_pose(
                "camera", self._pose_ts[self._pose_cursor],
                self._poses[self._pose_cursor])
            self._pose_cursor += 1

    def load_next(self):
        if self._i >= self.num_frames:
            return DataLoadResult.NO_MORE_DATA, None
        i = self._i
        self._i += 1
        path = self.dir / f"frame_{i:06d}.npz"
        if not path.exists():
            return DataLoadResult.BAD_FRAME, None
        with np.load(path) as data:
            depth = data["depth"]
            color = data["color"] if "color" in data.files else None
            t = float(data["timestamp_s"])
        self._stream_tf_until(t)
        T = self.transformer.lookup_transform_to_global_frame("camera", t)
        if T is None:
            # Pose not resolvable at this stamp: a bad frame (the
            # reference's kBadFrame on a TF miss).
            return DataLoadResult.BAD_FRAME, None
        return DataLoadResult.SUCCESS, Frame(
            depth=depth, T_L_C=T, camera=self.camera, color=color,
            timestamp_s=t)
