"""When each input reaches a node cell, tick by tick.

The harness advances a simulated clock by one tick period each tick and,
before the tick, hands over every pose, depth and color frame and lidar
scan whose time has come: poses at the pose rate, frame k stamped
k / camera rate, scan m stamped m / lidar rate and handed over once it is
complete, at (m + 1) / lidar rate. Frame k shows the lap's image
k mod (frames per lap); scan m the lap's scan m mod (scans per lap). All
rates are whole numbers of Hz and the tick a whole number of ms, so the
schedule is worked out in integers.
"""

from __future__ import annotations

from typing import Dict, List


class NodeSchedule:
    def __init__(self, config: Dict, n_frames: int, n_scans: int):
        r = config["rates_hz"]
        self.tick_ms = int(round(float(config["params"]["node"]
                                       ["tick_period_ms"])))
        self.cam_hz = int(r["camera"])
        self.pose_hz = int(r["pose"])
        self.lidar_hz = int(r.get("lidar", 0))
        self.n_frames, self.n_scans = n_frames, n_scans
        if (1000 % self.pose_hz or (1000 // self.pose_hz) % self.tick_ms):
            raise ValueError("poses must fall on ticks")

    def now(self, i: int) -> float:
        """Tick i's time in seconds, as the harness hands it to the node."""
        return i * self.tick_ms / 1e3

    def pose_due(self, i: int) -> bool:
        return (i * self.tick_ms) % (1000 // self.pose_hz) == 0

    def frames_at(self, i: int) -> List[int]:
        """Frames k handed over before tick i: first tick at or after
        k / camera rate."""
        hi = (i * self.tick_ms * self.cam_hz) // 1000       # last k due
        lo = ((i - 1) * self.tick_ms * self.cam_hz) // 1000 if i else -1
        return list(range(lo + 1, hi + 1))

    def frame_stamp(self, k: int) -> float:
        return k / self.cam_hz

    def scans_at(self, i: int) -> List[int]:
        """Scans m handed over before tick i: first tick at or after
        (m + 1) / lidar rate."""
        if not self.lidar_hz or not self.n_scans:
            return []
        hi = (i * self.tick_ms * self.lidar_hz) // 1000 - 1
        lo = ((i - 1) * self.tick_ms * self.lidar_hz) // 1000 - 1 if i \
            else -1
        return list(range(lo + 1, hi + 1))

    def scan_stamp(self, m: int) -> float:
        return m / self.lidar_hz
