"""Sensor helper nodes: frame splitting and emitter phase synchronization.

Reference parity (hardware-agnostic re-implementations of the two RealSense
helper packages):

  * `realsense_splitter` (realsense_splitter_node.cpp:34-60): RealSense
    cameras interleave frames with the IR emitter on (good depth) and off
    (clean IR for VSLAM). The splitter routes frames by their emitter-mode
    metadata onto separate outputs.
  * `multi_realsense_emitter_synchronizer` (emitter_synchronizer.cpp): when
    several such cameras run together their emitters interfere; the
    synchronizer nudges each camera's trigger phase so emitter-on windows
    do not overlap.

Here both are transport-agnostic: the splitter is a bus node keyed on a
frame-metadata field; the phase synchronizer is the control loop itself
(compute per-camera phase offsets from observed frame timestamps), with the
actual camera-parameter writes left to a user callback.

A copy of isaac_ros_nvblox_tpu/runtime/sensor_helpers.py for the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence


@dataclasses.dataclass
class FrameMeta:
    """Minimal frame wrapper with the metadata the splitter keys on."""
    data: object
    stamp_s: float
    emitter_on: bool
    camera_name: str = ""


class FrameSplitter:
    """Route frames by emitter state (parity: realsense_splitter).

    Publishes to `<prefix>/emitter_on/<channel>` and
    `<prefix>/emitter_off/<channel>`; only forwards once the emitter mode
    has been observed to alternate (the reference refuses to split when the
    camera is not in emitter-toggling mode).
    """

    def __init__(self, bus, prefix: str = "~/splitter",
                 channel: str = "frame"):
        self._bus = bus
        self._prefix = prefix
        self._channel = channel
        self._last_mode: Optional[bool] = None
        self._seen_both = False

    def callback(self, frame: FrameMeta) -> None:
        if self._last_mode is not None and frame.emitter_on != self._last_mode:
            self._seen_both = True
        self._last_mode = frame.emitter_on
        if not self._seen_both:
            return  # not alternating (yet) — don't forward
        branch = "emitter_on" if frame.emitter_on else "emitter_off"
        self._bus.publish(f"{self._prefix}/{branch}/{self._channel}", frame)


@dataclasses.dataclass
class EmitterSyncParams:
    frame_period_s: float = 1.0 / 30.0
    # Fraction of the period each camera's emitter-on window occupies.
    on_window_fraction: float = 0.5
    correction_gain: float = 0.3


class EmitterPhaseSynchronizer:
    """Phase-lock up to N cameras' emitters (parity: the synchronizer's
    control loop). Feed observed emitter-on frame timestamps per camera;
    `update` returns per-camera phase corrections (seconds) to apply via
    the user's camera-control callback."""

    def __init__(self, camera_names: Sequence[str],
                 params: Optional[EmitterSyncParams] = None,
                 apply_correction: Optional[Callable[[str, float], None]] = None):
        self.names = list(camera_names)
        self.params = params or EmitterSyncParams()
        self.apply_correction = apply_correction
        self._last_on_stamp: Dict[str, float] = {}

    def observe_frame(self, camera: str, stamp_s: float,
                      emitter_on: bool) -> None:
        if emitter_on:
            self._last_on_stamp[camera] = stamp_s

    def update(self) -> Dict[str, float]:
        """Compute phase corrections: camera i's emitter-on window should
        start at phase i/N of the frame period."""
        n = len(self.names)
        period = self.params.frame_period_s
        corrections: Dict[str, float] = {}
        for i, name in enumerate(self.names):
            stamp = self._last_on_stamp.get(name)
            if stamp is None:
                continue
            target_phase = (i / n) * period
            actual_phase = stamp % period
            err = actual_phase - target_phase
            # Wrap to [-period/2, period/2).
            err = (err + period / 2) % period - period / 2
            corr = -self.params.correction_gain * err
            corrections[name] = corr
            if self.apply_correction is not None:
                self.apply_correction(name, corr)
        return corrections
