"""Timing / Rates / Delays registries (port of
isaac_ros_nvblox_tpu/utils/timing.py).

nvblox's three singleton observability registries: `timing::Timer`
hierarchical spans, `timing::Rates` tick meters, `timing::Delays`
message-stamp latency meters, each printable and dumpable through the
node's services, with an injectable clock for deterministic tests.

A span measures host wall time. `Timer.set_block(value)` makes the span
wait, before it closes, until the device work behind `value` (a tensor or
a nest of them) is done: a CUDA event recorded on the current stream and
synchronized. Without it the span stays host-only and adds no sync.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict

import torch


class _SpanStats:
    __slots__ = ("count", "total", "total_sq", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.total_sq = 0.0
        self.min = math.inf
        self.max = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.total_sq += dt * dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        var = self.total_sq / self.count - self.mean ** 2
        return math.sqrt(max(var, 0.0))


class TimingRegistry:
    """Hierarchical span timing (parity: nvblox timing::Timing)."""

    def __init__(self):
        self._stats: Dict[str, _SpanStats] = collections.defaultdict(_SpanStats)

    def record(self, name: str, dt_s: float) -> None:
        self._stats[name].add(dt_s)

    def get(self, name: str) -> _SpanStats:
        return self._stats[name]

    def reset(self) -> None:
        self._stats.clear()

    def to_string(self) -> str:
        lines = ["NVbloxTPU Timing",
                 "-----------",
                 f"{'name':<48}{'count':>8}{'total_s':>11}{'mean_ms':>10}"
                 f"{'std_ms':>9}{'min_ms':>9}{'max_ms':>9}"]
        for name in sorted(self._stats):
            s = self._stats[name]
            lines.append(
                f"{name:<48}{s.count:>8}{s.total:>11.3f}{s.mean * 1e3:>10.2f}"
                f"{s.std * 1e3:>9.2f}"
                f"{(0.0 if s.count == 0 else s.min) * 1e3:>9.2f}"
                f"{s.max * 1e3:>9.2f}")
        return "\n".join(lines)


class RatesRegistry:
    """Tick-rate meters (parity: nvblox timing::Rates).

    `tick(name)` records an event; `rate(name)` reports the mean Hz over a
    sliding window. The clock is injectable for tests (parity:
    Rates::setGetTimestampFunctor).
    """

    def __init__(self, window: int = 100):
        self._window = window
        self._ticks: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._clock: Callable[[], float] = time.monotonic

    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def tick(self, name: str) -> None:
        self._ticks[name].append(self._clock())

    def rate_hz(self, name: str) -> float:
        ts = self._ticks.get(name)
        if not ts or len(ts) < 2:
            return 0.0
        span = ts[-1] - ts[0]
        return (len(ts) - 1) / span if span > 0 else 0.0

    def reset(self) -> None:
        self._ticks.clear()

    def to_string(self) -> str:
        lines = ["NVbloxTPU Rates", "-----------",
                 f"{'name':<48}{'count':>8}{'hz':>9}"]
        for name in sorted(self._ticks):
            lines.append(f"{name:<48}{len(self._ticks[name]):>8}"
                         f"{self.rate_hz(name):>9.2f}")
        return "\n".join(lines)


class DelaysRegistry:
    """Message-stamp -> processing latency meters (parity: timing::Delays)."""

    def __init__(self, window: int = 100):
        self._delays: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window))

    def record(self, name: str, delay_s: float) -> None:
        self._delays[name].append(delay_s)

    def mean_s(self, name: str) -> float:
        d = self._delays.get(name)
        return sum(d) / len(d) if d else 0.0

    def reset(self) -> None:
        self._delays.clear()

    def to_string(self) -> str:
        lines = ["NVbloxTPU Delays", "-----------",
                 f"{'name':<48}{'count':>8}{'mean_ms':>10}"]
        for name in sorted(self._delays):
            lines.append(f"{name:<48}{len(self._delays[name]):>8}"
                         f"{self.mean_s(name) * 1e3:>10.2f}")
        return "\n".join(lines)


Timing = TimingRegistry()
Rates = RatesRegistry()
Delays = DelaysRegistry()


def wait_for(value) -> None:
    """Block the host until the device work that produced `value` (a
    tensor, or a list, tuple or dict of them) is done: one CUDA event per
    card, recorded on its current stream and synchronized. Tensors on the
    CPU are ready already."""
    stack, devices = [value], set()
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    for dev in devices:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()


class Timer:
    """Context manager recording a span into the global Timing registry.

    `block_until_ready` may be a tensor (or a nest of them) to wait on
    before closing the span, so device work is included in the
    measurement.
    """

    def __init__(self, name: str, block_until_ready=None):
        self.name = name
        self._block = block_until_ready
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def set_block(self, value) -> None:
        self._block = value

    def __exit__(self, *exc):
        if self._block is not None:
            wait_for(self._block)
        Timing.record(self.name, time.perf_counter() - self._t0)
        return False
