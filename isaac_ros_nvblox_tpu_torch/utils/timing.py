"""Timing / Rates / Delays registries (port of
isaac_ros_nvblox_tpu/utils/timing.py).

nvblox's three singleton observability registries: `timing::Timer`
hierarchical spans, `timing::Rates` tick meters, `timing::Delays`
message-stamp latency meters, each printable and dumpable through the
node's services, with an injectable clock for deterministic tests.

A span measures host wall time and adds no device sync. While a
torch.profiler profile records the process, `Timing` also logs each
closed span (`SpanRecord`): its name, its start and end on
`time.perf_counter` (the clock a profile's device activities are set
against), its id and its parent's (the span open when it began; None for
a root such as `node/tick` or `fuser/frame`), and the counters added
while it was the innermost open span. The log is bounded, cleared by
`reset()` and read through `span_log()`; with no profile recording a
span pays one check for it.

Counters (`Timing.add`) keep a running total and the number of adds.
`to_host` is the mapping and publish paths' one way to read the device:
each call is a host sync, counted as `host/reads` and `host/read_bytes`.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# True while a torch.profiler profile records this thread.
_profiling = torch._C._autograd._profiler_enabled
# Closed spans the log keeps, newest last.
LOG_SIZE = 1 << 18


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


class _CounterStats:
    __slots__ = ("count", "total")

    def __init__(self):
        self.count = 0
        self.total = 0.0


class SpanRecord:
    """One closed span of the log. `counters` maps a counter's name to
    [total, adds] of what was added while this span was the innermost
    open one."""
    __slots__ = ("name", "start", "end", "id", "parent", "counters")

    def __init__(self, name: str, id: int, parent: Optional[int]):
        self.name = name
        self.id = id
        self.parent = parent
        self.start = self.end = 0.0
        self.counters: Dict[str, List[float]] = {}


class TimingRegistry:
    """Hierarchical span timing (parity: nvblox timing::Timing), its
    counters and, while a profile records, its span log."""

    def __init__(self):
        self._stats: Dict[str, _SpanStats] = collections.defaultdict(_SpanStats)
        self._counters: Dict[str, _CounterStats] = collections.defaultdict(
            _CounterStats)
        self._log: collections.deque = collections.deque(maxlen=LOG_SIZE)
        self._open: List[SpanRecord] = []
        self._next_id = 0

    def record(self, name: str, dt_s: float) -> None:
        self._stats[name].add(dt_s)

    def get(self, name: str) -> _SpanStats:
        return self._stats[name]

    def add(self, name: str, value: float = 1.0) -> None:
        """Add `value` to counter `name` (and to the innermost open span
        of the log, if any)."""
        c = self._counters[name]
        c.count += 1
        c.total += value
        if self._open:
            tc = self._open[-1].counters.setdefault(name, [0.0, 0])
            tc[0] += value
            tc[1] += 1

    def counter(self, name: str) -> _CounterStats:
        return self._counters[name]

    def span_log(self) -> List[SpanRecord]:
        """The logged spans, in the order they closed."""
        return list(self._log)

    def _open_span(self, name: str) -> SpanRecord:
        rec = SpanRecord(name, self._next_id,
                         self._open[-1].id if self._open else None)
        self._next_id += 1
        self._open.append(rec)
        return rec

    def _close_span(self, rec: SpanRecord, start: float, end: float) -> None:
        rec.start, rec.end = start, end
        # Spans close innermost first; a reset may have dropped the stack.
        if self._open and self._open[-1] is rec:
            self._open.pop()
        self._log.append(rec)

    def reset(self) -> None:
        self._stats.clear()
        self._counters.clear()
        self._log.clear()
        self._open.clear()

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
        if self._counters:
            lines.append(f"{'counter':<48}{'count':>8}{'total':>16}")
            for name in sorted(self._counters):
                c = self._counters[name]
                lines.append(f"{name:<48}{c.count:>8}{c.total:>16.0f}")
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


def to_host(t: torch.Tensor) -> np.ndarray:
    """`t` copied to the host: a device-to-host read, which waits for the
    work behind `t`. Counted as one `host/reads` and its bytes as
    `host/read_bytes` (a CPU tensor's too, so that a CPU run counts what
    a card run reads)."""
    Timing.add("host/reads")
    Timing.add("host/read_bytes", t.nbytes)
    return t.cpu().numpy()


class Timer:
    """Context manager recording a span into the global Timing registry
    (and into its log while a profile records)."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0
        self._rec: Optional[SpanRecord] = None

    def __enter__(self):
        self._rec = Timing._open_span(self.name) if _profiling() else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        Timing.record(self.name, t1 - self._t0)
        if self._rec is not None:
            Timing._close_span(self._rec, self._t0, t1)
        return False
