"""The device trace of a traced run and what is read from it.

`DeviceTrace` runs torch.profiler over the window with CUDA activities
only (no host-op records, so the host pays little) and, after the window,
lists every device activity (kernel, copy, memset) as (name, start, end)
in the host's perf_counter seconds. The device clock is set against the
host's by a marker kernel launched right after a synchronize at the
trace's start.

While tracing it also records the program's `Timer` spans with their
start and end (the spans in `utils/timing.py`, which otherwise keep only
durations), so that an idle gap on the device is named by the innermost
program span open on the host at its middle.

`device_events` is a copy of chip_smoke.py's function of that name.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch


def device_events(prof):
    """[(name, start_ns, end_ns)] of the device activities of a finished
    torch.profiler trace, read from its raw kineto results."""
    from torch.autograd import DeviceType
    return [(torch._C._demangle(e.name()), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class DeviceTrace:
    MARKER = "spin_kernel"

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.spans: List[Tuple[float, float, str]] = []
        self._patched = None

    def __enter__(self):
        from isaac_ros_nvblox_tpu_torch.utils import timing
        spans = self.spans
        orig_enter, orig_exit = timing.Timer.__enter__, timing.Timer.__exit__

        def enter(timer):
            timer._pb_start = time.perf_counter()
            return orig_enter(timer)

        def exit_(timer, *exc):
            out = orig_exit(timer, *exc)
            spans.append((timer._pb_start, time.perf_counter(), timer.name))
            return out

        timing.Timer.__enter__, timing.Timer.__exit__ = enter, exit_
        self._patched = (timing.Timer, orig_enter, orig_exit)
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        cls, orig_enter, orig_exit = self._patched
        cls.__enter__, cls.__exit__ = orig_enter, orig_exit
        return False

    def events(self) -> List[Tuple[str, float, float]]:
        """(name, start, end) of every device activity after the marker,
        in host perf_counter seconds."""
        evs = sorted(device_events(self.prof), key=lambda e: e[1])
        mk = [e for e in evs if self.MARKER in e[0]]
        if not mk:
            raise RuntimeError("the trace holds no marker kernel")
        t0 = mk[0][1]
        return [(n, self.marker_host + (s - t0) / 1e9,
                 self.marker_host + (e - t0) / 1e9)
                for n, s, e in evs if s > mk[0][2]]


def busy_intervals(evs, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the activities' intervals, clipped to [lo, hi]."""
    out: List[Tuple[float, float]] = []
    for _, s, e in sorted(evs, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def idle_gaps(busy, lo: float, hi: float, spans, harness_spans,
              k: int = 10) -> List[List]:
    """The idle time between busy intervals, summed by the innermost span
    open on the host at each gap's middle (the program's spans first,
    then the harness's own), the k largest as [[name, seconds]]."""
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    allspans = sorted(spans, key=lambda x: x[0])
    starts = [s for s, _, _ in allspans]
    hs = sorted(harness_spans, key=lambda x: x[0])
    hstarts = [s for s, _, _ in hs]
    by: Dict[str, float] = {}

    def innermost(seq, seq_starts, t) -> Optional[str]:
        best = None
        i = bisect.bisect_right(seq_starts, t)
        for s, e, name in reversed(seq[max(0, i - 64):i]):
            if s <= t <= e and (best is None or s > best[0]):
                best = (s, name)
        return None if best is None else best[1]

    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = (innermost(allspans, starts, mid)
                or innermost(hs, hstarts, mid) or "harness")
        by[name] = by.get(name, 0.0) + (b - a)
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
