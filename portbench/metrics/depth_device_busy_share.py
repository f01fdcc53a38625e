"""Share of the depth steps' host wall in which the card was busy: the
program's logged `node/depth/integrate` or `fuser/depth` intervals,
intersected with the union of the traced device activities, over their
total length, in percent. Both are on the host's perf_counter."""

DEPTH = ("node/depth/integrate", "fuser/depth")


def window_log(ctx):
    """The program's logged spans inside the window's steps; None where
    the program keeps no log."""
    from isaac_ros_nvblox_tpu_torch.utils.timing import Timing
    span_log = getattr(Timing, "span_log", None)
    if span_log is None or not ctx["steps"]:
        return None
    lo, hi = ctx["steps"][0][0], ctx["steps"][-1][1]
    return [r for r in span_log() if lo <= r.start and r.end <= hi]


def read(ctx):
    from portbench import devtrace
    spans = sorted((r.start, r.end) for r in window_log(ctx) or ()
                   if r.name in DEPTH)
    if not spans or not ctx.get("events"):
        return None
    busy = devtrace.busy_intervals(ctx["events"], spans[0][0], spans[-1][1])
    total = sum(e - s for s, e in spans)
    overlap, j = 0.0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            overlap += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return 100.0 * overlap / total if total > 0 else None
