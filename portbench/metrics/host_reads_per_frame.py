"""Device-to-host reads (each a host sync) per depth frame integrated:
the program's `host/reads` counter over the spans its log holds inside
the window."""


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
    log = window_log(ctx)
    if not log or not ctx["frames"]:
        return None
    reads = sum(r.counters.get("host/reads", (0, 0))[0] for r in log)
    return reads / ctx["frames"]
