"""Blocks a mesh update left for a later one (its budget's backlog), on
average over the window's mesh updates: the program's
`mapper/mesh/deferred_blocks` counter, read from its span log."""


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
    total = adds = 0
    for r in window_log(ctx) or ():
        t, n = r.counters.get("mapper/mesh/deferred_blocks", (0, 0))
        total += t
        adds += n
    return total / adds if adds else None
