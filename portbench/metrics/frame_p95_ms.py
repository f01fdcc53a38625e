"""95th percentile over the window's depth frames of the time from hand-off
to the card's completion of the step that integrated the frame (host
clock at hand-off; completion from a CUDA event recorded after the step,
set against the host clock once at the window's start)."""

import numpy as np


def read(ctx):
    lat = ctx["latencies_ms"]
    if len(lat) < 20:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95))
