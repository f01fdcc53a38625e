"""Mean host wall of the depth integration span over the window: the
node's `node/depth/integrate`, the fuser's `fuser/depth`."""


def read(ctx):
    for name in ("node/depth/integrate", "fuser/depth"):
        count, mean_s = ctx["spans"].get(name, (0, 0.0))
        if count:
            return mean_s * 1e3
    return None
