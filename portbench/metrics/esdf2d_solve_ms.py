"""Mean host wall of the `mapper/esdf2d/solve` span over the window: the
2-D ESDF solve (on the node's ESDF ticks, inside the depth span)."""


def read(ctx):
    count, mean_s = ctx["spans"].get("mapper/esdf2d/solve", (0, 0.0))
    return mean_s * 1e3 if count else None
