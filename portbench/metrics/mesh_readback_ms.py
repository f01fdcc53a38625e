"""Mean host wall of the `mapper/mesh/readback` span over the window: a
mesh update's live-row count and the copies of its rows to the host."""


def read(ctx):
    count, mean_s = ctx["spans"].get("mapper/mesh/readback", (0, 0.0))
    return mean_s * 1e3 if count else None
