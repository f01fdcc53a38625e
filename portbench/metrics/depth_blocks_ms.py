"""Mean host wall of the `mapper/depth/blocks` span over the window: a
depth frame's touched-block grid, workspace bounds, allocation and
batch."""


def read(ctx):
    count, mean_s = ctx["spans"].get("mapper/depth/blocks", (0, 0.0))
    return mean_s * 1e3 if count else None
