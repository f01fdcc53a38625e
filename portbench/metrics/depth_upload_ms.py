"""Mean host wall of the `mapper/depth/upload` span over the window: a
depth frame's image to the card and its preprocessing."""


def read(ctx):
    count, mean_s = ctx["spans"].get("mapper/depth/upload", (0, 0.0))
    return mean_s * 1e3 if count else None
