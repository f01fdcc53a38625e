"""Mean host wall of the `mapper/human/integrate` span over the window:
the human layer's part of a masked depth step (its view's blocks and the
occupancy fusion of the masked pixels)."""


def read(ctx):
    count, mean_s = ctx["spans"].get("mapper/human/integrate", (0, 0.0))
    return mean_s * 1e3 if count else None
