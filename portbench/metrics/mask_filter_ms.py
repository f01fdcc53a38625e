"""Mean host wall of the `mapper/mask/filter` span over the window: the
masked depth step's connected-component filter (kernel mask_components
on the card)."""


def read(ctx):
    count, mean_s = ctx["spans"].get("mapper/mask/filter", (0, 0.0))
    return mean_s * 1e3 if count else None
