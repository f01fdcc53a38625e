"""Mean host wall of the node's `node/tick` span over the window."""


def read(ctx):
    count, mean_s = ctx["spans"].get("node/tick", (0, 0.0))
    return mean_s * 1e3 if count else None
