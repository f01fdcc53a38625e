"""Mean host wall of the mesh update span over the window: the node's
`node/mesh/update`, the fuser's `fuser/mesh`."""


def read(ctx):
    for name in ("node/mesh/update", "fuser/mesh"):
        count, mean_s = ctx["spans"].get(name, (0, 0.0))
        if count:
            return mean_s * 1e3
    return None
