"""Mean host wall of the `mapper/mesh/layer` span over the window: a mesh
update's native compaction, `MeshLayer` weld, clear keys and removal
ring."""


def read(ctx):
    count, mean_s = ctx["spans"].get("mapper/mesh/layer", (0, 0.0))
    return mean_s * 1e3 if count else None
