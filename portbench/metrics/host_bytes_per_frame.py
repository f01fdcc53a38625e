"""Bytes the program copied to the host in the window's publishes (the
node's `last_host_bytes` of each kind, read in each subscriber callback;
the fuser's mapper `last_mesh_host_bytes` after each mesh update), per
depth frame integrated."""


def read(ctx):
    if not ctx["frames"]:
        return None
    return ctx["host_bytes"] / ctx["frames"]
