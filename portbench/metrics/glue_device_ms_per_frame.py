"""Device time of the traced window's activities that are neither one of
the program's own kernels (csrc/ and Triton) nor a copy or memset, per
depth frame integrated."""

COPIES = ("Memcpy", "Memset", "memcpy", "memset")


def read(ctx):
    evs = ctx.get("events")
    if not evs or not ctx["frames"]:
        return None
    own = ctx["kernel_names"]
    glue = sum(e - s for name, s, e in evs
               if not name.startswith(COPIES)
               and ctx["kernel_of"](name) not in own)
    return glue * 1e3 / ctx["frames"]
