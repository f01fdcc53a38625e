"""Device time of every activity in the traced window (kernels, copies,
memsets), per depth frame integrated."""


def read(ctx):
    evs = ctx.get("events")
    if not evs or not ctx["frames"]:
        return None
    return sum(e - s for _, s, e in evs) * 1e3 / ctx["frames"]
