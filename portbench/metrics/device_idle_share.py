"""Share of the traced window in which no activity ran on the device:
1 - busy / window, in percent."""


def read(ctx):
    if not ctx.get("events"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
