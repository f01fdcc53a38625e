"""The EDT passes' (edt.cu's sweep and min-plus kernels) share of their
roofline: the least time the window's ESDF solves need at the card's
memory bandwidth (portbench/work.py's count from the reference's replay)
over the passes' device time in the traced window, in percent."""

from portbench import work


def read(ctx):
    evs, peak = ctx.get("events"), ctx.get("peak")
    if not evs or not peak:
        return None
    busy = sum(e - s for name, s, e in evs
               if ctx["kernel_of"](name).startswith("edt_"))
    n_bytes = work.edt_bytes(ctx["work"])
    if busy <= 0 or not n_bytes:
        return None
    return 100.0 * n_bytes / peak["hbm_bytes_per_s"] / busy
