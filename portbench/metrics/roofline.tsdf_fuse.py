"""The depth-fusion kernels' (tsdf_fuse, tsdf_lidar_fuse) share of their
roofline: the least time the window's fusion work needs at the card's
memory bandwidth (portbench/work.py's count from the reference's replay)
over the kernels' device time in the traced window, in percent."""

from portbench import work

KERNELS = ("tsdf_fuse_kernel", "tsdf_lidar_fuse_kernel")


def read(ctx):
    evs, peak = ctx.get("events"), ctx.get("peak")
    if not evs or not peak:
        return None
    busy = sum(e - s for name, s, e in evs
               if ctx["kernel_of"](name) in KERNELS)
    if busy <= 0:
        return None
    c, lid = ctx["config"]["camera"], ctx["config"].get("lidar")
    n_bytes = work.tsdf_fuse_bytes(
        ctx["work"], int(c["width"]) * int(c["height"]),
        int(lid["width"]) * int(lid["height"]) if lid else 0)
    return 100.0 * n_bytes / peak["hbm_bytes_per_s"] / busy
