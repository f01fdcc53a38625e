"""The mask filter's kernels' (csrc/mask_components.cu) share of their
roofline: the least time the window's filter work needs at the card's
memory bandwidth over the kernels' device time in the traced window, in
percent. The bytes are the people-segmentation kind's count from the
reference's replay (`mask_label_bytes`: per masked depth frame, the mask
read once, the labels written and read once as 32-bit integers and the
filtered mask written once)."""

KERNELS = ("mask_label_local_kernel", "mask_label_merge_kernel",
           "mask_label_count_kernel", "mask_label_filter_kernel")


def read(ctx):
    evs, peak = ctx.get("events"), ctx.get("peak")
    n_bytes = (ctx.get("work") or {}).get("mask_label_bytes")
    if not evs or not peak or not n_bytes:
        return None
    busy = sum(e - s for name, s, e in evs
               if ctx["kernel_of"](name) in KERNELS)
    if busy <= 0:
        return None
    return 100.0 * n_bytes / peak["hbm_bytes_per_s"] / busy
