#!/usr/bin/env python3
"""Where the time of the EDT kernels goes, on one NVIDIA GPU.

Times `edt_pass1` (kernel edt_sweep_contig) and `edt_pass` (kernel
edt_minplus_kernel) of the port on synthetic grids of the ESDF regions
that `chip_smoke.py` solves (main path 160x128x72, lidar 512x384x256
voxels), band 40, no mask, each pass in the solve's order (Z, then Y, then
X), on four inputs:

  * inf:    every voxel INF (every item takes the all-INF skip: the
            launch, the need flags and the stores);
  * zero:   every voxel 0 (every item exits after its first 8 offsets:
            adds the staging of the tile);
  * sparse: sites with probability 0.01 through the plain passes before
            (the main path's density of sites, about 2.7% of its voxels);
  * far:    one site in 64^3 (most windows hold a finite value far away:
            the full band is examined).

Each line: device time of one launch (torch.profiler, median of 21), the
same for 21 launches back to back in one CUDA graph (`ms_graph`: without
the idle gaps the host leaves between launches), and the byte bound (the grid read and written once at 3.35 TB/s); per region
also the device time of a copy of the grid (`clone`, the same bytes moved
by the runtime's own copy); then the card's name and power limit as
nvidia-smi gives them.

    python3 edt_profile.py
"""

import json
import sys

import numpy as np

from chip_smoke import (HBM_BYTES_PER_S, kernel_ms, nvidia_smi_line,
                        plain_device_ms, trace)


def graph_kernel_ms(fn, match: str, reps: int = 21) -> float:
    """Median device time of the kernel whose name holds `match` over
    `reps` calls of `fn` captured back to back in one CUDA graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    durs = [us for name, us in trace(graph.replay, 1)[0] if match in name]
    return float(np.median(durs)) / 1e3


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("edt_profile: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
    band, dev = 40, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    inf = float(ed.INF)
    for region, shape in (("main_path", (160, 128, 72)),
                          ("lidar", (512, 384, 256))):
        seeds = {
            "inf": torch.full(shape, inf, device=dev),
            "zero": torch.zeros(shape, device=dev),
            "sparse": torch.where(torch.rand(shape, generator=g, device=dev)
                                  < 0.01, 0.0, inf),
            "far": torch.where(torch.rand(shape, generator=g, device=dev)
                               < 64 ** -3, 0.0, inf)}
        bound = 8 * np.prod(shape) / HBM_BYTES_PER_S * 1e3
        x = seeds["zero"]
        print(json.dumps({"region": region, "grid": list(shape),
                          "input": "zero", "kernel": "copy",
                          "ms": plain_device_ms(lambda: x.clone()),
                          "bound_ms": bound}), flush=True)
        for kind, x in seeds.items():
            for i, axis in enumerate((2, 1, 0)):
                fn = ed.edt_pass1 if i == 0 else ed.edt_pass
                match = "edt_sweep" if i == 0 else "edt_minplus"
                ms, how = kernel_ms(lambda: fn(x, axis, band), match)
                ms_graph = graph_kernel_ms(lambda: fn(x, axis, band), match)
                print(json.dumps({"region": region, "grid": list(shape),
                                  "input": kind, "kernel": fn.__name__,
                                  "axis": axis, "ms": ms, "ms_timing": how,
                                  "ms_graph": ms_graph, "bound_ms": bound}),
                      flush=True)
                x = (ed.edt_pass1_plain if i == 0 else ed.edt_pass_plain)(
                    x, axis, band)
            del x
        del seeds
        torch.cuda.empty_cache()
    print(nvidia_smi_line(), flush=True)


if __name__ == "__main__":
    main()
