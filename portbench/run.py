#!/usr/bin/env python3
"""Run one cell of the benchmark of isaac_ros_nvblox_tpu_torch on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and last `checks`, each compared
number with its limit (also the last lines on standard error). Exits
non-zero, printing no result, without a CUDA card, when the JAX package
or JAX is loaded, or when BENCHMARK.json or a cell's file is missing.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Run as a script: import the harness and the program from the checkout's
# root, never modules beside this file under their bare names.
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))
# One process with few threads: the host side of a run is one thread of
# control, and a thread pool per library only adds contention on a
# shared host.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
# One fixed set of CPUs for the whole process, threads it starts later
# included: the last four the machine allows, so that the host side of a
# run does not wander between cores.
_CPUS = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, _CPUS[-4:])
# Caches of the program's builds stay inside the checkout.
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness
    from portbench.reference import esdf, fuser, fusion, mesh, node  # noqa
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    try:
        cell = harness.Cell(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(
            cell.workload["chips"]):
        print("portbench: no CUDA card (or fewer than the cell asks for)",
              file=sys.stderr)
        return 4
    try:
        line = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    except harness.ForbiddenImport as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
