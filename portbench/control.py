#!/usr/bin/env python3
"""The control of the comparison that decides `correct`: the plain
reference computed in bfloat16 (the precision below the configuration's
float32), put in the program's place and judged against the float32
reference by the same numbers, for the cell's own inputs and steps.

    python3 portbench/control.py --workload <cell> --steps <n> \
        --seeds <s> [<s> ...]

`--steps` is the steps (node ticks or fuser frames) a run makes, warm-up
and window together (a run prints them under `setup`). One JSON line per
seed with the numbers. The benchmark's runs do not run this; it sets the
upper reading of each limit (PERF.md).

The stand-in program's outputs are the bfloat16 reference's own: the
blocks its map observed, its slice over its observed blocks, its meshes
of every block with a cube to mesh (each kind's `stand_in`).
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))

import argparse  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402


def control_numbers(cell, seed: int, steps: int, warm: int, device) -> dict:
    """The numbers of the bfloat16 reference, in the program's place,
    against the float32 one."""
    from portbench import inputs
    kind = cell.module
    lap = inputs.make_lap(cell.config, cell.traffic, seed, device)
    ref32 = kind.reference(cell, lap, steps, warm, device)
    ref16 = kind.reference(cell, lap, steps, warm, device,
                           dtype=torch.bfloat16)
    return kind.numbers(cell, kind.stand_in(cell, ref16), ref32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--steps", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 4
    cell = harness.Cell(args.workload)
    warm = cell.module.warm_up_steps(cell.config)
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, args.steps, warm, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "steps": args.steps, "control": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
