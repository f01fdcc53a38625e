"""The benchmark's driver: one run of one cell.

Everything a cell is made of is data and code found by name from
BENCHMARK.json: the workload names its configuration (`configs[].file`)
and its traffic (`portbench/traffic/<traffic>.json`); its limits on the
compared numbers are `portbench/limits/<workload>.json`; each per-layer
metric is the reader `portbench/metrics/<metric>.py`; a configuration's
`kind` names the module `portbench/kinds/<kind>.py` that drives the
program and replays the reference (its `Program`, `warm_up_steps`,
`reference`, `numbers` and `stand_in`).

A run: inputs from the seed (inputs.py), the program built and warmed up
(steps until the mesh and ESDF cadences have both run twice), the window
(closed loop for `seconds`, then on to the end of the cadence period; a
traced run's window is at most TRACE_SECONDS, all of it traced; the
garbage collector frozen and off), the peak memory read, the program's
outputs copied to the host and the program freed, then the reference
replay of the same steps and the comparison (compare.py). `correct`
holds when every compared number is within its limit and every frame
handed over was integrated.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "isaac_ros_nvblox_tpu")
PORT = "isaac_ros_nvblox_tpu_torch"
# A traced run's window: all of it traced, at most this long, so that
# reading the trace (some hundred thousand device activities) stays short.
TRACE_SECONDS = 10.0


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not hold, each
    compared whole (the port's name only begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path):
    return json.loads(Path(path).read_text())


class Cell:
    """A workload of BENCHMARK.json with its files read."""

    def __init__(self, name: str, workload: Optional[Dict] = None):
        """`workload`, where given, stands for an entry that BENCHMARK.json
        does not hold (a staged cell; its configuration is then
        `configs/<config>.json`)."""
        spec = load_json(ROOT / "BENCHMARK.json")
        by = {w["name"]: w for w in spec["workloads"]}
        if workload is None and name not in by:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = workload or by[name]
        self.name = name
        files = {c["name"]: c["file"] for c in spec["configs"]}
        config = self.workload["config"]
        self.config = load_json(ROOT / files.get(
            config, f"portbench/configs/{config}.json"))
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moves)]
        self.run_seconds = int(spec["run_seconds"])
        self.kind = self.config["kind"]
        self.meshes = bool(self.traffic.get("subscribers", {"mesh": True})
                           .get("mesh", False))

    @property
    def module(self):
        """The configuration kind's module, `portbench/kinds/<kind>.py`."""
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", self.kind):
            raise ValueError(f"bad kind {self.kind!r}")
        return importlib.import_module(f"portbench.kinds.{self.kind}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")


def kernel_names(port_dir: Path) -> set:
    """Names of the program's own device kernels: every `__global__`
    function of its CUDA sources and every `@triton.jit` function."""
    names = set()
    for p in list(port_dir.rglob("*.cu")) + list(port_dir.rglob("*.cuh")):
        names.update(_GLOBAL.findall(p.read_text(errors="replace")))
    for p in port_dir.rglob("*.py"):
        text = p.read_text(errors="replace")
        if "triton" in text:
            names.update(_TRITON.findall(text))
    return names


def kernel_of(name: str) -> str:
    """The function name of a demangled device activity name, without its
    return type, namespaces, template arguments and parameters."""
    head = name.replace("(anonymous namespace)", "").split("(")[0].strip()
    depth, out = 0, []
    for ch in head:              # drop template arguments
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(ch)
    head = "".join(out).strip().split(" ")[-1]
    return head.split("::")[-1]


def nvidia_smi() -> Optional[str]:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


class _Clock:
    """Completion times of steps: a CUDA event after each step, set
    against the host clock once at the window's start (no extra sync);
    on the CPU the host clock after the step."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        self.h0 = time.perf_counter()
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        return self.h0

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def done_at(self, mark) -> float:
        if self.cuda:
            return self.h0 + self.e0.elapsed_time(mark) / 1e3
        return mark


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=None) -> Dict:
    """One run of `cell`. Returns the result line (dict, the contract's
    keys, `checks` last)."""
    from portbench import devtrace, inputs
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kind = cell.module
    config, traffic = cell.config, cell.traffic
    lap = inputs.make_lap(config, traffic, seed, device)
    inputs_peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_inputs = time.perf_counter() - t_start
    prog = kind.Program(config, traffic, lap, device)
    from isaac_ros_nvblox_tpu_torch.utils.timing import Timing

    # Warm-up: every cadence runs, the mesh and ESDF ones twice.
    warm = kind.warm_up_steps(config)
    for _ in range(warm):
        prog.step()

    prog.counting = True
    Timing.reset()
    clock = _Clock(device)
    tracer = devtrace.DeviceTrace() if trace else None
    gc.collect()
    gc.freeze()
    gc.disable()
    if tracer is not None:
        tracer.__enter__()
    h0 = clock.start()
    setup_s = h0 - t_start
    handoffs, steps = [], []
    attempted = 0
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    while True:
        ts = time.perf_counter()
        handed = prog.step()
        mark = clock.mark()
        steps.append((ts, time.perf_counter(), "harness/step"))
        if handed is not None:
            handoffs.append((handed, mark))
            attempted += 1
        if time.perf_counter() - h0 >= seconds and prog.at_cadence_end():
            break
    if cuda:
        torch.cuda.synchronize()
    h1 = time.perf_counter()
    gc.enable()
    gc.unfreeze()
    if tracer is not None:
        tracer.__exit__(None, None, None)
    window_s = h1 - h0
    latencies = [(clock.done_at(m) - h) * 1e3 for h, m in handoffs]
    spans = {k: (s.count, s.mean) for k, s in Timing._stats.items()}
    frames = prog.frames_integrated()
    host_bytes = prog.host_bytes
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    prog.settle()
    outputs = prog.outputs()
    n_steps = prog.steps_done()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    ref = kind.reference(cell, lap, n_steps, warm, device)
    nums = kind.numbers(cell, outputs, ref)
    admitted = ref["work"]["frames_window"]
    failed = abs(admitted - frames) + abs(attempted - admitted)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in nums.items()}
    correct = failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    checks["frames_not_integrated"] = {"value": failed, "limit": 0}

    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed)}
    if not trace:
        values = {"frames_per_s": (frames / window_s, "frames/s"),
                  "peak_mem_mib": (peak / 2 ** 20, "MiB"),
                  "setup_s": (setup_s, "s")}
        line["metrics"] = {m["name"]: {"value": values[m["name"]][0],
                                       "unit": m["unit"]}
                           for m in cell.end_to_end}
        line["device"] = dev
    else:
        evs = tracer.events() if tracer is not None else []
        evs = [e for e in evs if e[2] > h0 and e[1] < h1]
        busy = devtrace.busy_intervals(evs, h0, h1)
        busy_s = sum(b - a for a, b in busy)
        span_log = tracer.spans if tracer is not None else []
        ctx = {"kind": cell.kind, "config": config, "frames": frames,
               "window_s": window_s, "latencies_ms": latencies,
               "spans": spans, "span_log": span_log, "steps": steps,
               "host_bytes": host_bytes, "events": evs, "busy_s": busy_s,
               "kernel_names": kernel_names(ROOT / PORT),
               "kernel_of": kernel_of,
               "peak": load_json(HERE / "peaks.json").get(name),
               "work": ref["work"]}
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = {**dev, "busy_s": busy_s, "window_s": window_s}
        by_name = {}
        for n, s, e in evs:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + (e - s)
        own = ctx["kernel_names"]
        per_kernel = {}
        for n, s, e in evs:
            k = kernel_of(n)
            if k in own:
                c_s = per_kernel.setdefault(k, [0, 0.0])
                c_s[0] += 1
                c_s[1] += e - s
        log(f"trace: {len(evs)} device activities; the program's kernels "
            f"(count, seconds): {json.dumps(per_kernel)}")
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": devtrace.idle_gaps(busy, h0, h1, span_log, steps)}
    line["setup"] = {"seed": int(seed), "inputs_s": t_inputs,
                     "inputs_peak_bytes": int(inputs_peak),
                     "overflow_blocks": outputs["tsdf"]["overflow"],
                     "live_blocks": int(len(outputs["tsdf"]["blocks"])),
                     "capacity": int(config["world"]["capacity"]),
                     "warm_up_steps": warm,
                     "window_steps": n_steps - warm, "frames": frames,
                     "window_s": window_s,
                     "cpus": sorted(os.sched_getaffinity(0)),
                     "nvidia_smi": nvidia_smi() if cuda else None}
    line["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    return line


class ForbiddenImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules loaded that a run may not hold: "
                         + ", ".join(names))
        self.names = names
