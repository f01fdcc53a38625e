"""Build and bind the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface, `build/torch_kernels/lib<name>-
<hash>.so` under the repository root, on first use, and loaded with
`ctypes`. The hash covers the source and the flags, so an edited source is
rebuilt. Sources are compiled in parallel, one `nvcc` each; ptxas's
resource report (`-Xptxas -v`) is kept beside each library as
`lib<name>-<hash>.log` and read by `resources`.

Pointer and stream arguments are `c_void_p` (tensor.data_ptr(), the
current stream's handle). Every C entry returns `cudaGetLastError()` after
its launch; `check` raises on anything but 0. Nothing here falls back to
another path: a failed build or launch raises.

`LAUNCHES` counts kernel launches per kernel; each wrapper adds one where
it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source extra flags. These kernels repeat their plain versions'
# float32 roundings, so nvcc must not contract a*b+c on its own.
PROJECTIVE = ("tsdf_fuse", "color_fuse", "tsdf_color_fuse", "occupancy_fuse",
              "tsdf_lidar_fuse", "detect_dynamic")
EXTRA_FLAGS = {name: ["-fmad=false"]
               for name in PROJECTIVE + ("marching_cubes", "mesh_compact")}
# Headers a source includes (part of its build hash).
HEADERS = {name: ["projective.cuh"]
           for name in PROJECTIVE + ("marching_cubes",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_PP = ctypes.POINTER(ctypes.c_void_p)
# C entry points of each library: name -> (argtypes, restype).
SIGNATURES = {
    "tsdf_fuse": {
        "tsdf_fuse": ([_P, _P, _P, _P, _P, _P, _FP, _I, _I, _I, _I, _I, _P],
                      _I),
        "tsdf_fuse_error_string": ([_I], ctypes.c_char_p),
    },
    "edt": {
        "edt_pass_launch": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I),
        "edt_error_string": ([_I], ctypes.c_char_p),
    },
    "color_fuse": {
        "color_fuse": ([_PP, _P, _P, _P, _P, _P, _I, _P, _P, _P, _FP, _I, _I,
                        _I, _I, _I, _I, _F, _I, _P], _I),
        "color_fuse_error_string": ([_I], ctypes.c_char_p),
    },
    "tsdf_color_fuse": {
        "tsdf_color_fuse": ([_PP, _P, _P, _P, _P, _I, _P, _FP, _I, _I, _I, _I,
                             _I, _P], _I),
        "tsdf_color_fuse_error_string": ([_I], ctypes.c_char_p),
    },
    "marching_cubes": {
        "marching_cubes": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                            _I, _F, _I, _P], _I),
        "marching_cubes_error_string": ([_I], ctypes.c_char_p),
    },
    "occupancy_fuse": {
        "occupancy_fuse": ([_P, _P, _P, _P, _P, _P, _FP, _I, _I, _I, _I, _P],
                           _I),
        "occupancy_fuse_error_string": ([_I], ctypes.c_char_p),
    },
    "tsdf_lidar_fuse": {
        "tsdf_lidar_fuse": ([_P, _P, _P, _P, _P, _P, _FP, _I, _I, _I, _I, _I,
                             _P], _I),
        "tsdf_lidar_fuse_error_string": ([_I], ctypes.c_char_p),
    },
    "dilate": {
        "dilate_dense": ([_P, _P, _I, _I, _I, _F, _P], _I),
        "dilate_error_string": ([_I], ctypes.c_char_p),
    },
    "detect_dynamic": {
        "detect_dynamic": ([_P, _P, _P, _P, _P, _P, _FP, _I, _I, _I, _I, _I,
                            _I, _I, _P], _I),
        "detect_dynamic_error_string": ([_I], ctypes.c_char_p),
    },
    "mesh_compact": {
        "mesh_compact_offsets": ([_P, _P, _I, _P], _I),
        "mesh_compact": ([_P, _P, _P, _P, _I, _F, _P, _P, _P, _P], _I),
        "mesh_compact_error_string": ([_I], ctypes.c_char_p),
    },
    "mask_components": {
        "mask_components": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
        "mask_components_error_string": ([_I], ctypes.c_char_p),
    },
}

LAUNCHES: Dict[str, int] = {"tsdf_fuse": 0, "edt_pass1": 0, "edt_pass": 0,
                            "color_fuse": 0, "tsdf_color_fuse": 0,
                            "marching_cubes": 0, "occupancy_fuse": 0,
                            "tsdf_lidar_fuse": 0, "dilate_dense": 0,
                            "detect_dynamic": 0, "mesh_offsets": 0,
                            "mesh_compact": 0, "mask_components": 0}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    text = b"".join((CSRC / f).read_bytes()
                    for f in [f"{name}.cu", *HEADERS.get(name, [])])
    h = hashlib.sha256(text + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named sources (all by default) that are not built yet,
    one nvcc process each, all started together. Returns seconds per
    source built. Raises with nvcc's output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, errors = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of a `-Xptxas -v` log: registers a thread,
    static shared memory, stack frame and spill bytes."""
    out: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {"registers": 0, "smem": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(m.group(1)) if m else 0
    return out


def resources(name: str) -> Dict[str, Dict[str, int]]:
    """`parse_ptxas` of the build log of `csrc/<name>.cu` (built first if
    needed)."""
    library(name)
    return parse_ptxas(library_path(name).with_suffix(".log").read_text())


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if err != 0:
        msg = getattr(library(name), f"{name}_error_string")(err)
        raise RuntimeError(f"{what}: CUDA error {err} ({msg.decode()})")


def check_tensors(what: str, device, specs) -> None:
    """Raise unless every (name, tensor, dtypes) lies on `device`, has one
    of `dtypes` and is contiguous."""
    for name, t, dtypes in specs:
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, not {device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{what}: {name} must be one of {dtypes}, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def check_aligned(what: str, specs, alignment: int = 16) -> None:
    """Raise unless every (name, tensor)'s data starts on an `alignment`
    byte boundary (kernels that move 16 bytes a load or store)."""
    for name, t in specs:
        if t.data_ptr() % alignment:
            raise ValueError(f"{what}: {name} must start on a "
                             f"{alignment}-byte boundary")


def pointer_array(tensors):
    """A C array of the tensors' device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def stream_handle(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
