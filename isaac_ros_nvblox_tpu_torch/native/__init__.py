"""ctypes bindings of the port's host libraries, `mesh_native.cc` (the
mesh helpers) and `png_native.cc` (the PNG unfilter), with the numpy
versions of their entry points.

Each library is compiled by `g++` on first use into
`build/torch_native/lib<name>-<hash>.so` under the repository root (the
hash covers the source and the flags) and loaded with `ctypes`. A failed
build raises: nothing falls back to the numpy versions, which stay here as
the plain versions the tests hold the libraries against.

  * `compact_mesh_blocks`: per-block CSR compaction of the device mesh
    soup (`f32[N, 3, K, V]` planes + mask) in v-major, then slot, order.
  * `compact_triangles`: the valid triangles of a soup, packed.
  * `weld_mesh`: one vertex per quantized position, in order of first
    appearance, with the triangles as indices.
  * `write_mesh_ply`: a binary little-endian PLY, byte for byte what
    `io/ply.py::write_mesh_ply` writes.
  * `png_unfilter`: undo the five PNG row filters of inflated scanlines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "mesh_native.cc"
PNG_SOURCE = SOURCE.with_name("png_native.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
SIGNATURES = {
    "count_valid": ([_P, _I64], _I64),
    "compact_triangles": ([_P, _P, _P, _I64, _P, _P], _I64),
    "weld_mesh": ([_P, _P, _I64, ctypes.c_float, _P, _P, _P], _I64),
    "mesh_block_offsets": ([_P, _I64, _I64, _I64, _P], None),
    "mesh_block_compact": ([_P, _P, _P, _I64, _I64, _I64, _P, _P, _P], None),
    "write_mesh_ply": ([ctypes.c_char_p, _P, _P, _I64, _P, _I64,
                        ctypes.c_int], ctypes.c_int),
}
PNG_SIGNATURES = {"png_unfilter": ([_P, _I64, _I64, _I64, _P], _I64)}

_lib: Optional[ctypes.CDLL] = None
_png_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(source.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{h}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile `source` (a library of this directory) unless it is built;
    raises with the compiler's output if the build fails."""
    out = library_path(source)
    if out.exists():
        return out
    name = source.stem
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"{name}: no C++ compiler (set CXX or put "
                           "g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name}: {cxx} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(source: Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(source)))
    for fn, (argtypes, restype) in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def library() -> ctypes.CDLL:
    """The loaded mesh library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(SOURCE, SIGNATURES)
        return _lib


def png_library() -> ctypes.CDLL:
    """The loaded PNG library, built on first use."""
    global _png_lib
    with _lock:
        if _png_lib is None:
            _png_lib = _load(PNG_SOURCE, PNG_SIGNATURES)
        return _png_lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ----------------------------------------------------------------- library

def compact_triangles(verts: np.ndarray, colors: np.ndarray,
                      valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pack the valid triangles of a soup: (verts f32[T, 3, 3], colors
    f32[T, 3, 3], valid bool/u8[T]) -> (f32[K, 3, 3], f32[K, 3, 3])."""
    verts = np.ascontiguousarray(verts.reshape(-1, 3, 3), np.float32)
    colors = np.ascontiguousarray(colors.reshape(-1, 3, 3), np.float32)
    valid = np.ascontiguousarray(valid.reshape(-1).astype(np.uint8))
    lib = library()
    n = verts.shape[0]
    k = lib.count_valid(_ptr(valid), n)
    out_v = np.empty((k, 3, 3), np.float32)
    out_c = np.empty((k, 3, 3), np.float32)
    lib.compact_triangles(_ptr(verts), _ptr(colors), _ptr(valid), n,
                          _ptr(out_v), _ptr(out_c))
    return out_v, out_c


def compact_mesh_blocks(verts: np.ndarray, colors: Optional[np.ndarray],
                        mask: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray,
                                   Optional[np.ndarray]]:
    """Per-block CSR compaction of device triangle soup.

    verts: f32[N, 3, K, V] xyz-major planes; colors: the same or None;
    mask: bool/u8[N, K, V]. Returns (offsets i64[N+1], verts f32[total, 3],
    colors f32[total, 3] | None), block i's vertices at
    [offsets[i]:offsets[i+1]] in v-major, then slot, order."""
    verts = np.ascontiguousarray(verts, np.float32)
    mask_u8 = np.ascontiguousarray(mask.astype(np.uint8))
    N, K, V = mask_u8.shape
    lib = library()
    offsets = np.empty(N + 1, np.int64)
    lib.mesh_block_offsets(_ptr(mask_u8), N, K, V, _ptr(offsets))
    total = int(offsets[-1])
    out_v = np.empty((total, 3), np.float32)
    out_c = cols = None
    if colors is not None:
        cols = np.ascontiguousarray(colors, np.float32)
        out_c = np.empty((total, 3), np.float32)
    lib.mesh_block_compact(
        _ptr(verts), None if cols is None else _ptr(cols), _ptr(mask_u8),
        N, K, V, _ptr(offsets), _ptr(out_v),
        None if out_c is None else _ptr(out_c))
    return offsets, out_v, out_c


def weld_mesh(verts: np.ndarray, colors: np.ndarray, quantum: float
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weld a triangle soup `f32[T, 3, 3]` (per-vertex colors of the same
    shape, 0-255) -> (vertices f32[V, 3], colors u8[V, 3], triangles
    i32[T, 3]): one vertex per key round(v / quantum), numbered in order of
    first appearance, with that vertex's position and color."""
    verts = np.ascontiguousarray(verts.reshape(-1, 3, 3), np.float32)
    colors = np.ascontiguousarray(colors.reshape(-1, 3, 3), np.float32)
    t = verts.shape[0]
    out_v = np.empty((t * 3, 3), np.float32)
    out_c = np.empty((t * 3, 3), np.uint8)
    out_t = np.empty((t, 3), np.int32)
    n = library().weld_mesh(_ptr(verts), _ptr(colors), t, quantum,
                            _ptr(out_v), _ptr(out_c), _ptr(out_t))
    return out_v[:n].copy(), out_c[:n].copy(), out_t


def write_mesh_ply(path, verts: np.ndarray, colors: Optional[np.ndarray],
                   tris: np.ndarray) -> None:
    """Binary PLY of a mesh (vertices f32[V, 3], colors u8[V, 3] or None,
    triangles i32[T, 3]); raises if the file cannot be written."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    has_c = colors is not None and len(colors) == len(verts)
    cols = (np.ascontiguousarray(colors, np.uint8) if has_c
            else np.zeros((1, 3), np.uint8))
    rc = library().write_mesh_ply(str(path).encode(), _ptr(verts),
                                  _ptr(cols), len(verts), _ptr(tris),
                                  len(tris), int(has_c))
    if rc != 0:
        raise OSError(f"mesh_native: writing {path} failed ({rc})")


def png_unfilter(raw: bytes, height: int, row_bytes: int,
                 bpp: int) -> np.ndarray:
    """Undo the PNG row filters: `raw` holds `height` inflated scanlines of
    one filter-type byte and `row_bytes` bytes each; `bpp` is the bytes
    per pixel (at least 1). Returns u8[height, row_bytes]; raises on a
    filter type outside 0-4."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {src.size} bytes, expected "
                         f"{height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    bad = png_library().png_unfilter(_ptr(src), height, row_bytes, bpp,
                                     _ptr(out))
    if bad:
        raise ValueError(f"PNG row {bad - 1} has an unknown filter type")
    return out


# ------------------------------------------------------------ plain versions

def png_unfilter_plain(raw: bytes, height: int, row_bytes: int,
                       bpp: int) -> np.ndarray:
    """numpy version of `png_unfilter`: sub and up by whole rows, average
    and Paeth one pixel column at a time (each byte depends on the one
    decoded `bpp` to its left)."""
    src = np.frombuffer(raw, np.uint8)
    if src.size != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {src.size} bytes, expected "
                         f"{height * (row_bytes + 1)}")
    rows = src.reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(height):
        f, x = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = x
        elif f == 2:
            cur = (x + prev) & 0xFF
        elif f in (1, 3, 4):
            cur = np.zeros(row_bytes, np.int32)
            for i in range(0, row_bytes, bpp):
                j = slice(i, i + bpp)
                a = cur[i - bpp:i] if i >= bpp else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + prev[j]) >> 1
                else:
                    b = prev[j]
                    c = prev[i - bpp:i] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[j] = (x[j] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type")
        out[y] = cur
        prev = cur
    return out


def compact_triangles_plain(verts: np.ndarray, colors: np.ndarray,
                            valid: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """numpy version of `compact_triangles`."""
    m = valid.reshape(-1).astype(bool)
    return (np.asarray(verts, np.float32).reshape(-1, 3, 3)[m],
            np.asarray(colors, np.float32).reshape(-1, 3, 3)[m])


def compact_mesh_blocks_plain(verts: np.ndarray, colors: Optional[np.ndarray],
                              mask: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray,
                                         Optional[np.ndarray]]:
    """numpy version of `compact_mesh_blocks`."""
    N, K, V = mask.shape
    # v-major order: (K, V) -> (V, K) before flattening.
    m = mask.astype(bool).transpose(0, 2, 1).reshape(N, -1)
    offsets = np.zeros(N + 1, np.int64)
    np.cumsum(m.sum(1), out=offsets[1:])

    def pack(planes):
        return np.asarray(planes, np.float32).transpose(0, 3, 2, 1).reshape(
            N, -1, 3)[m]

    return offsets, pack(verts), (None if colors is None else pack(colors))


def weld_mesh_plain(verts: np.ndarray, colors: np.ndarray, quantum: float
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """numpy version of `weld_mesh`: the same welded mesh up to the
    numbering of its vertices, which here follows the keys' sorted order
    (round half to even)."""
    flat_v = np.ascontiguousarray(verts, np.float32).reshape(-1, 3)
    flat_c = np.ascontiguousarray(colors, np.float32).reshape(-1, 3)
    q = np.round(flat_v / quantum).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    return (flat_v[first],
            np.clip(flat_c[first], 0, 255).astype(np.uint8),
            inv.reshape(-1, 3).astype(np.int32))
