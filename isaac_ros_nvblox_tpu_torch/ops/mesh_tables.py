"""Marching-cubes connectivity tables, constructed programmatically
(copy of isaac_ros_nvblox_tpu/ops/mesh_tables.py; numpy only).

Instead of shipping the classic hand-written 256-case triangle table, we
derive it at import time from first principles:

  1. For each of the 256 corner-sign configurations, find the cube edges
     crossed by the isosurface.
  2. On each cube face, pair up the crossed edges into contour segments.
     Ambiguous faces (two diagonal corners inside) are resolved with the
     fixed rule "keep inside corners separated", applied identically on both
     sides of a shared face — this guarantees watertight meshes across
     neighboring cubes.
  3. Crossed edges each lie on exactly two faces, so the segments chain into
     closed loops; each loop is fan-triangulated.
  4. Triangles are wound so normals point from inside (sdf < 0) to outside,
     using representative midpoint-crossing geometry.

The derivation is validated by tests (watertightness + outward orientation
on analytic spheres), replacing table-transcription risk with checked code.

Cube conventions: corner i has coords ((i>>0)&1, (i>>1)&1, (i>>2)&1); config
bit i is set iff corner i is inside (sdf < 0).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

# Corner coordinates [8, 3].
CORNERS: np.ndarray = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int32)

# The 12 cube edges as (corner_a, corner_b) pairs, a < b.
EDGES: Tuple[Tuple[int, int], ...] = tuple(
    sorted(
        (a, b)
        for a in range(8)
        for b in range(a + 1, 8)
        if bin(a ^ b).count("1") == 1
    )
)
assert len(EDGES) == 12

# Faces: (axis, side) -> the 4 corners with CORNERS[c, axis] == side,
# ordered cyclically around the face.
def _face_corners(axis: int, side: int) -> List[int]:
    cs = [c for c in range(8) if CORNERS[c, axis] == side]
    # Order cyclically: sort by angle in the face plane.
    other = [a for a in range(3) if a != axis]
    center = CORNERS[cs, :][:, other].mean(axis=0)
    ang = [np.arctan2(CORNERS[c, other[1]] - center[1],
                      CORNERS[c, other[0]] - center[0]) for c in cs]
    return [c for _, c in sorted(zip(ang, cs))]


FACES: Tuple[Tuple[int, ...], ...] = tuple(
    tuple(_face_corners(axis, side)) for axis in range(3) for side in (0, 1))


def _edge_id(a: int, b: int) -> int:
    return EDGES.index((min(a, b), max(a, b)))


def _face_segments(config: int, face: Tuple[int, ...]) -> List[Tuple[int, int]]:
    """Contour segments (pairs of crossed edge ids) on one face."""
    inside = [(config >> c) & 1 for c in face]
    crossings = []  # (position_in_cycle, edge_id)
    for k in range(4):
        a, b = face[k], face[(k + 1) % 4]
        if inside[k] != inside[(k + 1) % 4]:
            crossings.append((k, _edge_id(a, b)))
    if not crossings:
        return []
    if len(crossings) == 2:
        return [(crossings[0][1], crossings[1][1])]
    # Ambiguous face: 4 crossings, diagonal corners share sign. Pair each
    # inside corner's two adjacent crossings ("keep inside corners apart").
    segs = []
    for k in range(4):
        if inside[k]:
            prev_edge = _edge_id(face[(k - 1) % 4], face[k])
            next_edge = _edge_id(face[k], face[(k + 1) % 4])
            segs.append((prev_edge, next_edge))
    assert len(segs) == 2
    return segs


def _loops_for_config(config: int) -> List[List[int]]:
    """Closed loops of crossed-edge ids for a configuration."""
    adj: dict = {}
    for face in FACES:
        for e0, e1 in _face_segments(config, face):
            adj.setdefault(e0, []).append(e1)
            adj.setdefault(e1, []).append(e0)
    for e, ns in adj.items():
        assert len(ns) == 2, (config, e, ns)
    loops = []
    visited = set()
    for start in sorted(adj):
        if start in visited:
            continue
        loop = [start]
        visited.add(start)
        prev, cur = None, start
        while True:
            n0, n1 = adj[cur]
            nxt = n1 if n0 == prev else n0
            if nxt == start:
                break
            loop.append(nxt)
            visited.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


def _orient_loop(config: int, loop: List[int]) -> List[int]:
    """Orient the loop so fan triangles wind with outward-facing normals.

    Representative geometry: each crossing at its edge midpoint. Outward
    direction: mean(outside endpoints) - mean(inside endpoints) over the
    loop's crossed edges. Normal via Newell's method; flip if inward.
    """
    pts = []
    outward = np.zeros(3)
    for e in loop:
        a, b = EDGES[e]
        pa, pb = CORNERS[a].astype(float), CORNERS[b].astype(float)
        pts.append(0.5 * (pa + pb))
        a_in = (config >> a) & 1
        inside_pt, outside_pt = (pa, pb) if a_in else (pb, pa)
        outward += outside_pt - inside_pt
    pts_arr = np.asarray(pts)
    normal = np.zeros(3)
    n = len(pts_arr)
    for i in range(n):
        p, q = pts_arr[i], pts_arr[(i + 1) % n]
        normal += np.cross(p, q)
    if np.dot(normal, outward) < 0:
        return list(reversed(loop))
    return loop


@functools.lru_cache(maxsize=1)
def build_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (tri_table, tri_counts, edge_corner_a, edge_corner_b).

    tri_table: i32[256, MAX_TRIS*3] of edge ids (-1 padded), grouped in
    triples per triangle. tri_counts: i32[256]. edge_corner_{a,b}: i32[12]
    endpoint corner ids per edge.
    """
    all_tris: List[List[int]] = []
    max_tris = 0
    for config in range(256):
        tris: List[int] = []
        for loop in _loops_for_config(config):
            loop = _orient_loop(config, loop)
            for k in range(1, len(loop) - 1):
                tris.extend([loop[0], loop[k], loop[k + 1]])
        all_tris.append(tris)
        max_tris = max(max_tris, len(tris) // 3)
    tri_table = np.full((256, max_tris * 3), -1, np.int32)
    tri_counts = np.zeros((256,), np.int32)
    for config, tris in enumerate(all_tris):
        tri_table[config, :len(tris)] = tris
        tri_counts[config] = len(tris) // 3
    ea = np.asarray([e[0] for e in EDGES], np.int32)
    eb = np.asarray([e[1] for e in EDGES], np.int32)
    return tri_table, tri_counts, ea, eb


MAX_TRIS_PER_CUBE: int = build_tables()[0].shape[1] // 3
