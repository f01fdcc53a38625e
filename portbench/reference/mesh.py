"""Plain PyTorch reference of nvblox's block mesh: marching cubes over a
TSDF whose samples sit at voxel centres.

The cube at voxel g has its 8 corners at g + {0, 1}^3; it is meshed when
every corner has weight >= `min_weight`. Corner i is inside where its
distance is < 0 (bit i of the case). Each crossed edge (a, b) carries one
vertex at t = clamp(d_a / (d_a - d_b), 0, 1) along it, with the corners'
colors blended by t. A block's mesh is the triangles of its 512 cubes
(cube base inside the block), from the frozen case table in
`mc_tables.json`.

Vertices are held in block-local voxel units rounded to bfloat16, the
mesh format the configuration states, and identified by their integer key
round(256 * (local + 8 * block)) per axis; vertex colors are the blended
color rounded to bfloat16, then truncated to u8. A block mesh is returned
as {vertex key: color} and a set of triangles (sorted vertex-key
triples).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

_TABLES = json.loads((Path(__file__).resolve().parent
                      / "mc_tables.json").read_text())
CORNERS = np.asarray(_TABLES["corners"], np.int64)           # [8, 3]
EDGES = np.asarray(_TABLES["edges"], np.int64)               # [12, 2]
TRI_COUNTS = np.asarray(_TABLES["tri_counts"], np.int64)     # [256]
TRI_EDGES = np.asarray(_TABLES["tri_edges"], np.int64)       # [256, 15]
_OFF = 1 << 20


def pack(keys):
    """int64 [..., 3] vertex keys -> one int64 each."""
    k = keys + _OFF
    return (k[..., 0] << 42) | (k[..., 1] << 21) | k[..., 2]


def mesh_blocks(d, w, color, origin_vox, blocks: np.ndarray,
                voxel_size_m: float, min_weight: float
                ) -> Dict[Tuple[int, int, int], Tuple[dict, set]]:
    """Meshes of `blocks` (global block indices i64[N, 3]) from dense
    grids `d`, `w` (and `color`, a list of 3 grids or None) whose voxel
    [0, 0, 0] is global voxel `origin_vox`; voxels outside the grids have
    weight 0. Returns {block: ({packed vertex key: (r, g, b)}, {sorted
    packed triangle})}; a block with no triangle maps to empty ones."""
    dev = d.device
    out = {}
    if len(blocks) == 0:
        return out
    blocks = np.asarray(blocks, np.int64)
    X, Y, Z = d.shape
    mw = float(np.float32(min_weight))
    r9 = torch.arange(9, device=dev)
    for s in range(0, len(blocks), 256):
        bl = torch.as_tensor(blocks[s:s + 256], device=dev)
        n = bl.shape[0]
        g0 = bl * 8 - torch.as_tensor(origin_vox, device=dev)   # [n, 3]
        gx = (g0[:, 0, None] + r9)[:, :, None, None]
        gy = (g0[:, 1, None] + r9)[:, None, :, None]
        gz = (g0[:, 2, None] + r9)[:, None, None, :]
        inside = ((gx >= 0) & (gx < X) & (gy >= 0) & (gy < Y)
                  & (gz >= 0) & (gz < Z))
        ix, iy, iz = (a.clamp(0, m - 1) for a, m in
                      ((gx, X), (gy, Y), (gz, Z)))
        dd = d[ix, iy, iz]                                        # [n,9,9,9]
        ww = torch.where(inside, w[ix, iy, iz], torch.zeros((), device=dev,
                                                            dtype=w.dtype))
        cc = ([c[ix, iy, iz] for c in color] if color is not None else None)

        def corners(a):
            return torch.stack([a[:, cx:cx + 8, cy:cy + 8, cz:cz + 8]
                                for cx, cy, cz in CORNERS.tolist()], -1
                               ).reshape(n, 512, 8)

        cd, cw = corners(dd), corners(ww)
        ok = torch.amin(cw, -1).float() >= mw
        bits = (cd < 0.0).long() << torch.arange(8, device=dev)
        case = torch.where(ok, bits.sum(-1), 0)                   # [n, 512]
        ea = torch.as_tensor(EDGES[:, 0], device=dev)
        eb = torch.as_tensor(EDGES[:, 1], device=dev)
        da, db = cd[..., ea], cd[..., eb]                         # [n,512,12]
        den = da - db
        t = torch.clamp(da / torch.where(torch.abs(den) > 1e-12, den,
                                         torch.full_like(den, 1e-12)),
                        0.0, 1.0)
        cf = torch.as_tensor(CORNERS, dtype=d.dtype, device=dev)
        lane = torch.arange(512, device=dev)
        base = torch.stack([lane // 64, (lane // 8) % 8, lane % 8], -1
                           ).to(d.dtype)                          # [512, 3]
        pa, pb = cf[ea], cf[eb]                                   # [12, 3]
        local = (pa + t[..., None] * (pb - pa) + base[None, :, None, :]
                 + 0.5).to(torch.bfloat16).float()                # [n,512,12,3]
        keys = (torch.round(local * 256).long()
                + (bl * 2048)[:, None, None, :])
        vk = pack(keys)                                           # [n,512,12]
        if cc is not None:
            cols = []
            for plane in cc:
                pc = corners(plane)
                ca, cb = pc[..., ea], pc[..., eb]
                cols.append(torch.addcmul(ca, t, cb - ca))
            col = torch.stack(cols, -1).to(torch.bfloat16).float()
            col = torch.clamp(col, 0.0, 255.0).to(torch.uint8)
        else:
            col = torch.full(vk.shape + (3,), 190, dtype=torch.uint8,
                             device=dev)
        te = torch.as_tensor(TRI_EDGES, device=dev)[case]         # [n,512,15]
        nt = torch.as_tensor(TRI_COUNTS, device=dev)[case]        # [n,512]
        slot_ok = (torch.arange(15, device=dev) < (nt * 3)[..., None]) \
            & (te >= 0)
        tri_keys = torch.gather(vk, 2, te.clamp(0, 11))           # [n,512,15]
        tri_col = torch.gather(col, 2, te.clamp(0, 11)[..., None]
                               .expand(te.shape + (3,)))
        tk, ok_s, tc = (a.cpu().numpy() for a in (tri_keys, slot_ok, tri_col))
        for i in range(n):
            verts, tris = {}, set()
            m = ok_s[i]
            for cube in np.nonzero(m.any(1))[0]:
                ks = tk[i, cube][m[cube]]
                cs = tc[i, cube][m[cube]]
                for j in range(0, len(ks), 3):
                    for q in range(3):
                        verts.setdefault(int(ks[j + q]), tuple(int(x) for x
                                                               in cs[j + q]))
                    tris.add(tuple(sorted(int(x) for x in ks[j:j + 3])))
            out[tuple(int(x) for x in blocks[s + i])] = (verts, tris)
    return out


def surface_blocks(d, w, origin_vox, min_weight: float) -> np.ndarray:
    """Global block indices i64[N, 3] of every block with a cube to mesh:
    all 8 corners of weight >= `min_weight`, corners on both sides of 0.
    Voxels outside the grids have weight 0."""
    mw = float(np.float32(min_weight))
    X, Y, Z = d.shape

    def padded(mask):
        return torch.nn.functional.pad(mask[None, None].float(),
                                       (0, 1, 0, 1, 0, 1))[0, 0] > 0

    ok, neg = padded(w.float() >= mw), padded(d < 0.0)
    all_ok = torch.ones((X, Y, Z), dtype=torch.bool, device=d.device)
    any_neg = torch.zeros_like(all_ok)
    all_neg = torch.ones_like(all_ok)
    for cx, cy, cz in CORNERS.tolist():
        sl = (slice(cx, cx + X), slice(cy, cy + Y), slice(cz, cz + Z))
        all_ok &= ok[sl]
        any_neg |= neg[sl]
        all_neg &= neg[sl]
    cube = all_ok & any_neg & ~all_neg
    per = cube.view(X // 8, 8, Y // 8, 8, Z // 8, 8).any(5).any(3).any(1)
    return (torch.nonzero(per).cpu().numpy()
            + np.asarray(origin_vox, np.int64) // 8).astype(np.int64)


def program_block_mesh(vertices: np.ndarray, colors: np.ndarray,
                       triangles: np.ndarray, voxel_size_m: float):
    """A program's welded block mesh (vertices in meters) in the same
    form: vertex keys from round(256 * vertex / voxel)."""
    vs = np.float64(np.float32(voxel_size_m))
    keys = np.round(np.asarray(vertices, np.float64) / vs * 256.0
                    ).astype(np.int64)
    packed = ((keys[:, 0] + _OFF) << 42) | ((keys[:, 1] + _OFF) << 21) \
        | (keys[:, 2] + _OFF)
    verts = {}
    for k, c in zip(packed.tolist(), np.asarray(colors).tolist()):
        verts.setdefault(int(k), tuple(int(x) for x in c))
    tris = {tuple(sorted(int(packed[i]) for i in tri))
            for tri in np.asarray(triangles)}
    return verts, tris


def mesh_off(program: Dict, reference: Dict) -> Tuple[int, int]:
    """(off, total) over the blocks of either side: vertex keys on one
    side only, shared vertices whose colors differ by more than 1, and
    triangles on one side only; total counts the union of vertices and of
    triangles."""
    off = total = 0
    empty = ({}, set())
    for key in set(program) | set(reference):
        pv, pt = program.get(key, empty)
        rv, rt = reference.get(key, empty)
        pk, rk = set(pv), set(rv)
        off += len(pk ^ rk) + len(pt ^ rt)
        off += sum(1 for k in pk & rk
                   if max(abs(a - b) for a, b in zip(pv[k], rv[k])) > 1)
        total += len(pk | rk) + len(pt | rt)
    return off, total
