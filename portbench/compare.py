"""The comparison that decides `correct`: a program's map, slice, ESDF and
mesh against the plain reference's, as shares of elements that disagree.

A program's voxel channels arrive as pool rows: global block indices
i64[N, 3] and rows [N, 512] with voxel (x, y, z) of a block at lane
x * 64 + y * 8 + z. The reference holds dense grids (reference/fusion.py's
DenseMap). Each number is `off / total`, where `total` counts the elements
either side has (observed voxels, colored voxels, known cells, mesh
vertices and triangles) and `off` those that one side lacks or that differ
by more than the fixed tolerance below. The tolerances sit far above
float32 rounding and far below what one change of a sample, a site or a
cube makes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

TSDF_TOL_M = 1e-5       # distance
WEIGHT_TOL = 1e-5       # TSDF and color weight
COLOR_TOL = 1e-3        # color channels, 0-255
SLICE_TOL_M = 1e-5      # published 2-D distances
SQ_TOL = 0.5            # squared voxel distances (integers)


def ref_rows(grid, origin_vox, blocks: np.ndarray):
    """The rows [N, 512] of a dense grid at global blocks `blocks`; zeros
    (False) for blocks outside it."""
    X, Y, Z = grid.shape
    g = grid.view(X // 8, 8, Y // 8, 8, Z // 8, 8).permute(0, 2, 4, 1, 3, 5)
    cells = torch.as_tensor(np.asarray(blocks, np.int64)
                            - np.asarray(origin_vox, np.int64) // 8,
                            device=grid.device)
    inside = ((cells >= 0) & (cells < torch.as_tensor(
        [X // 8, Y // 8, Z // 8], device=grid.device))).all(1)
    c = torch.where(inside[:, None], cells, torch.zeros_like(cells))
    rows = g[c[:, 0], c[:, 1], c[:, 2]].reshape(-1, 512)
    return torch.where(inside[:, None], rows, torch.zeros_like(rows))


def _covered(shape_b, origin_vox, blocks, device):
    """bool[Xb, Yb, Zb]: grid blocks that are among `blocks`."""
    cov = torch.zeros(shape_b, dtype=torch.bool, device=device)
    cells = np.asarray(blocks, np.int64) - np.asarray(origin_vox) // 8
    ok = np.all((cells >= 0) & (cells < np.asarray(shape_b)), axis=1)
    c = torch.as_tensor(cells[ok], device=device)
    if c.numel():
        cov[c[:, 0], c[:, 1], c[:, 2]] = True
    return cov


def _outside_count(mask, origin_vox, blocks) -> int:
    """Set voxels of a dense bool grid in blocks not among `blocks`."""
    X, Y, Z = mask.shape
    per_block = mask.view(X // 8, 8, Y // 8, 8, Z // 8, 8).sum((1, 3, 5))
    cov = _covered(per_block.shape, origin_vox, blocks, mask.device)
    return int(per_block[~cov].sum())


def tsdf_off(blocks, d, w, ref) -> Tuple[int, int]:
    """Voxels observed (weight > 0) on either side: off where only one
    side observed them or distance or weight differ."""
    dev = ref.d.device
    d = torch.as_tensor(d, device=dev).float()
    w = torch.as_tensor(w, device=dev).float()
    rd = ref_rows(ref.d, ref.origin, blocks).float()
    rw = ref_rows(ref.w, ref.origin, blocks).float()
    po, ro = w > 0, rw > 0
    both = po & ro
    bad = (po != ro) | (both & ((d - rd).abs() > TSDF_TOL_M)) \
        | (both & ((w - rw).abs() > WEIGHT_TOL))
    extra = _outside_count(ref.w > 0, ref.origin, blocks)
    return int(bad.sum()) + extra, int((po | ro).sum()) + extra


def color_off(blocks, color, ref) -> Tuple[int, int]:
    """Voxels with color weight > 0 on either side; `color` [N, 512, 4]
    (r, g, b, weight)."""
    dev = ref.d.device
    c = torch.as_tensor(color, device=dev).float()
    rc = torch.stack([ref_rows(g, ref.origin, blocks).float()
                      for g in ref.color], -1)
    po, ro = c[..., 3] > 0, rc[..., 3] > 0
    both = po & ro
    diff = (c[..., :3] - rc[..., :3]).abs().amax(-1)
    bad = (po != ro) | (both & (diff > COLOR_TOL)) \
        | (both & ((c[..., 3] - rc[..., 3]).abs() > WEIGHT_TOL))
    extra = _outside_count(ref.color[3] > 0, ref.origin, blocks)
    return int(bad.sum()) + extra, int((po | ro).sum()) + extra


def slice_off(program: Optional[Dict], ref: Dict, unknown: float,
              voxel_size_m: float) -> Tuple[int, int]:
    """Cells of two published slices ({origin_x_m, origin_y_m, width,
    height, data f32[H, W]}) known on either side, each placed at its own
    origin: off where only one side knows them or the distances differ.
    A cell outside a side's frame is unknown there, so a slice that is
    cropped or shifted is off where the other knows its cells."""
    sides = [s for s in (program, ref) if s is not None]
    if not sides:
        return 0, 0
    o = [(int(round(s["origin_x_m"] / voxel_size_m)),
          int(round(s["origin_y_m"] / voxel_size_m))) for s in sides]
    x0, y0 = min(a for a, _ in o), min(b for _, b in o)
    W = max(a + int(s["width"]) for (a, _), s in zip(o, sides)) - x0
    H = max(b + int(s["height"]) for (_, b), s in zip(o, sides)) - y0

    def placed(s):
        g = torch.full((H, W), float(np.float32(unknown)), dtype=torch.float64)
        if s is not None:
            a = int(round(s["origin_x_m"] / voxel_size_m)) - x0
            b = int(round(s["origin_y_m"] / voxel_size_m)) - y0
            d = torch.as_tensor(np.asarray(s["data"], np.float32)).double()
            g[b:b + d.shape[0], a:a + d.shape[1]] = d
        return g

    a, b = placed(program), placed(ref)
    ka, kb = a != np.float32(unknown), b != np.float32(unknown)
    bad = (ka != kb) | (ka & kb & ((a - b).abs() > SLICE_TOL_M))
    return int(bad.sum()), int((ka | kb).sum())


def esdf_off(blocks, sq, inside, observed, ref_sq, ref_inside,
             ref_observed, origin_vox) -> Tuple[int, int]:
    """Voxels of the program's blocks observed on either side: off where
    observation, sign or squared distance differ."""
    dev = ref_sq.device
    sq = torch.as_tensor(sq, device=dev).float()
    ins = torch.as_tensor(inside, device=dev).bool()
    obs = torch.as_tensor(observed, device=dev).bool()
    rsq = ref_rows(ref_sq, origin_vox, blocks).float()
    rins = ref_rows(ref_inside, origin_vox, blocks).bool()
    robs = ref_rows(ref_observed, origin_vox, blocks).bool()
    finite, rfinite = sq < 1e11, rsq < 1e11
    bad = (obs != robs) | (ins != rins) | (finite != rfinite) \
        | (finite & rfinite & ((sq - rsq).abs() > SQ_TOL))
    return int((bad & (obs | robs)).sum()), int((obs | robs).sum())


def share(off_total: Tuple[int, int]) -> Optional[float]:
    off, total = off_total
    return off / total if total else None
