"""GroundPlaneEstimator: RANSAC plane fit over TSDF zero crossings (port of
isaac_ros_nvblox_tpu/ops/ground_plane.py).

nvblox's GroundPlaneEstimator feeds the ESDF slice above the ground plane.
Candidates are the voxels where the TSDF crosses from negative (below the
floor) to positive along +z within each block column, with a +1 halo so
that floors on block boundaries count. RANSAC runs on the device with a
fixed hypothesis count: 3-point plane fits scored by inlier count, then a
least-squares refit on the best hypothesis' inliers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import VOXELS_PER_SIDE
from isaac_ros_nvblox_tpu_torch.ops.halo import gather_halo

B = VOXELS_PER_SIDE
_BIG = 2 ** 30


@dataclasses.dataclass(frozen=True)
class GroundPlaneEstimatorParams:
    """nvblox's ground_plane_estimator_* / ransac_plane_fitter_* params."""
    ground_points_candidates_min_z_m: float = -0.2
    ground_points_candidates_max_z_m: float = 0.5
    ransac_distance_threshold_m: float = 0.05
    num_ransac_iterations: int = 128


@dataclasses.dataclass
class Plane:
    """z = a*x + b*y + c; the normal points up (+z)."""
    a: float
    b: float
    c: float

    def height_at(self, x, y):
        return self.a * x + self.b * y + self.c

    def normal(self) -> np.ndarray:
        n = np.asarray([-self.a, -self.b, 1.0])
        return n / np.linalg.norm(n)


@torch.no_grad()
def tsdf_zero_crossings_ground_candidates(tsdf_pad, weight_pad,
                                          block_indices, valid_blocks, *,
                                          voxel_size_m: float, min_z_m: float,
                                          max_z_m: float,
                                          min_weight: float = 1e-4):
    """Per block column: candidate points `f32[N, 64, 3]` and their valid
    mask `bool[N, 64]`.

    The candidate of a column is the sub-voxel z where the TSDF first
    crosses from negative to non-negative along +z. Inputs are the +1-halo
    grids `[N, 9, 9, 9]` (`gather_halo(lo=0, hi=1)`).
    """
    N = tsdf_pad.shape[0]
    dev = tsdf_pad.device
    d = tsdf_pad[:, :B, :B, :]        # [N, 8, 8, 9]: z keeps its halo
    w = weight_pad[:, :B, :B, :]
    below, above = d[..., :-1], d[..., 1:]
    crossing = ((below < 0.0) & (above >= 0.0)
                & (w[..., :-1] >= min_weight) & (w[..., 1:] >= min_weight))
    diff = below - above
    t = below / torch.where(diff.abs() > 1e-9, diff,
                            torch.full((), 1e-9, device=dev))
    zi = torch.arange(B, dtype=torch.float32, device=dev)
    z_local = zi + torch.clamp(t, 0.0, 1.0)
    # The lowest crossing of each column (argmax gives the first maximum).
    first = torch.argmax(crossing.to(torch.uint8), dim=3)
    any_cross = crossing.any(dim=3)
    z_sel = torch.gather(z_local, 3, first[..., None])[..., 0]
    b = block_indices.float()
    xi = torch.arange(B, dtype=torch.float32, device=dev)[None, :, None]
    yi = torch.arange(B, dtype=torch.float32, device=dev)[None, None, :]
    px = (b[:, 0, None, None] * B + xi + 0.5) * voxel_size_m
    py = (b[:, 1, None, None] * B + yi + 0.5) * voxel_size_m
    pz = (b[:, 2, None, None] * B + z_sel + 0.5) * voxel_size_m
    px, py = px.expand(N, B, B), py.expand(N, B, B)
    pts = torch.stack([px, py, pz], dim=-1).reshape(N, B * B, 3)
    valid = (any_cross & valid_blocks[:, None, None]
             & (pz >= min_z_m) & (pz <= max_z_m)).reshape(N, B * B)
    return pts, valid


@torch.no_grad()
def ransac_plane_fit(points, valid, *, params: GroundPlaneEstimatorParams,
                     draw=None, generator: Optional[torch.Generator] = None):
    """Fixed-iteration RANSAC plane fit on the device.

    points f32[N, 3], valid bool[N]. Hypotheses draw 3 candidates each
    among the first min(N, 16384) valid points: `draw` (i32[iterations, 3]
    raw draws in [0, min(N, 16384)), taken modulo the candidate count) or,
    without it, draws from `generator`. Returns (coefficients f32[3] (a, b,
    c), inlier count i32[], ok bool[]), all on the device.
    """
    N = points.shape[0]
    dev = points.device
    n_hyp = params.num_ransac_iterations
    max_cand = min(N, 16384)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    keys = torch.sort(torch.where(valid, ids, _BIG)).values[:max_cand]
    cand_idx = torch.where(keys < _BIG, keys, 0).long()
    n_valid = torch.clamp_min(valid.sum(dtype=torch.int32), 1)
    if draw is None:
        draw = torch.randint(0, max_cand, (n_hyp, 3), generator=generator,
                             dtype=torch.int32,
                             device=generator.device if generator else "cpu")
    draw = draw.to(dev)
    idx = cand_idx[torch.remainder(draw, torch.clamp_max(n_valid, max_cand))
                   .long()]
    tri = points[idx]                                      # [H, 3, 3]
    tri_valid = valid[idx].all(dim=1)
    # Plane z = a x + b y + c through 3 points: [x y 1][a b c]^T = z.
    A = torch.cat([tri[..., :2], torch.ones((n_hyp, 3, 1), device=dev)], -1)
    z = tri[..., 2]
    det_ok = torch.linalg.det(A).abs() > 1e-9
    eye = torch.eye(3, device=dev).expand(n_hyp, 3, 3)
    # `solve_ex` without its error check: a hypothesis whose determinant
    # passes the test but whose LU meets a zero pivot gives non-finite
    # coefficients and no inliers, as in the reference, instead of raising
    # (and reading the solver's status back to the host).
    coeffs = torch.linalg.solve_ex(
        torch.where(det_ok[:, None, None], A, eye),
        z[..., None])[0][..., 0]                           # [H, 3]
    pred_z = (points[None, :, 0] * coeffs[:, 0:1]
              + points[None, :, 1] * coeffs[:, 1:2] + coeffs[:, 2:3])
    resid = (points[None, :, 2] - pred_z).abs()
    inliers = (resid <= params.ransac_distance_threshold_m) & valid[None, :]
    scores = torch.where(tri_valid & det_ok, inliers.sum(dim=1,
                                                         dtype=torch.int32),
                         -1)
    best = torch.argmax(scores)
    wgt = inliers[best].float()
    X = torch.cat([points[:, :2], torch.ones((N, 1), device=dev)], -1)
    XtX = (X * wgt[:, None]).T @ X + 1e-6 * torch.eye(3, device=dev)
    Xtz = (X * wgt[:, None]).T @ points[:, 2]
    refit = torch.linalg.solve_ex(XtX, Xtz)[0]
    return refit, scores[best], scores[best] > 10


class GroundPlaneEstimator:
    """Candidate extraction and RANSAC over a mapper's TSDF: a DeviceMapper
    (`estimate_device`) or the host-table Mapper (`estimate`)."""

    def __init__(self, params: Optional[GroundPlaneEstimatorParams] = None,
                 seed: int = 0):
        self.params = params or GroundPlaneEstimatorParams()
        self._generator = torch.Generator().manual_seed(seed)
        self.last_plane: Optional[Plane] = None
        # The valid candidates of the last `estimate`, `f32[K, 3]` (numpy).
        self.last_candidates: Optional[np.ndarray] = None

    def _fit(self, d_pad, w_pad, bidx, valid_blocks, voxel_size_m: float):
        """Candidates of the halo grids, then RANSAC: (plane or None,
        points f32[N * 64, 3], valid bool[N * 64])."""
        p = self.params
        pts, valid = tsdf_zero_crossings_ground_candidates(
            d_pad, w_pad, bidx, valid_blocks, voxel_size_m=voxel_size_m,
            min_z_m=p.ground_points_candidates_min_z_m,
            max_z_m=p.ground_points_candidates_max_z_m)
        pts, valid = pts.reshape(-1, 3), valid.reshape(-1)
        coeffs, _, ok = ransac_plane_fit(pts, valid, params=p,
                                         generator=self._generator)
        if not bool(ok):
            return None, pts, valid
        c = coeffs.cpu().numpy()
        self.last_plane = Plane(a=float(c[0]), b=float(c[1]), c=float(c[2]))
        return self.last_plane, pts, valid

    @torch.no_grad()
    def estimate_device(self, m) -> Optional[Plane]:
        """Estimate from a DeviceMapper (halo, candidates and RANSAC on its
        device; one small read of the coefficients). None without a TSDF
        or without enough inliers."""
        if "tsdf_distance" not in m.channels:
            return None
        cap = m.capacity
        bidx = m.state.block_index_of_slot
        nbrs = wg.neighbor_slots_of(m.state, bidx)
        grid = (cap, B, B, B)
        d_pad = gather_halo(m.channels["tsdf_distance"].reshape(grid), nbrs,
                            lo=0, hi=1)
        w_pad = gather_halo(m.channels["tsdf_weight"].reshape(grid), nbrs,
                            lo=0, hi=1)
        return self._fit(d_pad, w_pad, bidx, wg.live_slot_mask(m.state),
                         m.voxel_size_m)[0]

    @torch.no_grad()
    def estimate(self, mapper) -> Optional[Plane]:
        """Estimate from the host-table `Mapper`: the halo of its allocated
        slots through the table's neighbour rows; keeps the valid
        candidates in `last_candidates`. None without a TSDF, without
        blocks or without enough inliers."""
        pool = mapper.pool
        if "tsdf_distance" not in pool.channels:
            return None
        slots = mapper.table.allocated_slots()
        if slots.size == 0:
            return None
        nbrs = torch.as_tensor(mapper.table.neighbors[slots],
                               device=pool.device)
        d_pad = gather_halo(pool.voxel_grid_view("tsdf_distance"), nbrs,
                            lo=0, hi=1)
        w_pad = gather_halo(pool.voxel_grid_view("tsdf_weight"), nbrs,
                            lo=0, hi=1)
        bidx = torch.as_tensor(mapper.table.block_indices[slots],
                               device=pool.device)
        plane, pts, valid = self._fit(
            d_pad, w_pad, bidx,
            torch.ones(slots.size, dtype=torch.bool, device=pool.device),
            mapper.voxel_size_m)
        if plane is not None:
            self.last_candidates = pts[valid].cpu().numpy()
        return plane
