"""Plain PyTorch reference of nvblox's ESDF from a TSDF.

Sites are observed voxels (weight >= `min_weight`) within
`max_site_distance_vox` voxels of the surface; `inside` marks observed
voxels with distance <= 0. The field is the exact squared Euclidean
distance, in voxels, from each voxel to its nearest site, kept where it
is at most band^2 (band = ceil(max_esdf_distance / voxel)) and infinite
beyond: three separable passes (x, y, z), each a minimum over the
candidates within `band` along its axis.

The 2-D mode collapses the sites of a height band onto one cell per
(x, y) column and solves the planar field the same way; a column is
inside or observed where any band voxel of it is. The published slice is
sqrt(sq) * voxel, clamped to the maximum distance, negative inside, and
the unknown value where no band voxel was observed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INF = 1e12


def band_of(max_esdf_distance_m: float, voxel_size_m: float) -> int:
    return int(math.ceil(max_esdf_distance_m / voxel_size_m))


def sites(d, w, voxel_size_m: float, max_site_distance_vox: float = 1.0,
          min_weight: float = 1e-4):
    """(site, inside, observed) bool grids of a TSDF."""
    observed = w >= min_weight
    lim = float(np.float32(max_site_distance_vox) * np.float32(voxel_size_m))
    return (observed & (torch.abs(d) <= lim), observed & (d <= 0.0), observed)


def _pass(g, axis: int, band: int):
    """min over |k| <= band of g shifted by k along `axis`, plus k^2."""
    out = g.clone()
    n = g.shape[axis]
    for k in range(1, min(band, n - 1) + 1):
        kk = torch.full((), float(k * k), dtype=g.dtype, device=g.device)
        a = g.narrow(axis, k, n - k) + kk           # from +k
        b = g.narrow(axis, 0, n - k) + kk           # from -k
        lo = out.narrow(axis, 0, n - k)
        lo.copy_(torch.minimum(lo, a))
        hi = out.narrow(axis, k, n - k)
        hi.copy_(torch.minimum(hi, b))
    return out


def edt(site, band: int, dtype=torch.float32):
    """Banded squared EDT (voxels) of a bool site grid of any rank."""
    inf = torch.full((), INF, dtype=dtype, device=site.device)
    g = torch.where(site, torch.zeros((), dtype=dtype, device=site.device),
                    inf)
    for axis in range(site.dim()):
        g = _pass(g, axis, band)
    return torch.where(g <= float(band * band), g, inf)


def z_band(origin_z: int, nz: int, voxel_size_m: float, lo_m: float,
           hi_m: float, device):
    """bool[nz]: the voxel centres' z, (k + 0.5) * voxel in float32, within
    [lo_m, hi_m] (the bounds rounded to float32)."""
    z = ((torch.arange(nz, device=device) + origin_z).float() + 0.5) \
        * float(np.float32(voxel_size_m))
    return (z >= float(np.float32(lo_m))) & (z <= float(np.float32(hi_m)))


def slice_2d(site, inside, observed, zmask, band: int, voxel_size_m: float,
             max_distance_m: float, unknown: float, dtype=torch.float32):
    """The 2-D ESDF's distance image f32[X, Y] from 3-D grids and the band
    mask over z."""
    col = lambda m: (m & zmask[None, None, :]).any(2)
    sq = edt(col(site), band, dtype)
    vs = float(np.float32(voxel_size_m))
    dist = torch.sqrt(torch.clamp_max(sq, INF)) * vs
    dist = torch.clamp_max(dist, float(np.float32(max_distance_m)))
    dist = torch.where(col(inside), -dist, dist)
    return torch.where(col(observed), dist,
                       torch.full((), float(unknown), dtype=dtype,
                                  device=dist.device))
