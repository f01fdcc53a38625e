"""ESDF site extraction and the host-table Mapper's iterative solver (port
of isaac_ros_nvblox_tpu/ops/esdf.py).

Sites are observed voxels within `max_site_distance_vox` of the surface
(TSDF layer) or observed occupied voxels (occupancy layer); `is_inside` and
`observed` carry the sign and observation to the ESDF channels
(EsdfVoxel{squared_distance_vox, is_inside, observed}). The DeviceMapper
solves the field with the dense EDT (`ops/esdf_dense.py`); the host-table
`Mapper` with the relaxation sweeps below.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (device_constant,
                                                   local_voxel_offsets,
                                                   sqrt32)

INF_SQ = 1e12
_LOCAL_OFFSETS = local_voxel_offsets()


@dataclasses.dataclass(frozen=True)
class EsdfIntegratorParams:
    """The reference's esdf_integrator_* parameters."""
    max_esdf_distance_m: float = 2.0
    max_site_distance_vox: float = 1.0
    min_weight: float = 1e-4
    occupied_log_odds_threshold: float = 0.0


def esdf_sites_from_tsdf(tsdf_distance, tsdf_weight, *, voxel_size_m,
                         max_site_distance_vox: float, min_weight: float):
    """Derive (is_site, is_inside, observed) `bool[cap, 512]` from TSDF."""
    observed = tsdf_weight >= min_weight
    inside = observed & (tsdf_distance <= 0.0)
    band = float(np.float32(max_site_distance_vox) * np.float32(voxel_size_m))
    site = observed & (torch.abs(tsdf_distance) <= band)
    return site, inside, observed


def esdf_sites_from_occupancy(log_odds, observed_mask, *,
                              occupied_log_odds_threshold: float):
    """Sites from an occupancy layer: observed voxels above the log-odds
    threshold are sites and inside. Returns (is_site, is_inside,
    observed) `bool[cap, 512]`."""
    occupied = observed_mask & (
        log_odds > float(np.float32(occupied_log_odds_threshold)))
    return occupied, occupied, observed_mask


# --------------------------------------------------- the iterative solver
# The host-table Mapper's ESDF (the reference runs it outside any Pallas
# kernel): every voxel holds the global voxel coordinate of its nearest
# known site, and relaxation sweeps over blocks with a one-voxel halo move
# site candidates outward. One outer pass runs `inner_iters` sweeps in
# every block of the batch, so each pass carries distances 8 voxels across
# block boundaries; the host loops until a pass changes nothing. A sweep
# gives each voxel the site of the first of its 26 neighbours (in
# _SHIFTS order) that strictly shortens its distance, within the maximum.
# Site coordinates are integers, so every distance is exact in float32.

B = 8
_SHIFTS = [(dx, dy, dz)
           for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
           if (dx, dy, dz) != (0, 0, 0)]


def init_esdf_from_sites(site_coord, sq_dist, is_site, block_indices_all):
    """(Re)initialize the site and distance channels from the site mask:
    a site holds its own global voxel coordinate at distance 0, every other
    voxel no site at INF_SQ. In place; returns (site_coord f32[cap, 512, 3],
    sq_dist f32[cap, 512])."""
    offs = device_constant(_LOCAL_OFFSETS, sq_dist.device).float()
    own = block_indices_all.float()[:, None, :] * B + offs[None]
    site_coord.copy_(torch.where(is_site[..., None], own,
                                 torch.zeros((), device=own.device)))
    sq_dist.copy_(torch.where(is_site, torch.zeros((), device=own.device),
                              torch.full((), INF_SQ, device=own.device)))
    return site_coord, sq_dist


def _relax_once(site_p, sq_p, coords, max_sq: float):
    """One sweep over padded neighbourhoods: site planes `f32[3, N, P, P,
    P]` (x, y, z), distances `f32[N, P, P, P]`, voxel coordinates like the
    sites; a neighbour outside the padded block has no site."""
    N, P = sq_p.shape[0], sq_p.shape[1]
    Q = P + 2
    has_pp = torch.nn.functional.pad(sq_p < INF_SQ * 0.5, (1, 1, 1, 1, 1, 1))
    site_pp = torch.nn.functional.pad(site_p, (1, 1, 1, 1, 1, 1))
    inf = torch.full((), float("inf"), device=sq_p.device)
    cand_sqs = [sq_p]
    for dx, dy, dz in _SHIFTS:
        win = (slice(None), slice(1 + dx, 1 + dx + P),
               slice(1 + dy, 1 + dy + P), slice(1 + dz, 1 + dz + P))
        cs = site_pp[(slice(None),) + win]
        diff = coords - cs
        cand_sq = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        ok = has_pp[win] & (cand_sq <= max_sq)
        cand_sqs.append(torch.where(ok, cand_sq, inf))
    # The first candidate of least distance, the current site first: the
    # sequential strict-improvement scan.
    best_sq, idx = torch.min(torch.stack(cand_sqs), dim=0)
    # Each voxel takes the site of the chosen neighbour, read from the
    # flattened padded planes.
    delta = torch.tensor([0] + [(dx * Q + dy) * Q + dz
                                for dx, dy, dz in _SHIFTS],
                         device=sq_p.device)
    r = torch.arange(P, device=sq_p.device) + 1
    base = ((torch.arange(N, device=sq_p.device)[:, None, None, None] * Q
             + r[:, None, None]) * Q + r[:, None]) * Q + r
    lin = (base + delta[idx]).reshape(-1)
    best_site = site_pp.reshape(3, -1)[:, lin].reshape(site_p.shape)
    return best_site, best_sq


def esdf_sweep_pass(site_coord, sq_dist, neighbor_slots, slots,
                    block_indices, *, inner_iters: int = B,
                    max_sq_dist_vox: float):
    """One outer relaxation pass over a batch of allocated blocks: gather
    each block with its one-voxel halo, run `inner_iters` sweeps there and
    write the interiors back, in place.

    Args:
      site_coord, sq_dist: `f32[cap, 512, 3]`, `f32[cap, 512]`.
      neighbor_slots: `i32[N, 27]` neighbour rows (-1 = absent).
      slots: `i64[N]` the blocks' slots, all in [0, cap).
      block_indices: `i32[N, 3]`.

    Returns (site_coord, sq_dist, num_changed): the voxels whose distance
    fell."""
    from isaac_ros_nvblox_tpu_torch.ops.halo import gather_halo_sliced
    cap = sq_dist.shape[0]
    site_grid = site_coord.view(cap, B, B, B, 3)
    sq_grid = sq_dist.view(cap, B, B, B)
    site_p = gather_halo_sliced(site_grid, neighbor_slots, fill=0.0) \
        .permute(4, 0, 1, 2, 3).contiguous()
    sq_p = gather_halo_sliced(sq_grid, neighbor_slots, fill=INF_SQ)
    N, P = sq_p.shape[0], B + 2
    r = torch.arange(P, dtype=torch.float32, device=sq_p.device) - 1.0
    origin = (block_indices.float() * B).T[:, :, None, None, None]
    coords = torch.stack([r[:, None, None].expand(P, P, P),
                          r[None, :, None].expand(P, P, P),
                          r[None, None, :].expand(P, P, P)])[:, None] \
        + origin
    max_sq = float(np.float32(max_sq_dist_vox))
    for _ in range(inner_iters):
        site_p, sq_p = _relax_once(site_p, sq_p, coords, max_sq)
    new_site = site_p[:, :, 1:-1, 1:-1, 1:-1].reshape(3, N, B ** 3) \
        .permute(1, 2, 0)
    new_sq = sq_p[:, 1:-1, 1:-1, 1:-1].reshape(N, B ** 3)
    changed = (new_sq < sq_dist[slots] - 1e-6).sum()
    site_coord[slots] = new_site
    sq_dist[slots] = new_sq
    return site_coord, sq_dist, changed


def update_esdf(pool, table, *, voxel_size_m: float,
                params: EsdfIntegratorParams, sites_from: str = "tsdf",
                max_outer_iters: int = 16) -> int:
    """Full ESDF update over all allocated blocks of a host-table pool
    (`core/block_pool.py`). Returns the number of outer passes.

    Requires the channels `tsdf_distance`/`tsdf_weight` (or
    `occupancy_log_odds` + `occupancy_observed` when `sites_from ==
    "occupancy"`), `esdf_site` f32[cap, 512, 3], `esdf_sq_dist`
    f32[cap, 512] and the bool channels `esdf_is_site`, `esdf_is_inside`,
    `esdf_observed`. Every pass sweeps every allocated block; the host
    reads one count per pass and stops at a pass that changed nothing."""
    if sites_from == "tsdf":
        is_site, is_inside, observed = esdf_sites_from_tsdf(
            pool["tsdf_distance"], pool["tsdf_weight"],
            voxel_size_m=voxel_size_m,
            max_site_distance_vox=float(params.max_site_distance_vox),
            min_weight=float(params.min_weight))
    elif sites_from == "occupancy":
        is_site, is_inside, observed = esdf_sites_from_occupancy(
            pool["occupancy_log_odds"], pool["occupancy_observed"] > 0,
            occupied_log_odds_threshold=float(
                params.occupied_log_odds_threshold))
    else:
        raise ValueError(sites_from)
    pool["esdf_is_site"] = is_site
    pool["esdf_is_inside"] = is_inside
    pool["esdf_observed"] = observed
    dev = is_site.device
    site, sq = pool["esdf_site"], pool["esdf_sq_dist"]
    init_esdf_from_sites(site, sq, is_site,
                         torch.as_tensor(table.block_indices, device=dev))
    slots = table.allocated_slots()
    if slots.size == 0:
        return 0
    nb = torch.as_tensor(table.neighbors[slots], device=dev)
    bidx = torch.as_tensor(table.block_indices[slots], device=dev)
    slots = torch.as_tensor(slots, dtype=torch.int64, device=dev)
    max_sq = (params.max_esdf_distance_m / voxel_size_m) ** 2
    iters = 0
    for iters in range(1, max_outer_iters + 1):
        _, _, changed = esdf_sweep_pass(site, sq, nb, slots, bidx,
                                        max_sq_dist_vox=max_sq)
        if int(changed) == 0:
            break
    return iters


def esdf_distance_m(pool, voxel_size_m: float,
                    max_esdf_distance_m: float) -> torch.Tensor:
    """Signed metric ESDF `f32[cap, 512]`: negative inside, clamped at the
    maximum distance."""
    d = sqrt32(torch.clamp_max(pool["esdf_sq_dist"], INF_SQ)) \
        * float(np.float32(voxel_size_m))
    d = torch.clamp_max(d, float(np.float32(max_esdf_distance_m)))
    return torch.where(pool["esdf_is_inside"], -d, d)
