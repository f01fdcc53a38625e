"""ESDF site extraction (port of isaac_ros_nvblox_tpu/ops/esdf.py).

Sites are observed voxels within `max_site_distance_vox` of the surface
(TSDF layer) or observed occupied voxels (occupancy layer); `is_inside` and
`observed` carry the sign and observation to the ESDF channels
(EsdfVoxel{squared_distance_vox, is_inside, observed}).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INF_SQ = 1e12


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
