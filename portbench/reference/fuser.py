"""Plain reference of the offline fuser's map: the lap's frames replayed in
order on a dense map, as nvblox's Fuser integrates a dataset: depth every
frame, color every `color_frame_subsampling`-th frame (the frame's own
depth as the occlusion test), the ESDF every `esdf_frame_subsampling`-th
and the mesh every `mesh_frame_subsampling`-th.

At the last frame it gives the TSDF and color, the 3-D ESDF (squared voxel
distances, inside and observed grids) and the meshes of every block with
a cube to mesh. This module imports torch, numpy and the other reference modules
only.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import esdf as esdf_ref
from . import mesh as mesh_ref
from .fusion import DenseMap, FusionParams, Pinhole
from .node import map_box


def fusion_params(config: Dict) -> FusionParams:
    pj = config["mapper"]["projective"]
    return FusionParams(
        voxel_size_m=float(config["fuser"]["voxel_size_m"]),
        max_integration_distance_m=float(pj["max_integration_distance_m"]),
        truncation_distance_vox=float(pj["truncation_distance_vox"]),
        max_weight=float(pj["max_weight"]),
        weighting_mode=str(pj["weighting_mode"]))


def replay(config: Dict, lap, n_frames: int, *, device,
           dtype=torch.float32, window_from: int = 0,
           mesh: bool = False) -> Dict:
    """Frames 0 .. n_frames - 1 (frame j shows the lap's frame j mod its
    length). Returns the final `map`, the final `esdf` (sq, inside,
    observed grids over the map), with `mesh` the meshes of every block
    with a cube to mesh, and the
    `work` of the frames from `window_from`: the blocks each depth frame
    updated and, per ESDF update, the cells it must read and write."""
    f = config["fuser"]
    e = config["mapper"]["esdf"]
    fp = fusion_params(config)
    c = config["camera"]
    cam = Pinhole(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                  float(c["cy"]), int(c["width"]), int(c["height"]))
    probe = DenseMap.world_probe(config["world"], fp, device)
    regions = []
    for k in range(lap.depths.shape[0]):
        r = probe._depth_region(torch.as_tensor(lap.depths[k], device=device),
                                lap.poses[k], cam)
        if r is not None:
            regions.append((r[0] + probe.origin, r[1] + probe.origin))
    origin, dims = map_box(config, regions)
    dmap = DenseMap(origin, dims, fp, dtype=dtype, device=device)
    band = esdf_ref.band_of(float(e["max_esdf_distance_m"]), fp.voxel_size_m)
    mb = (band + 7) // 8
    work = {"depth_blocks": [], "esdf_cells": [], "frames_window": 0}
    dirty = None
    n = lap.depths.shape[0]
    for j in range(n_frames):
        depth = torch.as_tensor(lap.depths[j % n], device=device)
        T = lap.poses[j % n]
        nb = dmap.integrate_depth(depth, T, cam)
        if dmap.last_blocks is not None:
            lo, hi = dmap.last_blocks
            dirty = (lo, hi) if dirty is None else (
                np.minimum(dirty[0], lo), np.maximum(dirty[1], hi))
        if j >= window_from:
            work["depth_blocks"].append(nb)
            work["frames_window"] += 1
        if j % int(f["color_frame_subsampling"]) == 0:
            dmap.integrate_color(torch.as_tensor(lap.colors[j % n],
                                                 device=device), T, cam,
                                 depth=depth)
        if j % int(f["esdf_frame_subsampling"]) == 0:
            aabb = dmap.block_aabb_observed(float(e["min_weight"]))
            if j >= window_from and aabb is not None and dirty is not None:
                work["esdf_cells"].append(
                    esdf_update_cells(aabb, dirty, mb, first=j == 0))
            dirty = None
    site, inside, obs = esdf_ref.sites(
        dmap.d, dmap.w, fp.voxel_size_m, float(e["max_site_distance_vox"]),
        float(e["min_weight"]))
    out = {"map": dmap, "work": work,
           "esdf": (esdf_ref.edt(site, band, dtype), inside, obs)}
    if mesh:
        mw = float(config["mapper"]["mesh"]["min_weight"])
        out["mesh"] = mesh_ref.mesh_blocks(
            dmap.d, dmap.w, dmap.color[:3], dmap.origin,
            mesh_ref.surface_blocks(dmap.d, dmap.w, dmap.origin, mw),
            fp.voxel_size_m, mw)
    return out


def esdf_update_cells(aabb, dirty, mb: int, first: bool) -> int:
    """Voxels an ESDF update must read and write: the blocks changed since
    the last update widened by the band (`mb` blocks) to those it writes,
    by the band again to those it reads, each clipped to the observed
    map's block AABB; the first update covers that whole AABB twice."""
    a_lo, a_hi = (np.asarray(x, np.int64) for x in aabb)
    d_lo, d_hi = (np.asarray(x, np.int64) for x in dirty)
    if first:
        c_lo, c_hi = r_lo, r_hi = a_lo, a_hi
    else:
        c_lo = np.minimum(np.maximum(d_lo - mb, a_lo), d_lo)
        c_hi = np.maximum(np.minimum(d_hi + mb, a_hi), d_hi)
        r_lo = np.minimum(np.maximum(c_lo - mb, a_lo), c_lo)
        r_hi = np.maximum(np.minimum(c_hi + mb, a_hi), c_hi)
    size = lambda lo, hi: int(np.prod(hi - lo + 1)) * 512
    return size(c_lo, c_hi) + size(r_lo, r_hi)
