"""Plain reference of the online node's map: the node's schedule replayed
tick by tick on a dense map.

It works out from the inputs and their stamps what the node does with
them (nvblox_node.cpp's tick): per tick, the ESDF gate, then each queued
depth frame through the depth rate gate, each color frame through the
color gate, each lidar scan through the lidar gate; frames take the
nearest queued pose within the transformer's tolerance (interpolated
between the poses around them beyond it); a scan is motion-compensated
from its start pose to the pose at its last point's time. The gates admit
a stream when at least one period less 1e-9 s has passed since the last
admitted item of that stream.

At the last tick it gives the TSDF and color, the published 2-D slice of
the height band over the observed blocks, and the meshes of every block
with a cube to mesh. This module
imports torch, numpy and the other reference modules only.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from . import esdf as esdf_ref
from . import mesh as mesh_ref
from .fusion import (DenseMap, FusionParams, Pinhole, Spherical,
                     interpolate_poses)


class Gate:
    def __init__(self):
        self.last: Dict[str, float] = {}

    def admit(self, name: str, rate_hz: float, now: float) -> bool:
        if rate_hz <= 0:
            return False
        last = self.last.get(name)
        if last is not None and (now - last) < 1.0 / rate_hz - 1e-9:
            return False
        self.last[name] = now
        return True


class PoseQueue:
    """Timestamped poses of one frame; `lookup` takes the nearest within
    `tolerance_s`, else interpolates between the poses around it."""

    def __init__(self, tolerance_s: float):
        self.tol = tolerance_s
        self.ts: List[float] = []
        self.Ts: List[np.ndarray] = []

    def add(self, t: float, T: np.ndarray) -> None:
        i = bisect.bisect_left(self.ts, t)
        self.ts.insert(i, t)
        self.Ts.insert(i, np.asarray(T, np.float32))

    def lookup(self, t: float) -> Optional[np.ndarray]:
        if not self.ts:
            return None
        i = bisect.bisect_left(self.ts, t)
        cands = ([i] if i < len(self.ts) else []) + ([i - 1] if i else [])
        best = min(cands, key=lambda j: abs(self.ts[j] - t))
        if abs(self.ts[best] - t) <= self.tol:
            return self.Ts[best]
        if 0 < i < len(self.ts) and self.ts[i - 1] <= t <= self.ts[i]:
            a = (t - self.ts[i - 1]) / max(self.ts[i] - self.ts[i - 1], 1e-9)
            return interpolate_poses(self.Ts[i - 1], self.Ts[i],
                                     np.asarray([a], np.float32))[0]
        return None


def fusion_params(config: Dict) -> FusionParams:
    mp = config["params"]["mapper"]
    pj = mp["static_mapper"]["projective"]
    return FusionParams(
        voxel_size_m=float(mp["voxel_size_m"]),
        max_integration_distance_m=float(pj["max_integration_distance_m"]),
        truncation_distance_vox=float(pj["truncation_distance_vox"]),
        max_weight=float(pj["max_weight"]),
        weighting_mode=str(pj["weighting_mode"]))


def pinhole(config: Dict) -> Pinhole:
    c = config["camera"]
    return Pinhole(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                   float(c["cy"]), int(c["width"]), int(c["height"]))


def spherical(config: Dict) -> Spherical:
    c = config["lidar"]
    return Spherical(int(c["width"]), int(c["height"]),
                     math.radians(float(c["vertical_fov_deg"])),
                     float(c["min_range_m"]), float(c["max_range_m"]))


def map_box(config: Dict, regions) -> tuple:
    """(origin voxel, dims) of the dense map: the union of the frames'
    and scans' regions (global voxel [lo, hi)), one block wider, inside
    the world."""
    w = config["world"]
    wlo = np.asarray(w["origin_block"], np.int64) * 8
    whi = wlo + np.asarray(w["dims"], np.int64) * 8
    lo = np.min([r[0] for r in regions], 0) - 8
    hi = np.max([r[1] for r in regions], 0) + 8
    lo = np.maximum(np.floor_divide(lo, 8) * 8, wlo)
    hi = np.minimum(-np.floor_divide(-hi, 8) * 8, whi)
    return lo, tuple(int(x) for x in hi - lo)


def lap_regions(config: Dict, lap, device) -> list:
    """Global voxel [lo, hi) of every region the lap's frames and scans
    can update (a probe map spanning the world gives the clipping)."""
    probe = DenseMap.world_probe(config["world"], fusion_params(config),
                                 device)
    cam = pinhole(config)
    out = []
    for k in range(lap.depths.shape[0]):
        r = probe._depth_region(torch.as_tensor(lap.depths[k], device=device),
                                lap.poses[k], cam)
        if r is not None:
            out.append((r[0] + probe.origin, r[1] + probe.origin))
    if lap.scans is not None:
        lid = spherical(config)
        rate = config["rates_hz"]["lidar"]
        for m in range(lap.scans.shape[0]):
            pts = torch.as_tensor(lap.scans[m], device=device)
            for t in (m / rate, (m + 1) / rate):
                r = probe._scan_region(pts, lap.orbit.lidar_pose(t), lid)
                if r is not None:
                    out.append((r[0] + probe.origin, r[1] + probe.origin))
    return out


def replay(config: Dict, sched, lap, n_ticks: int, *, device,
           dtype=torch.float32, window_from: int = 0,
           mesh: bool = False) -> Dict:
    """Ticks 0 .. n_ticks - 1 of the node cell. Returns the final `map`
    (DenseMap), the `slice` at the last tick ({origin_x_m, origin_y_m,
    width, height, data f32[H, W]} over the observed blocks' xy extent),
    with `mesh` the meshes of every block with a cube to mesh, and the
    `work` of the ticks from `window_from`: depth frames and scans
    integrated with the blocks each updated, and the cells of each 2-D
    ESDF solve."""
    node = config["params"]["node"]
    mp = config["params"]["mapper"]["static_mapper"]
    fp = fusion_params(config)
    cam = pinhole(config)
    lid = spherical(config) if lap.scans is not None else None
    origin, dims = map_box(config, lap_regions(config, lap, device))
    dmap = DenseMap(origin, dims, fp, dtype=dtype, device=device)
    tol = float(config["transformer_timestamp_tolerance_s"])
    poses = {"cam": PoseQueue(tol), "lidar": PoseQueue(tol)}
    gate = Gate()
    work = {"depth_blocks": [], "scan_blocks": [], "esdf2d_cells": [],
            "frames_window": 0}
    depth_q, color_q, scan_q = [], [], []
    n_frames = lap.depths.shape[0]
    rel_end = float(np.max(lap.scan_rel)) if lid is not None else 0.0
    band = esdf_ref.band_of(float(mp["esdf"]["max_esdf_distance_m"]),
                            fp.voxel_size_m)
    for i in range(n_ticks):
        now = sched.now(i)
        if sched.pose_due(i):
            poses["cam"].add(now, lap.orbit.camera_pose(now))
            poses["lidar"].add(now, lap.orbit.lidar_pose(now))
        for k in sched.frames_at(i):
            depth_q.append(k)
            color_q.append(k)
        scan_q.extend(sched.scans_at(i))
        in_window = i >= window_from
        esdf_due = gate.admit("esdf", float(node["update_esdf_rate_hz"]), now)
        # Depth, then color, then lidar, each through its gate.
        for k in [k for k in depth_q
                  if poses["cam"].lookup(sched.frame_stamp(k)) is not None]:
            depth_q.remove(k)
            if not gate.admit("depth/cam",
                              float(node["integrate_depth_rate_hz"]), now):
                continue
            T = poses["cam"].lookup(sched.frame_stamp(k))
            nb = dmap.integrate_depth(
                torch.as_tensor(lap.depths[k % n_frames], device=device), T,
                cam)
            if in_window:
                work["depth_blocks"].append(nb)
                work["frames_window"] += 1
        for k in [k for k in color_q
                  if poses["cam"].lookup(sched.frame_stamp(k)) is not None]:
            color_q.remove(k)
            if not gate.admit("color/cam",
                              float(node["integrate_color_rate_hz"]), now):
                continue
            T = poses["cam"].lookup(sched.frame_stamp(k))
            dmap.integrate_color(
                torch.as_tensor(lap.colors[k % n_frames], device=device), T,
                cam)
        for m in [m for m in scan_q
                  if poses["lidar"].lookup(sched.scan_stamp(m)) is not None]:
            scan_q.remove(m)
            if not gate.admit("lidar/lidar",
                              float(node["integrate_lidar_rate_hz"]), now):
                continue
            stamp = sched.scan_stamp(m)
            T0 = poses["lidar"].lookup(stamp)
            T1 = poses["lidar"].lookup(stamp + rel_end)
            nb = dmap.integrate_scan(lap.scans[m % lap.scans.shape[0]],
                                     lap.scan_rel, T0, T1, lid)
            if in_window:
                work["scan_blocks"].append(nb)
        if esdf_due and in_window:
            aabb = dmap.block_aabb_observed(float(mp["esdf"]["min_weight"]))
            if aabb is not None:
                lo, hi = aabb
                work["esdf2d_cells"].append(
                    int(np.prod(hi[:2] - lo[:2] + 1)) * 64)
    out = {"map": dmap, "work": work, "slice": None}
    aabb = dmap.block_aabb_observed(float(mp["esdf"]["min_weight"]))
    if aabb is not None:
        lo, hi = aabb
        vs = fp.voxel_size_m
        frame = {"origin_x_m": float(lo[0] * 8 * vs),
                 "origin_y_m": float(lo[1] * 8 * vs),
                 "width": int(hi[0] - lo[0] + 1) * 8,
                 "height": int(hi[1] - lo[1] + 1) * 8}
        out["slice"] = dict(frame, data=node_slice(config, dmap, frame, band,
                                                   dtype))
    if mesh:
        mw = float(mp["mesh"]["min_weight"])
        out["mesh"] = mesh_ref.mesh_blocks(
            dmap.d, dmap.w, dmap.color[:3], dmap.origin,
            mesh_ref.surface_blocks(dmap.d, dmap.w, dmap.origin, mw),
            fp.voxel_size_m, mw)
    return out


def node_slice(config: Dict, dmap: DenseMap, frame: Dict, band: int,
               dtype=torch.float32) -> np.ndarray:
    """The published 2-D slice f32[H = y, W = x] over `frame` from the
    map: sites of the node's height band, the planar banded EDT over the
    frame, distances clamped to the ESDF's maximum, the optimistic
    unknown value where no band voxel is observed."""
    node = config["params"]["node"]
    mp = config["params"]["mapper"]["static_mapper"]
    vs = dmap.params.voxel_size_m
    e = mp["esdf"]
    site, inside, obs = esdf_ref.sites(
        dmap.d, dmap.w, vs, float(e["max_site_distance_vox"]),
        float(e["min_weight"]))
    zmask = esdf_ref.z_band(int(dmap.origin[2]), dmap.dims[2], vs,
                            float(node["esdf_2d_min_height"]),
                            float(node["esdf_2d_max_height"]), dmap.device)
    gx0 = int(round(frame["origin_x_m"] / vs)) - int(dmap.origin[0])
    gy0 = int(round(frame["origin_y_m"] / vs)) - int(dmap.origin[1])
    W, H = int(frame["width"]), int(frame["height"])

    def crop(a):
        """The frame's columns of a 3-D grid (False outside the map)."""
        out = torch.zeros((W, H, a.shape[2]), dtype=a.dtype, device=a.device)
        x0, y0 = max(gx0, 0), max(gy0, 0)
        x1, y1 = min(gx0 + W, a.shape[0]), min(gy0 + H, a.shape[1])
        if x1 > x0 and y1 > y0:
            out[x0 - gx0:x1 - gx0, y0 - gy0:y1 - gy0] = a[x0:x1, y0:y1]
        return out

    img = esdf_ref.slice_2d(
        crop(site), crop(inside), crop(obs), zmask, band, vs,
        float(e["max_esdf_distance_m"]),
        float(node["distance_map_unknown_value_optimistic"]), dtype)
    return img.t().float().cpu().numpy()
