"""Plain reference of the node in nvblox's people-segmentation mode
(`human_with_static_tsdf`): the node's schedule replayed tick by tick on
two dense maps, the static TSDF and the human occupancy layer.

Per depth frame, as the mode's MultiMapper does it:

  * the mask, seen from the mask camera, is reprojected into the depth
    frame: each pixel with depth back-projected, moved by T_CM_CD,
    projected into the mask camera and the nearest mask pixel taken
    (unmasked where it has no depth or falls outside the mask image);
  * the mask loses its 8-connected components under
    `connected_mask_component_size_threshold` pixels: each masked pixel
    takes the smallest index in its 3 x 3 neighbourhood, round after round
    until no label changes, and the labels' pixels are counted;
  * the depth is split: the unmasked pixels into the static TSDF
    (fusion.py), the masked ones into the human layer, log-odds occupancy
    (a voxel in view and range, against the nearest depth sample: free in
    front of it by more than the occupied half width, occupied within the
    half width, untouched behind; log-odds clamped; the observed flag
    raised where it updates), over the blocks the view touches with the
    occupancy's integration distance and the half width as truncation.

The decay gate (`decay_dynamic_occupancy_rate_hz`) moves every log-odds
toward 0 by the occupied or free step without overshooting, then clears
every block whose log-odds all lie within 1e-3 of 0 (its voxels
unobserved). The static TSDF does not decay in this mode; color fuses
into it unmasked, as the node integrates color.

At the last ESDF tick (before that tick's decay): the published static
slice over the static map's observed blocks, and the combined slice over
the observed blocks of both maps, the minimum of the two maps' 2-D
fields where either knows a cell (the human field's sites are its
observed voxels above the occupied log-odds threshold, inside where
sites). The static mesh as reference/node.py makes it. This module
imports torch, numpy and the other reference modules only.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import esdf as esdf_ref
from . import mesh as mesh_ref
from . import node as node_ref
from .fusion import (DenseMap, FusionParams, Pinhole, apply_pose,
                     inverse_pose, recip32, sample_nearest)
from .view import touched_by_camera


def _f32(x: float) -> float:
    return float(np.float32(x))


def mask_pinhole(config: Dict) -> Pinhole:
    c = config["mask_camera"]
    return Pinhole(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                   float(c["cy"]), int(c["width"]), int(c["height"]))


def reproject(depths, masks, T_CM_CD: np.ndarray, cam: Pinhole,
              mcam: Pinhole, dtype=torch.float32):
    """Masks u8[B, Hm, Wm] of the mask camera as seen by each depth pixel
    of depths f32[B, H, W]: u8[B, H, W]."""
    B, H, W = depths.shape
    dev = depths.device
    d = depths.to(dtype)
    u = torch.arange(W, device=dev, dtype=dtype)[None, None, :]
    v = torch.arange(H, device=dev, dtype=dtype)[None, :, None]
    x = (u - cam.cx) * recip32(cam.fx) * d
    y = (v - cam.cy) * recip32(cam.fy) * d
    T = torch.as_tensor(np.asarray(T_CM_CD, np.float32), device=dev,
                        dtype=dtype)
    pu, pv, _, ok = mcam.project(apply_pose(T, torch.stack([x, y, d], -1)))
    ui = torch.round(pu).clamp(-1.0, float(mcam.width)).long().clamp(
        0, mcam.width - 1)
    vi = torch.round(pv).clamp(-1.0, float(mcam.height)).long().clamp(
        0, mcam.height - 1)
    flat = masks.reshape(B, -1).to(dtype)
    m = flat.gather(1, (vi * mcam.width + ui).reshape(B, -1)).reshape(
        B, H, W)
    return torch.where(ok & (d > 0.0), m, torch.zeros_like(m)).to(
        torch.uint8)


def filter_components(masks, threshold: int, check_every: int = 16):
    """The 8-connected components of masks u8[B, H, W] (> 0) with at
    least `threshold` pixels: u8[B, H, W] (0 / 1)."""
    B, H, W = masks.shape
    n = H * W
    fg = masks > 0
    dev = masks.device
    big = torch.full((), n, dtype=torch.int64, device=dev)
    lab = torch.where(fg, torch.arange(n, device=dev).reshape(1, H, W), big)
    while True:
        before = lab
        for _ in range(check_every):
            p = F.pad(lab, (1, 1, 1, 1), value=n)
            m = lab
            for dy in range(3):
                for dx in range(3):
                    m = torch.minimum(m, p[:, dy:dy + H, dx:dx + W])
            lab = torch.where(fg, m, big)
        if torch.equal(lab, before):
            break
    frame = torch.arange(B, device=dev).reshape(B, 1, 1) * (n + 1)
    g = (lab + frame).reshape(-1)
    sizes = torch.bincount(g, minlength=B * (n + 1))
    return (fg & (sizes[g].reshape(B, H, W) >= int(threshold))).to(
        torch.uint8)


def filtered_masks(config: Dict, lap, dtype=torch.float32, device="cpu",
                   batch: int = 32):
    """The filtered mask of each lap frame, u8[K, H, W] on `device`."""
    people = lap.people
    cam, mcam = node_ref.pinhole(config), mask_pinhole(config)
    sp = config["params"]["mapper"]["static_mapper"]
    K = lap.depths.shape[0]
    out = torch.empty((K, cam.height, cam.width), dtype=torch.uint8,
                      device=device)
    for s in range(0, K, batch):
        d = torch.as_tensor(lap.depths[s:s + batch], device=device)
        m = torch.as_tensor(people.masks[s:s + batch], device=device)
        r = reproject(d, m, people.T_CM_CD, cam, mcam, dtype)
        if sp.get("remove_small_connected_components", True):
            r = filter_components(
                r, int(sp["connected_mask_component_size_threshold"]))
        out[s:s + batch] = r
    return out


class HumanMap(DenseMap):
    """The human layer: log-odds `lo` and the observed flag `obs` of the
    voxels `origin + [0, dims)`, in `dtype`."""

    def __init__(self, origin_vox, dims, config: Dict, *,
                 dtype=torch.float32, device="cpu"):
        mp = config["params"]["mapper"]
        dyn = mp["dynamic_mapper"]
        occ = dyn["occupancy"]
        vs = float(mp["voxel_size_m"])
        self.hw = _f32(occ["occupied_region_half_width_m"])
        params = FusionParams(
            voxel_size_m=vs,
            max_integration_distance_m=float(
                occ["max_integration_distance_m"]),
            truncation_distance_vox=float(
                occ["occupied_region_half_width_m"]) / vs)
        super().__init__(origin_vox, (8, 8, 8), params, dtype=dtype,
                         device=device, color=False)
        self.dims = tuple(int(x) for x in dims)
        self.d = self.w = None
        self.lo = torch.zeros(self.dims, dtype=dtype, device=self.device)
        self.obs = torch.zeros(self.dims, dtype=torch.bool, device=self.device)
        lp = lambda p: math.log(p / (1.0 - p))
        self.l_free = _f32(lp(float(occ["free_region_occupancy_probability"])))
        self.l_occ = _f32(lp(float(
            occ["occupied_region_occupancy_probability"])))
        self.lo_min, self.lo_max = (_f32(occ["min_log_odds"]),
                                    _f32(occ["max_log_odds"]))
        dec = dyn["occupancy_decay"]
        p_occ = float(dec["occupied_region_decay_probability"])
        p_free = float(dec["free_region_decay_probability"])
        self.occ_step = _f32(math.log((1.0 - p_occ) / p_occ))
        self.free_step = _f32(lp(p_free))
        self.threshold = _f32(dyn["esdf"]["occupied_log_odds_threshold"])
        self.max_esdf_m = float(dyn["esdf"]["max_esdf_distance_m"])

    def integrate_depth(self, depth, T_L_C: np.ndarray, cam: Pinhole) -> int:
        """One foreground z-depth image (0 = not this layer's); returns the
        blocks the view touches."""
        region = self._depth_region(depth, T_L_C, cam)
        if region is None:
            return 0
        lo, hi = region
        p = self.params
        T = torch.as_tensor(inverse_pose(T_L_C), device=self.device,
                            dtype=self.dtype)
        u, v, z, ok = cam.project(apply_pose(T, self._centers(lo, hi)))
        meas = sample_nearest(depth.to(self.dtype), u, v)
        touched = self._touched(lo, hi, touched_by_camera, depth, T_L_C, cam)
        ok = (ok & touched & (meas > 0.0) & torch.isfinite(meas)
              & (z <= _f32(p.max_integration_distance_m)))
        is_free = z < meas - self.hw
        is_occ = torch.abs(z - meas) <= self.hw
        upd = ok & (is_free | is_occ)
        delta = torch.where(is_occ, torch.full_like(z, self.l_occ),
                            torch.full_like(z, self.l_free))
        lo_v, obs_v = self._view(self.lo, lo, hi), self._view(self.obs, lo, hi)
        lo_v.copy_(torch.where(upd, torch.clamp(lo_v + delta, self.lo_min,
                                                self.lo_max), lo_v))
        obs_v |= upd
        return self._blocks_touched(touched, lo)

    def decay(self) -> None:
        lo = self.lo
        down = torch.clamp_min(lo - self.occ_step, 0.0)
        up = torch.clamp_max(lo + self.free_step, 0.0)
        out = torch.where(lo > 0.0, down, torch.where(lo < 0.0, up, lo))
        X, Y, Z = self.dims
        dead = (out.abs().view(X // 8, 8, Y // 8, 8, Z // 8, 8).amax(
            (1, 3, 5)) < _f32(1e-3))
        dead = self._voxels_of(dead)
        self.lo.copy_(torch.where(dead, torch.zeros_like(out), out))
        self.obs &= ~dead

    def sites(self):
        occupied = self.obs & (self.lo > self.threshold)
        return occupied, occupied, self.obs

    def block_aabb_observed(self, min_weight: float = 0.0):
        if not bool(self.obs.any()):
            return None
        X, Y, Z = self.dims
        idx = torch.nonzero(self.obs.view(X // 8, 8, Y // 8, 8, Z // 8, 8)
                            .any(5).any(3).any(1))
        return (idx.amin(0).cpu().numpy() + self.origin // 8,
                idx.amax(0).cpu().numpy() + self.origin // 8)


def frame_of(aabbs, voxel_size_m: float):
    """The slice frame over the union of block AABBs (None ones skipped)."""
    aabbs = [a for a in aabbs if a is not None]
    if not aabbs:
        return None
    lo = np.min([a[0] for a in aabbs], 0)
    hi = np.max([a[1] for a in aabbs], 0)
    return {"origin_x_m": float(lo[0] * 8 * voxel_size_m),
            "origin_y_m": float(lo[1] * 8 * voxel_size_m),
            "width": int(hi[0] - lo[0] + 1) * 8,
            "height": int(hi[1] - lo[1] + 1) * 8}


def layer_slice(config: Dict, grids, origin, frame: Dict, band: int,
                max_distance_m: float, voxel_size_m: float,
                dtype=torch.float32) -> torch.Tensor:
    """A layer's 2-D slice f32[H = y, W = x] over `frame` from its 3-D
    (site, inside, observed) grids at global voxel `origin`."""
    node = config["params"]["node"]
    site = grids[0]
    zmask = esdf_ref.z_band(int(origin[2]), site.shape[2], voxel_size_m,
                            float(node["esdf_2d_min_height"]),
                            float(node["esdf_2d_max_height"]), site.device)
    gx0 = int(round(frame["origin_x_m"] / voxel_size_m)) - int(origin[0])
    gy0 = int(round(frame["origin_y_m"] / voxel_size_m)) - int(origin[1])
    W, H = int(frame["width"]), int(frame["height"])

    def crop(a):
        out = torch.zeros((W, H, a.shape[2]), dtype=a.dtype, device=a.device)
        x0, y0 = max(gx0, 0), max(gy0, 0)
        x1, y1 = min(gx0 + W, a.shape[0]), min(gy0 + H, a.shape[1])
        if x1 > x0 and y1 > y0:
            out[x0 - gx0:x1 - gx0, y0 - gy0:y1 - gy0] = a[x0:x1, y0:y1]
        return out

    img = esdf_ref.slice_2d(
        *(crop(g) for g in grids), zmask, band, voxel_size_m, max_distance_m,
        float(node["distance_map_unknown_value_optimistic"]), dtype)
    return img.t().float()


def combine(images, unknown: float) -> torch.Tensor:
    """The minimum of aligned slices where any knows a cell."""
    inf = torch.full((), float("inf"))
    out = None
    for img in images:
        if out is None:
            out = img
            continue
        known = (out != unknown) | (img != unknown)
        m = torch.minimum(torch.where(out == unknown, inf, out),
                          torch.where(img == unknown, inf, img))
        out = torch.where(known, m, torch.full((), float(unknown)))
    return out


def slices(config: Dict, dmap: DenseMap, hmap: HumanMap, dtype) -> Dict:
    """The static slice over the static map's observed blocks and the
    combined slice over both maps' observed blocks."""
    node = config["params"]["node"]
    mp = config["params"]["mapper"]["static_mapper"]
    vs = dmap.params.voxel_size_m
    unknown = float(node["distance_map_unknown_value_optimistic"])
    e = mp["esdf"]
    band = esdf_ref.band_of(float(e["max_esdf_distance_m"]), vs)
    s_aabb = dmap.block_aabb_observed(float(e["min_weight"]))
    out = {"slice": None, "combined": None}
    f_s = frame_of([s_aabb], vs)
    if f_s is not None:
        out["slice"] = dict(f_s, data=node_ref.node_slice(config, dmap, f_s,
                                                          band, dtype))
    f_c = frame_of([s_aabb, hmap.block_aabb_observed()], vs)
    if f_c is None:
        return out
    st = esdf_ref.sites(dmap.d, dmap.w, vs, float(e["max_site_distance_vox"]),
                        float(e["min_weight"]))
    a = layer_slice(config, st, dmap.origin, f_c, band,
                    float(e["max_esdf_distance_m"]), vs, dtype).cpu()
    b = layer_slice(config, hmap.sites(), hmap.origin, f_c,
                    esdf_ref.band_of(hmap.max_esdf_m, vs), hmap.max_esdf_m,
                    vs, dtype).cpu()
    out["combined"] = dict(f_c, data=combine([a, b], unknown).numpy())
    return out


def replay(config: Dict, sched, lap, n_ticks: int, *, device,
           dtype=torch.float32, window_from: int = 0,
           mesh: bool = False) -> Dict:
    """Ticks 0 .. n_ticks - 1 of the people-segmentation node. `lap` holds
    the people (people.overlay). Returns the static `map` (DenseMap), the
    `human` map (HumanMap), the `slice` and the `combined` slice of the
    last ESDF tick, with `mesh` the static map's block meshes, the
    filtered masks of the lap's frames (`masks` u8[K, H, W]) and the lap
    frame of each depth frame the window integrated
    (`window_frames`), and the `work` of the window's ticks: static
    blocks a depth frame updated, blocks the human view touched, 2-D ESDF
    cells of both layers, and the bytes of the mask filter's work (the
    mask read once, the labels written and read once as 32-bit integers,
    the filtered mask written once)."""
    node = config["params"]["node"]
    mp = config["params"]["mapper"]["static_mapper"]
    fp = node_ref.fusion_params(config)
    cam = node_ref.pinhole(config)
    origin, dims = node_ref.map_box(config, node_ref.lap_regions(config, lap,
                                                                 device))
    dmap = DenseMap(origin, dims, fp, dtype=dtype, device=device)
    hmap = HumanMap(origin, dims, config, dtype=dtype, device=device)
    masks = filtered_masks(config, lap, dtype=dtype, device=device)
    tol = float(config["transformer_timestamp_tolerance_s"])
    poses = node_ref.PoseQueue(tol)
    gate = node_ref.Gate()
    work = {"depth_blocks": [], "human_blocks": [], "esdf2d_cells": [],
            "frames_window": 0, "mask_frames": 0, "mask_label_bytes": 0}
    window_frames = []
    depth_q, color_q = [], []
    n_frames = lap.depths.shape[0]
    px = cam.width * cam.height
    esdf_ticks = int(round(1000.0 / float(node["update_esdf_rate_hz"])
                           / sched.tick_ms))
    out = {"slice": None, "combined": None}
    for i in range(n_ticks):
        now = sched.now(i)
        if sched.pose_due(i):
            poses.add(now, lap.orbit.camera_pose(now))
        for k in sched.frames_at(i):
            depth_q.append(k)
            color_q.append(k)
        in_window = i >= window_from
        esdf_due = gate.admit("esdf", float(node["update_esdf_rate_hz"]), now)
        for k in [k for k in depth_q
                  if poses.lookup(sched.frame_stamp(k)) is not None]:
            depth_q.remove(k)
            if not gate.admit("depth/cam",
                              float(node["integrate_depth_rate_hz"]), now):
                continue
            T = poses.lookup(sched.frame_stamp(k))
            j = k % n_frames
            depth = torch.as_tensor(lap.depths[j], device=device)
            fg = masks[j] > 0
            zero = torch.zeros_like(depth)
            nb = dmap.integrate_depth(torch.where(fg, zero, depth), T, cam)
            hb = hmap.integrate_depth(torch.where(fg, depth, zero), T, cam)
            if in_window:
                work["depth_blocks"].append(nb)
                work["human_blocks"].append(hb)
                work["frames_window"] += 1
                work["mask_frames"] += 1
                work["mask_label_bytes"] += px * (1 + 4 + 4 + 1)
                window_frames.append(j)
        for k in [k for k in color_q
                  if poses.lookup(sched.frame_stamp(k)) is not None]:
            color_q.remove(k)
            if not gate.admit("color/cam",
                              float(node["integrate_color_rate_hz"]), now):
                continue
            T = poses.lookup(sched.frame_stamp(k))
            dmap.integrate_color(
                torch.as_tensor(lap.colors[k % n_frames], device=device), T,
                cam)
        if esdf_due and in_window:
            for aabb in (dmap.block_aabb_observed(
                    float(mp["esdf"]["min_weight"])),
                    hmap.block_aabb_observed()):
                if aabb is not None:
                    lo, hi = aabb
                    work["esdf2d_cells"].append(
                        int(np.prod(hi[:2] - lo[:2] + 1)) * 64)
        if esdf_due and i >= n_ticks - esdf_ticks:
            out = slices(config, dmap, hmap, dtype)
        gate.admit("decay_tsdf", float(node["decay_tsdf_rate_hz"]), now)
        if gate.admit("decay_dynamic",
                      float(node["decay_dynamic_occupancy_rate_hz"]), now):
            hmap.decay()
    out.update({"map": dmap, "human": hmap, "work": work, "masks": masks,
                "window_frames": window_frames})
    if mesh:
        mw = float(mp["mesh"]["min_weight"])
        out["mesh"] = mesh_ref.mesh_blocks(
            dmap.d, dmap.w, dmap.color[:3], dmap.origin,
            mesh_ref.surface_blocks(dmap.d, dmap.w, dmap.origin, mw),
            fp.voxel_size_m, mw)
    return out
