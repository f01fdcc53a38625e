"""People walking through a node cell's lap, with their segmentation masks.

A traffic file's `people` entry names upright cylinders (radius, height)
that walk straight along given paths and back at a given speed, each at a
phase the seed draws, and `blobs` the segmentation network's false
positives: disks a Poisson number of times a frame, of radii drawn from a
range, at centres anywhere in the image. A configuration's `mask_camera`
names the camera the masks are seen from (intrinsics and T_CM_CD, the
depth camera's points in the mask camera's frame).

`overlay(lap, config, traffic, device)` puts the people into the lap, in
place and once: into each depth frame where a person is nearer than the
scene (z-depth with the traffic's depth noise), and into each color frame
there (|p| * 64 mod 256 of the person's surface point, as inputs.py
colors the scene). It attaches the masks, u8[K, H, W] in the mask
camera: 1 where a person is the nearest surface seen from there, and on
each frame's blobs. Everything is a function of the lap, the traffic file
and the seed (drawn from the lap's orbit, which the seed made), so the
kind and the reference, which both call it, see the same inputs. This module imports torch, numpy and the benchmark's inputs.py
only.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs


@dataclasses.dataclass
class People:
    """What `overlay` attached to a lap."""
    masks: np.ndarray           # u8[K, H, W], the mask camera's frames
    mask_camera: inputs.CameraModel
    T_CM_CD: np.ndarray         # f32[4, 4]
    in_view_share: float        # frames with a person in the mask
    blobs: int                  # false-positive disks over the lap


def mask_camera(config: Dict):
    """(CameraModel, T_CM_CD f32[4, 4]) of the configuration's mask
    camera."""
    c = config["mask_camera"]
    cam = inputs.CameraModel(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                             float(c["cy"]), int(c["width"]),
                             int(c["height"]))
    return cam, np.asarray(c["T_CM_CD"], np.float32)


def people_seed(lap) -> int:
    """A seed for the people and the blobs, drawn from the lap's orbit
    (which the run's seed drew)."""
    o = lap.orbit
    key = np.asarray([o.phase, o.radius_m, o.height_m], np.float64)
    return int.from_bytes(hashlib.sha256(key.tobytes()).digest()[:8],
                          "little") >> 1


def positions(spec: Dict, phases: np.ndarray, t_s: np.ndarray) -> np.ndarray:
    """Each person's (x, y) at times `t_s`: f64[len(t_s), P, 2]. A person
    walks from its path's start to its end and back at `speed_m_s`,
    starting at `phase` (a share of the round trip)."""
    paths = spec["paths"]
    a = np.asarray([p["from"] for p in paths], np.float64)
    b = np.asarray([p["to"] for p in paths], np.float64)
    length = np.linalg.norm(b - a, axis=1)
    trip = 2.0 * length / float(spec["speed_m_s"])
    t = np.asarray(t_s, np.float64)[:, None]
    u = np.mod(t / trip[None] + phases[None], 1.0) * 2.0
    s = np.where(u < 1.0, u, 2.0 - u)
    return a[None] + s[..., None] * (b - a)[None]


def cast_people(centers, radius: float, height: float, origins, dirs):
    """(t f32[N], hit bool[N]): the nearest entry of each ray into any
    upright cylinder (centres f32[P, 2] on the floor at z = 0), through its
    side with 0 <= z <= height (the sensors ride below the heads, so a
    ray never meets a top or bottom face first)."""
    t = torch.full(dirs.shape[:1], float("inf"), device=dirs.device)
    dxy = dirs[:, :2]
    a = (dxy * dxy).sum(-1)
    a_safe = torch.clamp_min(a, 1e-12)
    for c in centers:
        oc = origins[:, :2] - c
        b = (oc * dxy).sum(-1)
        disc = b * b - a * ((oc * oc).sum(-1) - radius * radius)
        t0 = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / a_safe
        z = origins[:, 2] + t0 * dirs[:, 2]
        hit = (disc >= 0.0) & (a > 1e-12) & (t0 > 1e-4) & (z >= 0.0) \
            & (z <= height)
        t = torch.where(hit, torch.minimum(t, t0), t)
    return t, torch.isfinite(t)


def _rays(cam: inputs.CameraModel, device):
    """Unit camera-frame directions f32[H * W, 3], row-major."""
    u = (torch.arange(cam.width, device=device, dtype=torch.float32)
         - cam.cx) / cam.fx
    v = (torch.arange(cam.height, device=device, dtype=torch.float32)
         - cam.cy) / cam.fy
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([uu, vv, torch.ones_like(uu)], -1).reshape(-1, 3)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def draw_blobs(spec: Dict, n_frames: int, cam: inputs.CameraModel,
               rng: np.random.Generator) -> List[List[tuple]]:
    """Each frame's false-positive disks [(cy, cx, r)], in pixels."""
    lo, hi = (float(x) for x in spec["radius_px"])
    out = []
    for _ in range(n_frames):
        k = int(rng.poisson(float(spec["per_frame"])))
        out.append([(float(rng.uniform(0, cam.height)),
                     float(rng.uniform(0, cam.width)),
                     float(rng.uniform(lo, hi))) for _ in range(k)])
    return out


def paint_disks(mask: np.ndarray, disks) -> None:
    H, W = mask.shape
    for cy, cx, r in disks:
        y0 = max(int(np.floor(cy - r)), 0)
        y1 = min(int(np.ceil(cy + r)) + 1, H)
        x0 = max(int(np.floor(cx - r)), 0)
        x1 = min(int(np.ceil(cx + r)) + 1, W)
        if y1 <= y0 or x1 <= x0:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        mask[y0:y1, x0:x1] |= ((yy - cy) ** 2 + (xx - cx) ** 2
                               <= r * r).astype(np.uint8)


@torch.no_grad()
def overlay(lap, config: Dict, traffic: Dict, device,
            rays: int = 1 << 20) -> People:
    """Put the traffic's people into the lap (once; later calls return
    what the first attached) and attach their masks."""
    done = getattr(lap, "people", None)
    if done is not None:
        return done
    dev = torch.device(device)
    spec, blob_spec = traffic["people"], traffic["blobs"]
    seed = people_seed(lap)
    rng = np.random.default_rng(seed)
    gen = inputs.generator(seed, dev)
    n_people = len(spec["paths"])
    phases = rng.random(n_people)
    cam = inputs.camera_model(config)
    mcam, T_CM_CD = mask_camera(config)
    K = lap.depths.shape[0]
    rate = float(config["rates_hz"]["camera"])
    times = np.arange(K) / rate
    xy = positions(spec, phases, times)
    radius, height = float(spec["radius_m"]), float(spec["height_m"])
    scene = inputs.Scene(traffic["scene"], dev)
    max_range = float(traffic["max_range_m"])
    noise = traffic["noise"]["depth"]
    d_C, d_M = _rays(cam, dev), _rays(mcam, dev)
    # The mask camera's pose: T_L_CM = T_L_CD T_CM_CD^-1.
    T_CD_CM = np.linalg.inv(T_CM_CD.astype(np.float64))
    masks = np.zeros((K, mcam.height, mcam.width), np.uint8)
    chunk = max(1, rays // (cam.width * cam.height))
    for s in range(0, K, chunk):
        k = min(chunk, K - s)
        T = torch.as_tensor(lap.poses[s:s + k], device=dev)
        TM = torch.as_tensor((lap.poses[s:s + k].astype(np.float64) @ T_CD_CM)
                             .astype(np.float32), device=dev)
        cen = torch.as_tensor(xy[s:s + k].astype(np.float32), device=dev)
        depth = torch.as_tensor(lap.depths[s:s + k], device=dev)
        color = torch.as_tensor(lap.colors[s:s + k], device=dev)
        for j in range(k):
            # The depth camera: the person where nearer than the scene.
            dirs = d_C @ T[j, :3, :3].T
            orig = T[j, :3, 3].expand_as(dirs)
            t, hit = cast_people(cen[j], radius, height, orig, dirs)
            z = torch.where(hit, t * d_C[:, 2], torch.zeros_like(t))
            d_old = depth[j].reshape(-1)
            front = hit & ((d_old <= 0.0) | (z < d_old))
            sigma = float(noise["a_m"]) + float(noise["c_per_m"]) * z * z
            eps = torch.randn(z.shape, generator=gen, device=dev)
            zn = torch.clamp_min(z + sigma * eps, 1e-3)
            depth[j] = torch.where(front, zn, d_old).reshape(depth[j].shape)
            p = orig + dirs * torch.where(hit, t, torch.zeros_like(t))[:, None]
            rgb = torch.fmod(torch.abs(p) * 64.0, 256.0).to(torch.uint8)
            color[j] = torch.where(front[:, None], rgb,
                                   color[j].reshape(-1, 3)).reshape(
                                       color[j].shape)
            # The mask camera: the person where it is the nearest surface.
            dirs_m = d_M @ TM[j, :3, :3].T
            orig_m = TM[j, :3, 3].expand_as(dirs_m)
            tp, hp = cast_people(cen[j], radius, height, orig_m, dirs_m)
            ts, hs = inputs.ray_cast(scene, orig_m, dirs_m, max_range)
            m = hp & (~hs | (tp < ts))
            masks[s + j] = m.reshape(mcam.height, mcam.width).to(
                torch.uint8).cpu().numpy()
        lap.depths[s:s + k] = depth.cpu().numpy()
        lap.colors[s:s + k] = color.cpu().numpy()
    seen = int((masks.reshape(K, -1).max(1) > 0).sum())
    blobs = draw_blobs(blob_spec, K, mcam, rng)
    for k in range(K):
        paint_disks(masks[k], blobs[k])
    lap.people = People(masks=masks, mask_camera=mcam, T_CM_CD=T_CM_CD,
                        in_view_share=seen / max(K, 1),
                        blobs=sum(len(b) for b in blobs))
    return lap.people
