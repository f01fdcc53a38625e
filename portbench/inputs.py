"""The benchmark's inputs, made from the seed on the device.

A traffic file names a scene (analytic SDF primitives), a camera orbit and
the sensor noise; a configuration file names the sensors (camera
intrinsics, lidar model, rates). From those and `--seed` this module makes
one lap of sensor data with its own ray caster, in plain torch:

  * the camera pose at any time: an orbit about the room's centre looking
    at `target`, started at a phase the seed draws, with a radius and a
    height the seed jitters by a few centimetres;
  * one lap of depth frames (z-depth, f32, 0 = no return) and color frames
    (u8, position-derived RGB), with depth noise that grows with range;
  * one lap of lidar scans (node cells): each column traced from the
    sensor's position at its own time (the lidar rides the orbit, level,
    heading +x), points in the sensor frame, per-point times from the scan
    start.

The window repeats the lap with time moving on. The same seed gives the
same inputs; every seed gives the same amount of work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch


# ---------------------------------------------------------------- the scene
class Scene:
    """Union of primitives from a traffic file's `scene` list: each entry
    {"room_box" | "box": {"center", "half_extents"}} or {"sphere":
    {"center", "radius"}}; a room box is hollow (free inside, the sensors
    in it)."""

    def __init__(self, primitives: List[Dict], device):
        self.prims = []
        for entry in primitives:
            (kind, args), = entry.items()
            c = torch.tensor(args["center"], dtype=torch.float32,
                             device=device)
            if kind == "sphere":
                self.prims.append((kind, c, float(args["radius"])))
            elif kind in ("box", "room_box"):
                h = torch.tensor(args["half_extents"], dtype=torch.float32,
                                 device=device)
                self.prims.append((kind, c, h))
            else:
                raise ValueError(f"unknown scene primitive {kind!r}")


def ray_cast(scene: Scene, origins, dirs, max_range: float):
    """(ray length f32[N], hit bool[N]) along unit `dirs` from `origins`:
    the nearest surface of any primitive, found in closed form (a
    sphere's nearer root, a box's entry slab, a room box's exit slab)."""
    eps = 1e-4
    far = torch.full(dirs.shape[:1], float("inf"), device=dirs.device)
    t = far
    safe = torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12),
                       dirs)
    inv = 1.0 / safe
    for kind, c, a in scene.prims:
        if kind == "sphere":
            oc = origins - c
            b = (oc * dirs).sum(-1)
            disc = b * b - ((oc * oc).sum(-1) - a * a)
            t0 = -b - torch.sqrt(torch.clamp_min(disc, 0.0))
            hit = (disc >= 0.0) & (t0 > eps)
        else:
            t1, t2 = (c - a - origins) * inv, (c + a - origins) * inv
            near = torch.amax(torch.minimum(t1, t2), -1)
            exit_ = torch.amin(torch.maximum(t1, t2), -1)
            if kind == "box":
                t0, hit = near, (exit_ >= near) & (near > eps)
            else:
                t0, hit = exit_, exit_ > eps
        t = torch.where(hit, torch.minimum(t, t0), t)
    return t, t < max_range


# ------------------------------------------------------------------ sensors
@dataclasses.dataclass(frozen=True)
class CameraModel:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


@dataclasses.dataclass(frozen=True)
class LidarModel:
    width: int
    height: int
    vertical_fov_rad: float
    min_range_m: float
    max_range_m: float

    @property
    def rads_per_row(self) -> float:
        return self.vertical_fov_rad / max(self.height - 1, 1)

    def rays(self) -> np.ndarray:
        """Unit beam directions f32[rows * cols, 3], row-major: column
        centres in azimuth, each row a quarter row below its boundary so
        that no return lands on a range-image row boundary."""
        A, E = self.width, self.height
        az = (np.arange(A) + 0.5) / A * (2 * np.pi) - np.pi
        el = self.vertical_fov_rad / 2 - (np.arange(E) + 0.25) \
            * self.rads_per_row
        el, az = np.meshgrid(el, az, indexing="ij")
        return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                         np.sin(el)], -1).reshape(-1, 3).astype(np.float32)


def camera_model(cfg: Dict) -> CameraModel:
    c = cfg["camera"]
    return CameraModel(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                       float(c["cy"]), int(c["width"]), int(c["height"]))


def lidar_model(cfg: Dict) -> Optional[LidarModel]:
    c = cfg.get("lidar")
    if c is None:
        return None
    return LidarModel(int(c["width"]), int(c["height"]),
                      math.radians(float(c["vertical_fov_deg"])),
                      float(c["min_range_m"]), float(c["max_range_m"]))


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """T_L_C f32[4, 4] at `eye` looking at `target` (x right, y down, z
    forward; layer z up)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, :3] = np.stack([right, down, fwd], axis=1)
    T[:3, 3] = eye
    return T.astype(np.float32)


@dataclasses.dataclass
class Orbit:
    """The seed's orbit: angle phase + 2 pi t / lap_s."""
    radius_m: float
    height_m: float
    target: np.ndarray
    lap_s: float
    phase: float
    lidar_height_m: float

    def angle(self, t_s: float) -> float:
        return self.phase + 2.0 * math.pi * t_s / self.lap_s

    def camera_pose(self, t_s: float) -> np.ndarray:
        a = self.angle(t_s)
        eye = np.array([self.radius_m * math.cos(a),
                        self.radius_m * math.sin(a), self.height_m])
        return look_at(eye, self.target)

    def lidar_pose(self, t_s: float) -> np.ndarray:
        """Level, heading +x, on the orbit at the lidar's height."""
        a = self.angle(t_s)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (self.radius_m * math.cos(a), self.radius_m * math.sin(a),
                    self.lidar_height_m)
        return T


def draw_orbit(traffic: Dict, gen: torch.Generator) -> Orbit:
    """Phase, radius and height jitter from the seed's generator."""
    o = traffic["orbit"]
    u = torch.rand(3, generator=gen, device=gen.device,
                   dtype=torch.float64).cpu().numpy()
    j = float(o["jitter_m"])
    return Orbit(radius_m=float(o["radius_m"]) + j * (2 * u[1] - 1),
                 height_m=float(o["height_m"]) + j * (2 * u[2] - 1),
                 target=np.asarray(o["target"], np.float64),
                 lap_s=float(o["lap_s"]), phase=2 * math.pi * float(u[0]),
                 lidar_height_m=float(o.get("lidar_height_m", 1.0)))


def _noisy(r, hit, noise: Dict, gen):
    """r + N(0, a + c r^2) where hit, 0 elsewhere."""
    sigma = float(noise["a_m"]) + float(noise["c_per_m"]) * r * r
    eps = torch.randn(r.shape, generator=gen, device=r.device)
    return torch.where(hit, torch.clamp_min(r + sigma * eps, 1e-3),
                       torch.zeros_like(r))


@torch.no_grad()
def render_frames(scene: Scene, cam: CameraModel, poses: List[np.ndarray],
                  noise: Dict, gen, max_range: float, rays: int = 1 << 20):
    """Depth f32[K, H, W] (noisy z-depth, 0 = no return) and color
    u8[K, H, W, 3] (|p| * 64 mod 256 of the true hit point) at the
    poses, on the host: cast on the generator's device about `rays` rays
    at a time, each chunk copied into the host arrays before the next, so
    that the device holds one chunk's work."""
    dev = gen.device
    chunk = max(1, rays // (cam.width * cam.height))
    u = (torch.arange(cam.width, device=dev, dtype=torch.float32)
         - cam.cx) / cam.fx
    v = (torch.arange(cam.height, device=dev, dtype=torch.float32)
         - cam.cy) / cam.fy
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d_C = torch.stack([uu, vv, torch.ones_like(uu)], -1).reshape(-1, 3)
    d_C = d_C / torch.linalg.vector_norm(d_C, dim=-1, keepdim=True)
    K = len(poses)
    depths = np.empty((K, cam.height, cam.width), np.float32)
    colors = np.empty((K, cam.height, cam.width, 3), np.uint8)
    for s in range(0, K, chunk):
        T = torch.as_tensor(np.stack(poses[s:s + chunk]), device=dev)
        k = T.shape[0]
        dirs = torch.einsum("kij,nj->kni", T[:, :3, :3], d_C).reshape(-1, 3)
        orig = T[:, None, :3, 3].expand(k, d_C.shape[0], 3).reshape(-1, 3)
        t, hit = ray_cast(scene, orig, dirs, max_range)
        t = torch.where(hit, t, torch.zeros_like(t))
        p = orig + dirs * t[:, None]
        z = t * d_C[:, 2].repeat(k)
        torch.from_numpy(depths[s:s + k]).copy_(
            _noisy(z, hit, noise, gen).reshape(k, cam.height, cam.width))
        rgb = torch.fmod(torch.abs(p) * 64.0, 256.0)
        rgb = torch.where(hit[:, None], rgb, torch.zeros_like(rgb))
        torch.from_numpy(colors[s:s + k]).copy_(
            rgb.to(torch.uint8).reshape(k, cam.height, cam.width, 3))
    return depths, colors


@torch.no_grad()
def render_scans(scene: Scene, lidar: LidarModel, orbit: Orbit,
                 stamps: List[float], scan_s: float, noise: Dict, gen,
                 rays: int = 1 << 20):
    """Scans f32[S, rows * cols, 3] on the host (sensor frame at each
    column's time; (0, 0, 0), out of range, where nothing is hit) and the
    per-point times f32[rows * cols] from the scan start (column c at
    c * scan_s / cols), cast about `rays` rays at a time, each chunk of
    scans copied into the host array before the next."""
    dev = gen.device
    A, E = lidar.width, lidar.height
    dirs = torch.as_tensor(lidar.rays(), device=dev)             # [E*A, 3]
    rel = np.tile(np.arange(A) * (scan_s / A), E).astype(np.float32)
    S = len(stamps)
    out = np.empty((S, E * A, 3), np.float32)
    chunk = max(1, rays // (E * A))
    for s0 in range(0, S, chunk):
        t = np.asarray(stamps[s0:s0 + chunk])[:, None] + rel[None, :A]
        k = t.shape[0]
        ang = orbit.phase + 2.0 * np.pi * t / orbit.lap_s        # [k, A]
        cols = np.stack([orbit.radius_m * np.cos(ang),
                         orbit.radius_m * np.sin(ang),
                         np.full_like(ang, orbit.lidar_height_m)], -1)
        o = torch.as_tensor(cols.astype(np.float32), device=dev)
        o = o[:, None].expand(k, E, A, 3).reshape(-1, 3)
        d = dirs[None].expand(k, E * A, 3).reshape(-1, 3)
        t_, hit = ray_cast(scene, o, d, lidar.max_range_m)
        t_ = torch.where(hit, t_, torch.zeros_like(t_))
        r = _noisy(t_, hit, noise, gen)
        torch.from_numpy(out[s0:s0 + k]).copy_(torch.where(
            hit[:, None], d * r[:, None], torch.zeros_like(d)).reshape(
                k, E * A, 3))
    return out, rel


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


@dataclasses.dataclass
class Lap:
    """One lap of inputs on the host. Node cells: `depths`, `colors` at the
    camera rate, `scans`, `scan_rel` at the lidar rate; fuser cells:
    `depths`, `colors` and `poses` of the lap's frames."""
    orbit: Orbit
    depths: np.ndarray
    colors: np.ndarray
    poses: np.ndarray
    scans: Optional[np.ndarray] = None
    scan_rel: Optional[np.ndarray] = None


def make_lap(config: Dict, traffic: Dict, seed: int, device) -> Lap:
    """The cell's lap from the seed: frames at `frame_rate_hz` over
    `lap_s` for a node cell, `frames_per_lap` frames for a fuser cell."""
    gen = generator(seed, device)
    orbit = draw_orbit(traffic, gen)
    scene = Scene(traffic["scene"], device)
    cam = camera_model(config)
    if traffic["kind"] == "node":
        n = int(round(orbit.lap_s * config["rates_hz"]["camera"]))
        times = [k / config["rates_hz"]["camera"] for k in range(n)]
    else:
        n = int(traffic["orbit"]["frames_per_lap"])
        times = [k * orbit.lap_s / n for k in range(n)]
    poses = [orbit.camera_pose(t) for t in times]
    depths, colors = render_frames(scene, cam, poses, traffic["noise"]["depth"],
                                   gen, float(traffic["max_range_m"]))
    lap = Lap(orbit=orbit, depths=depths, colors=colors,
              poses=np.stack(poses))
    lidar = lidar_model(config)
    if traffic["kind"] == "node" and lidar is not None:
        rate = config["rates_hz"]["lidar"]
        m = int(round(orbit.lap_s * rate))
        scans, rel = render_scans(scene, lidar, orbit,
                                  [k / rate for k in range(m)], 1.0 / rate,
                                  traffic["noise"]["lidar"], gen)
        lap.scans, lap.scan_rel = scans, rel
    return lap
