"""Synthetic scenes: analytic SDF primitives + sphere-traced depth images
(port of isaac_ros_nvblox_tpu/models/scene.py).

The scene gives both the input frames (`render_depth`) and the ground
truth a reconstruction is scored against (`Scene.sdf`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (Transform, fma, norm3,
                                                   resolve_device)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera


def _vec(values, p):
    return torch.as_tensor(values, dtype=torch.float32, device=p.device)


@dataclasses.dataclass(frozen=True)
class Sphere:
    center: Tuple[float, float, float]
    radius: float

    def sdf(self, p):
        return norm3(p - _vec(self.center, p)) - self.radius


@dataclasses.dataclass(frozen=True)
class Box:
    center: Tuple[float, float, float]
    half_extents: Tuple[float, float, float]

    def sdf(self, p):
        q = torch.abs(p - _vec(self.center, p)) - _vec(self.half_extents, p)
        outside = norm3(torch.clamp_min(q, 0.0))
        inside = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
        return outside + inside


@dataclasses.dataclass(frozen=True)
class Plane:
    """Half-space: sdf = dot(normal, p) - offset (positive on normal side)."""
    normal: Tuple[float, float, float]
    offset: float

    def sdf(self, p):
        n = _vec(self.normal, p)
        n = n / norm3(n)
        s = fma(p[..., 2], n[2], fma(p[..., 1], n[1], p[..., 0] * n[0]))
        return s - self.offset


@dataclasses.dataclass(frozen=True)
class RoomBox:
    """A hollow axis-aligned room: sdf > 0 inside (free), < 0 in the walls."""
    center: Tuple[float, float, float]
    half_extents: Tuple[float, float, float]

    def sdf(self, p):
        return -Box(self.center, self.half_extents).sdf(p)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Union of primitives; scene SDF = min over primitive SDFs."""
    primitives: Tuple[object, ...]

    def sdf(self, p):
        vals = torch.stack([prim.sdf(p) for prim in self.primitives], dim=0)
        return torch.amin(vals, dim=0)

    def normal(self, p, eps: float = 1e-3):
        """Unit SDF gradient at `p[..., 3]`: central differences with step
        `eps` along each axis, the norm clamped below at 1e-9."""
        e = torch.eye(3, device=p.device) * eps
        g = torch.stack([self.sdf(p + e[i]) - self.sdf(p - e[i])
                         for i in range(3)], dim=-1)
        return g / torch.clamp_min(norm3(g)[..., None], 1e-9)


def cluttered_multi_room_scene() -> Scene:
    """Two connected rooms with a doorway and furniture-scale clutter: a
    13 x 8.8 x 3.6 m envelope split by a partition wall with a 1 m doorway,
    with table, shelf, box and sphere clutter in both rooms (the mesh
    accuracy scene of the benchmark)."""
    wall_t = 0.1
    return Scene(primitives=(
        RoomBox(center=(0.0, 0.0, 1.8), half_extents=(6.5, 4.4, 1.8)),
        # Partition wall at x = 0 with a doorway gap y in [-0.6, 0.4].
        Box(center=(0.0, -2.5, 1.8), half_extents=(wall_t, 1.9, 1.8)),
        Box(center=(0.0, 2.4, 1.8), half_extents=(wall_t, 2.0, 1.8)),
        # Room A (x < 0): table (top + leg block), shelf, clutter.
        Box(center=(-3.0, -1.2, 0.75), half_extents=(0.8, 0.5, 0.05)),
        Box(center=(-3.0, -1.2, 0.35), half_extents=(0.6, 0.35, 0.35)),
        Box(center=(-5.6, 1.5, 1.0), half_extents=(0.3, 1.0, 1.0)),
        Sphere(center=(-1.8, 1.2, 0.4), radius=0.4),
        Box(center=(-4.2, 2.4, 0.3), half_extents=(0.35, 0.3, 0.3)),
        # Room B (x > 0): sofa-ish slab, cabinet, clutter spheres.
        Box(center=(2.6, -2.4, 0.45), half_extents=(1.1, 0.5, 0.45)),
        Box(center=(5.2, 0.8, 0.9), half_extents=(0.4, 0.8, 0.9)),
        Sphere(center=(1.6, 1.6, 0.5), radius=0.5),
        Sphere(center=(3.8, 1.0, 0.3), radius=0.3),
        Box(center=(2.2, 2.8, 0.6), half_extents=(0.3, 0.3, 0.6)),
    ))


def default_test_scene() -> Scene:
    """A 10 x 8 x 3.5 m room with a sphere and a box obstacle."""
    return Scene(primitives=(
        RoomBox(center=(0.0, 0.0, 1.75), half_extents=(5.0, 4.0, 1.75)),
        Sphere(center=(1.5, 1.0, 1.0), radius=0.6),
        Box(center=(-2.0, -1.5, 0.5), half_extents=(0.5, 0.5, 0.5)),
    ))


def _sphere_trace(scene: Scene, camera: Camera, T_L_C, max_depth: float,
                  num_steps: int, device):
    """Per pixel: (hit point f32[HW, 3], hit bool[HW], ray length f32[HW],
    camera-frame ray f32[HW, 3])."""
    dev = resolve_device(device)
    T_L_C = torch.as_tensor(np.asarray(T_L_C, np.float32)
                            if not isinstance(T_L_C, torch.Tensor) else T_L_C,
                            dtype=torch.float32, device=dev)
    dirs_C = camera.ray_directions(device=dev).reshape(-1, 3)
    dirs_L = Transform.rotate(T_L_C, dirs_C)
    origin = T_L_C[:3, 3]

    def point(t):
        return fma(dirs_L, t[:, None], origin[None, :])

    t = torch.full((dirs_L.shape[0],), 1e-3, dtype=torch.float32, device=dev)
    for _ in range(num_steps):
        d = scene.sdf(point(t))
        # Stop advancing once within the hit tolerance.
        advance = torch.where(d > 1e-4, d, torch.zeros_like(d))
        t = torch.clamp_max(t + advance, max_depth * 2.0)
    p = point(t)
    hit = (scene.sdf(p) < 1e-3) & (t < max_depth)
    return p, hit, t, dirs_C


@torch.no_grad()
def render_depth(scene: Scene, camera: Camera, T_L_C, *,
                 max_depth: float = 10.0, num_steps: int = 96,
                 device=None) -> torch.Tensor:
    """Sphere-trace a z-depth image `f32[H, W]` of the scene.

    Pixels that never hit a surface within `max_depth` get depth 0
    (invalid), the sensor convention the integrators use.
    """
    _, hit, t, dirs_C = _sphere_trace(scene, camera, T_L_C, max_depth,
                                      num_steps, device)
    z = t * dirs_C[:, 2]
    depth = torch.where(hit, z, torch.zeros_like(z))
    return depth.reshape(camera.height, camera.width)


@torch.no_grad()
def render_color(scene: Scene, camera: Camera, T_L_C, *,
                 max_depth: float = 10.0, num_steps: int = 96,
                 device=None) -> torch.Tensor:
    """Render `u8[H, W, 3]` colors: position-derived RGB
    (`|p| * 64 mod 256` of the hit point), 0 where no surface is hit."""
    p, hit, _, _ = _sphere_trace(scene, camera, T_L_C, max_depth, num_steps,
                                 device)
    rgb = torch.fmod(torch.abs(p) * 64.0, 256.0)   # exact, as jnp.mod for x >= 0
    rgb = torch.where(hit[:, None], rgb, torch.zeros_like(rgb))
    return rgb.to(torch.uint8).reshape(camera.height, camera.width, 3)


def look_at_pose(eye, target) -> np.ndarray:
    """Camera pose at `eye` looking at `target` (layer frame, z-up).

    Returns T_L_C f32[4,4] with camera convention x-right, y-down,
    z-forward."""
    target = np.asarray(target, np.float64)
    eye = np.asarray(eye, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    world_up = np.asarray([0.0, 0.0, 1.0])
    right = np.cross(fwd, world_up)
    nrm = np.linalg.norm(right)
    if nrm < 1e-6:
        right = np.asarray([1.0, 0.0, 0.0])
    else:
        right = right / nrm
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=1)  # columns: x, y, z axes
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = eye
    return T


def orbit_pose(t: float, radius: float = 2.0, height: float = 1.5,
               target=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera pose orbiting (circle about the layer origin) and looking
    at `target`."""
    return look_at_pose([radius * np.cos(t), radius * np.sin(t), height],
                        target)
