"""Spherical-projection lidar model (port of
isaac_ros_nvblox_tpu/models/lidar.py).

An azimuth x elevation "camera": `project`, `is_in_valid_range`,
`unproject`, the pointcloud -> range image conversion (a deterministic
scatter-min) and per-point motion compensation.

Rounding. `project` repeats what the reference's XLA program computes:
r = sqrt(fma(z, z, fma(x, x, y*y))), correctly rounded; the elevation as
XLA expands arcsin, 2 * atan2(q, 1 + sqrt((1 - q) * (1 + q))); and the
divisions by constants folded into products with float32 constants. The
CUDA kernel `tsdf_lidar_fuse` (csrc/projective.cuh) repeats the same
steps. Where the CPU's vectorized atan2 and the reference's differ in the
last bit, a voxel on a pixel boundary may sample its neighbour.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (Transform, fma, recip32,
                                                   sqrt32)

PI32 = float(np.float32(np.pi))


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Lidar:
    num_azimuth_divisions: int
    num_elevation_divisions: int
    min_valid_range_m: float
    max_valid_range_m: float
    # Equal-FoV model: symmetric vertical fov. Non-equal: explicit angles.
    min_angle_below_zero_elevation_rad: float
    max_angle_above_zero_elevation_rad: float

    @staticmethod
    def equal_vertical_fov(num_azimuth: int, num_elevation: int,
                           vertical_fov_rad: float,
                           min_range_m: float = 0.4,
                           max_range_m: float = 100.0) -> "Lidar":
        half = vertical_fov_rad / 2.0
        return Lidar(num_azimuth, num_elevation, min_range_m, max_range_m,
                     half, half)

    @property
    def elevation_range_rad(self) -> float:
        return (self.min_angle_below_zero_elevation_rad
                + self.max_angle_above_zero_elevation_rad)

    @property
    def rads_per_row(self) -> float:
        return self.elevation_range_rad / max(
            self.num_elevation_divisions - 1, 1)

    def scalars(self) -> np.ndarray:
        """The float32 constants of `project`, in the order the CUDA
        kernel reads them (csrc/projective.cuh LidarParams): the azimuth
        scale A/(2 pi) as XLA folds it, pi, the top elevation, 1/rad per
        row, the valid elevation band and the valid range."""
        rpr = self.rads_per_row
        u_scale = np.float32(recip32(2 * np.pi)) * np.float32(
            self.num_azimuth_divisions)
        return np.asarray(
            [u_scale, PI32, self.max_angle_above_zero_elevation_rad,
             recip32(rpr), -self.min_angle_below_zero_elevation_rad - rpr / 2,
             self.max_angle_above_zero_elevation_rad + rpr / 2,
             self.min_valid_range_m, self.max_valid_range_m], np.float32)

    def project(self, p_L):
        """Points `f32[..., 3]` (sensor frame, z up) -> (uv f32[..., 2],
        range f32[...], valid bool[...]).

        u: azimuth column in [0, num_azimuth]; v: elevation row, 0 at the
        top (max elevation), as in an image.
        """
        s = [float(c) for c in self.scalars()]
        x, y, z = p_L[..., 0], p_L[..., 1], p_L[..., 2]
        r = sqrt32(fma(z, z, fma(x, x, y * y)))
        azimuth = torch.atan2(y, x)
        q = torch.clamp(z / torch.clamp_min(r, 1e-9), -1.0, 1.0)
        # arcsin as XLA expands it.
        elevation = 2.0 * torch.atan2(q, 1.0 + sqrt32((1.0 - q) * (1.0 + q)))
        u = (azimuth + s[1]) * s[0]
        v = (s[2] - elevation) * s[3]
        valid = (self.is_in_valid_range(r) & (elevation >= s[4])
                 & (elevation <= s[5]))
        return torch.stack([u, v], dim=-1), r, valid

    def is_in_valid_range(self, r):
        return ((r >= _f32(self.min_valid_range_m))
                & (r <= _f32(self.max_valid_range_m)))

    def unproject(self, device=None):
        """Unit ray directions `f32[rows, cols, 3]` per range-image cell."""
        A, E = self.num_azimuth_divisions, self.num_elevation_divisions
        az = ((torch.arange(A, dtype=torch.float32, device=device) + 0.5)
              / A * (2 * np.pi) - np.pi)
        el = (self.max_angle_above_zero_elevation_rad
              - torch.arange(E, dtype=torch.float32, device=device)
              * self.rads_per_row)
        elg, azg = torch.meshgrid(el, az, indexing="ij")
        ce = torch.cos(elg)
        return torch.stack([ce * torch.cos(azg), ce * torch.sin(azg),
                            torch.sin(elg)], dim=-1)


@torch.no_grad()
def pointcloud_to_range_image(points, lidar: Lidar) -> torch.Tensor:
    """Pointcloud `f32[N, 3]` -> range image `f32[rows, cols]` (0 invalid).

    Cell collisions keep the closest return (a scatter-min, deterministic
    on every device); u and v truncate toward zero, then clip.
    """
    uv, r, valid = lidar.project(points)
    rows, cols = lidar.num_elevation_divisions, lidar.num_azimuth_divisions
    big = float(2 ** 30)
    u = uv[..., 0].clamp(-big, big).to(torch.int32).clamp(0, cols - 1)
    v = uv[..., 1].clamp(-big, big).to(torch.int32).clamp(0, rows - 1)
    img = torch.full((rows * cols,), float("inf"), dtype=torch.float32,
                     device=points.device)
    r_masked = torch.where(valid, r, torch.full_like(r, float("inf")))
    img.scatter_reduce_(0, (v * cols + u).long(), r_masked, reduce="amin")
    img = torch.where(torch.isfinite(img), img, torch.zeros_like(img))
    return img.reshape(rows, cols)


@torch.no_grad()
def motion_compensate_pointcloud(points, timestamps_s, T_L_S_start,
                                 T_L_S_end, lidar: Lidar) -> torch.Tensor:
    """Undistort a scan: each point moves by the pose interpolated at its
    own timestamp (relative to scan start; the scan lasts the largest
    timestamp), expressed in the scan-end sensor frame. The poses come
    from 16 interpolation bins, `bin = clip(int(alpha * 15), 0, 15)`."""
    del lidar
    duration = torch.clamp_min(torch.amax(timestamps_s), 1e-9)
    alpha = torch.clamp(timestamps_s / duration, 0.0, 1.0)
    n_bins = 16
    bin_alphas = torch.linspace(0.0, 1.0, n_bins, device=points.device)
    Ts = Transform.interpolate(T_L_S_start, T_L_S_end, bin_alphas)
    bin_idx = torch.clamp((alpha * (n_bins - 1)).to(torch.int32), 0,
                          n_bins - 1)
    T_pp = Ts[bin_idx.long()]
    p_world = (torch.einsum("nij,nj->ni", T_pp[:, :3, :3], points)
               + T_pp[:, :3, 3])
    T_S_L_end = Transform.inverse(T_L_S_end)
    return p_world @ T_S_L_end[:3, :3].T + T_S_L_end[:3, 3]
