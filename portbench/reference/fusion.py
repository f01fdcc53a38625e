"""Plain PyTorch reference of projective fusion on a dense voxel grid.

The map is a dense box of voxels (`DenseMap`) in place of a block pool:
every voxel that a frame's update rule selects is updated, whatever
blocks a program would allocate for it. The rules are nvblox's:

  * depth (z-depth image) and lidar (range image) into a TSDF: the voxel
    centre projected into the sensor, the nearest sample, sdf = measured
    - z (or - range); updated where the sample is valid, the voxel lies
    within the integration distance and sdf >= -truncation; the weight
    (nvblox's six weighting modes) folds min(sdf, truncation) into the
    running average, the weight capped at `max_weight`;
  * color: voxels observed near the surface (weight > 1e-6, |d| <=
    truncation), in view and in range, not occluded where a depth image is
    given, average the nearest color sample with the weight at sdf = 0;
  * a lidar scan goes to a range image first (closest return per cell),
    after motion compensation into the scan-end frame from 16 poses
    interpolated between the scan's start and end poses.

Arithmetic is float32 as the configuration states, or the `dtype` the map
is made with (the lower-precision control). Products and sums follow the
order nvblox's float32 code uses (a fused multiply-add where it fuses),
so that float32 runs agree with the program to rounding.

This module imports torch and numpy only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

MODES = ("constant", "constant_dropoff", "inverse_square",
         "inverse_square_dropoff", "inverse_square_tsdf_distance_penalty",
         "linear_with_max")


@dataclasses.dataclass(frozen=True)
class FusionParams:
    voxel_size_m: float
    max_integration_distance_m: float = 7.0
    truncation_distance_vox: float = 4.0
    max_weight: float = 5.0
    weighting_mode: str = "inverse_square_dropoff"

    @property
    def truncation_m(self) -> float:
        return self.truncation_distance_vox * self.voxel_size_m


def f32(x: float) -> float:
    return float(np.float32(x))


def recip32(c: float) -> float:
    return float(np.float32(1.0) / np.float32(c))


def fma(a, b, c):
    """a * b + c rounded once: torch.addcmul where the device fuses it (a
    card), through float64 for float32 on the CPU."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(b, torch.Tensor):
        b = torch.full((), float(b), dtype=a.dtype, device=a.device)
    if not isinstance(c, torch.Tensor):
        c = torch.full((), float(c), dtype=a.dtype, device=a.device)
    if a.device.type == "cpu" and a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return torch.addcmul(c, a, b)


def sqrt(x):
    """Correctly rounded square root (through float64 for float32 on the
    CPU, whose vectorized float32 root is not)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _fl32(x: float) -> float:
    return float(np.float32(x))


def inverse_pose(T: np.ndarray) -> np.ndarray:
    """T^-1 of a rigid f32[4, 4]: R^T and -R^T t, each row summed as x*m0,
    then fused multiply-adds of y and z (rounded to float32 per step)."""
    T = np.asarray(T, np.float32)
    R = T[:3, :3].T.astype(np.float32)
    t = T[:3, 3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    for i in range(3):
        s = _fl32(float(t[0]) * float(-R[i, 0]))
        s = _fl32(float(t[1]) * float(-R[i, 1]) + s)
        s = _fl32(float(t[2]) * float(-R[i, 2]) + s)
        out[i, 3] = s
    return out


def apply_pose(T, p):
    """T (tensor f32[4, 4]) applied to points [..., 3] in T's dtype."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rows = []
    for i in range(3):
        s = x * T[i, 0]
        s = fma(y, T[i, 1], s)
        s = fma(z, T[i, 2], s)
        rows.append(s + T[i, 3])
    return torch.stack(rows, -1)


def sample_nearest(image, u, v):
    """image[round(v), round(u)], halves to even, clamped to the image."""
    H, W = image.shape[0], image.shape[1]
    ui = torch.round(u).clamp(-1.0, float(W)).long().clamp(0, W - 1)
    vi = torch.round(v).clamp(-1.0, float(H)).long().clamp(0, H - 1)
    return image[vi, ui]


def weight_of(mode: str, z, sdf, truncation: float, eps: float):
    """nvblox's per-sample weight (z: depth or range; sdf unclamped)."""
    one = torch.ones_like(z)
    inv_sq = 1.0 / torch.clamp_min(z * z, 1e-4)
    r_drop = recip32(max(truncation - eps, 1e-6))
    dropoff = torch.clamp((truncation + sdf) * r_drop, 0.0, 1.0)
    if mode == "constant":
        return one
    if mode == "constant_dropoff":
        return dropoff
    if mode == "inverse_square":
        return inv_sq
    if mode == "inverse_square_dropoff":
        return inv_sq * dropoff
    if mode == "inverse_square_tsdf_distance_penalty":
        pen = torch.clamp(fma(-torch.abs(sdf), recip32(max(truncation, 1e-6)),
                              1.0), 0.0, 1.0)
        return inv_sq * pen
    if mode == "linear_with_max":
        return torch.minimum(one, 1.0 / torch.clamp_min(z, 1e-4))
    raise ValueError(f"unknown weighting mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class Pinhole:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def project(self, p):
        """(u, v, z, in view) of camera-frame points."""
        z = p[..., 2]
        zs = torch.where(z > 1e-6, z, torch.ones_like(z))
        u = self.fx * p[..., 0] / zs + self.cx
        v = self.fy * p[..., 1] / zs + self.cy
        ok = ((z > 1e-6) & (u >= 0.0) & (u <= self.width - 1.0)
              & (v >= 0.0) & (v <= self.height - 1.0))
        return u, v, z, ok


@dataclasses.dataclass(frozen=True)
class Spherical:
    """An equal-vertical-FoV spinning lidar: `cols` azimuth columns from
    -pi, `rows` elevation rows from +fov/2 down."""
    cols: int
    rows: int
    vertical_fov_rad: float
    min_range_m: float
    max_range_m: float

    def constants(self):
        half = self.vertical_fov_rad / 2.0
        rpr = self.vertical_fov_rad / max(self.rows - 1, 1)
        return (f32(f32(recip32(2 * np.pi)) * np.float32(self.cols)),
                f32(np.pi), f32(half), f32(recip32(rpr)),
                f32(-half - rpr / 2), f32(half + rpr / 2))

    def project(self, p):
        """(u, v, range, valid) of sensor-frame points."""
        s_u, pi, top, inv_rpr, el_lo, el_hi = self.constants()
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        r = sqrt(fma(z, z, fma(x, x, y * y)))
        az = torch.atan2(y, x)
        q = torch.clamp(z / torch.clamp_min(r, 1e-9), -1.0, 1.0)
        el = 2.0 * torch.atan2(q, 1.0 + sqrt((1.0 - q) * (1.0 + q)))
        u = (az + pi) * s_u
        v = (top - el) * inv_rpr
        ok = ((r >= f32(self.min_range_m)) & (r <= f32(self.max_range_m))
              & (el >= el_lo) & (el <= el_hi))
        return u, v, r, ok

    def range_image(self, points):
        """Closest valid return per cell, f32[rows, cols] (0 = none); u
        and v truncate toward zero, then clip."""
        u, v, r, ok = self.project(points)
        big = float(2 ** 30)
        ui = u.clamp(-big, big).to(torch.int32).clamp(0, self.cols - 1)
        vi = v.clamp(-big, big).to(torch.int32).clamp(0, self.rows - 1)
        img = torch.full((self.rows * self.cols,), float("inf"),
                         dtype=r.dtype, device=r.device)
        img.scatter_reduce_(0, (vi * self.cols + ui).long(),
                            torch.where(ok, r, torch.full_like(r, np.inf)),
                            reduce="amin")
        img = torch.where(torch.isfinite(img), img, torch.zeros_like(img))
        return img.reshape(self.rows, self.cols)


def _quat(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix (float64)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    cands = []
    for i, s in enumerate([tr + 1.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2],
                           1.0 + R[1, 1] - R[0, 0] - R[2, 2],
                           1.0 + R[2, 2] - R[0, 0] - R[1, 1]]):
        s = math.sqrt(max(s, 1e-12)) * 2.0
        if i == 0:
            q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                 (R[1, 0] - R[0, 1]) / s]
        elif i == 1:
            q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s,
                 (R[0, 2] + R[2, 0]) / s]
        elif i == 2:
            q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s,
                 (R[1, 2] + R[2, 1]) / s]
        else:
            q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                 (R[1, 2] + R[2, 1]) / s, 0.25 * s]
        cands.append(np.asarray(q))
    piv = int(np.argmax([tr, R[0, 0], R[1, 1], R[2, 2]]))
    q = cands[piv]
    return q / np.linalg.norm(q)


def _rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def interpolate_poses(T0: np.ndarray, T1: np.ndarray,
                      alphas: np.ndarray) -> np.ndarray:
    """Poses f32[K, 4, 4] at `alphas` between T0 and T1: translation
    lerp in float32, rotation by normalized quaternion lerp on the
    shortest arc."""
    T0 = np.asarray(T0, np.float32)
    T1 = np.asarray(T1, np.float32)
    a = np.asarray(alphas, np.float32)
    q0, q1 = _quat(T0[:3, :3]), _quat(T1[:3, :3])
    if np.dot(q0, q1) < 0:
        q1 = -q1
    out = np.zeros((a.shape[0], 4, 4), np.float32)
    for k, ak in enumerate(a):
        q = q0 * (1.0 - float(ak)) + q1 * float(ak)
        out[k, :3, :3] = _rot(q / max(np.linalg.norm(q), 1e-12))
        out[k, :3, 3] = (T0[:3, 3] * (np.float32(1.0) - ak)
                         + T1[:3, 3] * ak)
        out[k, 3, 3] = 1.0
    return out


def motion_compensate(points, rel_s, T_start: np.ndarray,
                      T_end: np.ndarray):
    """Each point moved by the pose of its time bin (16 bins between the
    scan's start and end poses), expressed in the scan-end frame."""
    dev, dt = points.device, points.dtype
    rel = torch.as_tensor(rel_s, device=dev, dtype=torch.float32)
    alpha = torch.clamp(rel / torch.clamp_min(torch.amax(rel), 1e-9),
                        0.0, 1.0)
    bins = torch.linspace(0.0, 1.0, 16)
    Ts = torch.as_tensor(interpolate_poses(T_start, T_end, bins.numpy()),
                         device=dev, dtype=dt)
    idx = torch.clamp((alpha * 15).to(torch.int32), 0, 15).long()
    Tp = Ts[idx]
    world = torch.einsum("nij,nj->ni", Tp[:, :3, :3], points) + Tp[:, :3, 3]
    Ti = torch.as_tensor(inverse_pose(T_end), device=dev, dtype=dt)
    return world @ Ti[:3, :3].T + Ti[:3, 3]


class DenseMap:
    """TSDF (distance, weight) and color (r, g, b, weight) channels of the
    voxels `origin + [0, dims)` (global voxel indices; dims whole blocks),
    in `dtype`."""

    def __init__(self, origin_vox, dims, params: FusionParams, *,
                 dtype=torch.float32, device="cpu", color: bool = True):
        self.origin = np.asarray(origin_vox, np.int64)
        self.dims = tuple(int(d) for d in dims)
        assert all(d % 8 == 0 for d in self.dims)
        self.params = params
        self.dtype = dtype
        self.device = torch.device(device)
        z = lambda: torch.zeros(self.dims, dtype=dtype, device=self.device)
        self.d, self.w = z(), z()
        self.color = [z() for _ in range(4)] if color else None

    # ------------------------------------------------------------ regions
    def _clip(self, lo_vox, hi_vox):
        """[lo, hi) of a voxel AABB snapped out to whole blocks and
        clipped to the map, as offsets into the arrays; None if empty."""
        lo = np.floor(np.asarray(lo_vox) / 8).astype(np.int64) * 8
        hi = np.ceil(np.asarray(hi_vox) / 8).astype(np.int64) * 8
        lo = np.maximum(lo - self.origin, 0)
        hi = np.minimum(hi - self.origin, self.dims)
        if np.any(hi <= lo):
            return None
        return lo, hi

    def _centers(self, lo, hi):
        vs = f32(self.params.voxel_size_m)
        axes = [((torch.arange(int(l), int(h), device=self.device)
                  + int(o)).to(torch.float32) + 0.5) * vs
                for l, h, o in zip(lo, hi, self.origin)]
        g = torch.meshgrid(*axes, indexing="ij")
        return torch.stack(g, -1).to(self.dtype)

    def _region_blocks(self, lo, hi):
        """Global block indices i64[Bx, By, Bz, 3] of a region."""
        axes = [torch.arange(int(l) // 8, int(h) // 8, device=self.device)
                + int(o) // 8 for l, h, o in zip(lo, hi, self.origin)]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)

    @staticmethod
    def _voxels_of(block_mask):
        """bool[X, Y, Z] of a bool[Bx, By, Bz] block mask."""
        return (block_mask.repeat_interleave(8, 0).repeat_interleave(8, 1)
                .repeat_interleave(8, 2))

    def _touched(self, lo, hi, test, *args):
        """bool voxel mask of a region: the blocks `test` touches."""
        blocks = self._region_blocks(lo, hi)
        p = self.params
        hit = test(*args, blocks.reshape(-1, 3),
                   voxel_size_m=p.voxel_size_m,
                   max_distance_m=p.max_integration_distance_m,
                   truncation_m=p.truncation_m)
        return self._voxels_of(hit.reshape(blocks.shape[:3]))

    def _view(self, arr, lo, hi):
        return arr[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]

    def _blocks_touched(self, mask, lo) -> int:
        """Blocks of a region (offset `lo`) with a set voxel; their global
        block AABB (inclusive) goes to `last_blocks`, or None."""
        X, Y, Z = mask.shape
        per = mask.view(X // 8, 8, Y // 8, 8, Z // 8, 8).any(5).any(3).any(1)
        n = int(per.sum())
        self.last_blocks = None
        if n:
            idx = torch.nonzero(per)
            base = (self.origin + np.asarray(lo)) // 8
            self.last_blocks = (idx.amin(0).cpu().numpy() + base,
                                idx.amax(0).cpu().numpy() + base)
        return n

    @classmethod
    def world_probe(cls, world, params: FusionParams, device) -> "DenseMap":
        """A map that holds no voxels but clips regions to the world
        (`origin_block`, `dims` in blocks), to work out where frames
        reach."""
        probe = cls(np.asarray(world["origin_block"]) * 8, (8, 8, 8), params,
                    device=device, color=False)
        probe.dims = tuple(int(d) * 8 for d in world["dims"])
        return probe

    def region_of_points(self, origin_m, points_m, margin_m: float):
        """Voxel AABB of a sensor origin and points (meters), widened by
        `margin_m`."""
        vs = self.params.voxel_size_m
        pts = np.concatenate([np.asarray(points_m, np.float64).reshape(-1, 3),
                              np.asarray(origin_m, np.float64)[None]])
        lo = np.floor((pts.min(0) - margin_m) / vs).astype(np.int64)
        hi = np.ceil((pts.max(0) + margin_m) / vs).astype(np.int64) + 1
        return self._clip(lo, hi)

    # ----------------------------------------------------------- fusion
    def _fuse(self, lo, hi, meas, z, ok):
        """Fold samples (`meas`, depth or range `z`) into the TSDF of the
        region where `ok`; returns the blocks updated."""
        p = self.params
        trunc = p.truncation_m
        sdf = meas - z
        upd = (ok & (meas > 0.0) & torch.isfinite(meas)
               & (z <= p.max_integration_distance_m) & (sdf >= -trunc))
        w_new = weight_of(p.weighting_mode, z, sdf, trunc, p.voxel_size_m)
        w_new = torch.where(upd, w_new, torch.zeros_like(w_new))
        d_v, w_v = self._view(self.d, lo, hi), self._view(self.w, lo, hi)
        sdf_c = torch.clamp_max(sdf, trunc)
        w_sum = w_v + w_new
        d_f = torch.where(w_sum > 1e-6,
                          fma(d_v, w_v, sdf_c * w_new)
                          / torch.clamp_min(w_sum, 1e-6), d_v)
        d_v.copy_(torch.where(upd, d_f, d_v))
        w_v.copy_(torch.where(upd, torch.clamp_max(w_sum, p.max_weight), w_v))
        return self._blocks_touched(upd, lo)

    def integrate_depth(self, depth, T_L_C: np.ndarray, cam: Pinhole) -> int:
        """One z-depth image (tensor f32[H, W], 0 = invalid) at T_L_C;
        returns the blocks it updated."""
        region = self._depth_region(depth, T_L_C, cam)
        if region is None:
            return 0
        lo, hi = region
        T = torch.as_tensor(inverse_pose(T_L_C), device=self.device,
                            dtype=self.dtype)
        u, v, z, ok = cam.project(apply_pose(T, self._centers(lo, hi)))
        meas = sample_nearest(depth.to(self.dtype), u, v)
        from .view import touched_by_camera
        ok = ok & self._touched(lo, hi, touched_by_camera, depth, T_L_C, cam)
        return self._fuse(lo, hi, meas, z, ok)

    def _depth_region(self, depth, T_L_C, cam: Pinhole):
        """The voxels a depth image can update: the camera and every valid
        pixel's point pushed a truncation further, plus two voxels."""
        d = depth.float()
        H, W = d.shape
        vv, uu = torch.meshgrid(torch.arange(H, device=d.device),
                                torch.arange(W, device=d.device),
                                indexing="ij")
        good = d > 0
        if not bool(good.any()):
            return None
        zz = d[good] + self.params.truncation_m
        pc = torch.stack([(uu[good] - cam.cx) / cam.fx * zz,
                          (vv[good] - cam.cy) / cam.fy * zz, zz], -1)
        T = torch.as_tensor(T_L_C, dtype=torch.float32, device=d.device)
        pl = pc @ T[:3, :3].T + T[:3, 3]
        lo = torch.minimum(pl.amin(0), T[:3, 3]).cpu().numpy()
        hi = torch.maximum(pl.amax(0), T[:3, 3]).cpu().numpy()
        return self.region_of_points(lo, hi[None], 2 * self.params.voxel_size_m
                                     + 0.5 * self.params.max_integration_distance_m
                                     / min(cam.fx, cam.fy))

    def integrate_scan(self, points, rel_s, T_start: np.ndarray,
                       T_end: Optional[np.ndarray], lidar: Spherical) -> int:
        """One lidar scan (sensor-frame points f32[N, 3], per-point times
        from the scan start): motion compensation when `T_end` is given,
        then the range image at the scan-end pose; returns the blocks
        updated."""
        pts = torch.as_tensor(points, device=self.device, dtype=self.dtype)
        T_S = T_start
        if T_end is not None:
            pts = motion_compensate(pts, rel_s, T_start, T_end)
            T_S = T_end
        img = lidar.range_image(pts)
        region = self._scan_region(pts, T_S, lidar)
        if region is None:
            return 0
        lo, hi = region
        T = torch.as_tensor(inverse_pose(T_S), device=self.device,
                            dtype=self.dtype)
        u, v, r, ok = lidar.project(apply_pose(T, self._centers(lo, hi)))
        meas = sample_nearest(img, u, v)
        from .view import touched_by_lidar
        ok = ok & self._touched(lo, hi, touched_by_lidar, img, T_S, lidar)
        return self._fuse(lo, hi, meas, r, ok)

    def _scan_region(self, pts, T_S: np.ndarray, lidar: Spherical):
        """The voxels a scan can update: the sensor and every return
        pushed a truncation further, widened by the angle from a beam to
        the edge of its range-image cell at the farthest reach."""
        p = self.params
        q = pts.float()
        r = torch.linalg.vector_norm(q, dim=-1)
        good = (r >= lidar.min_range_m) & (r <= lidar.max_range_m)
        if not bool(good.any()):
            return None
        q = q[good] * ((r[good] + p.truncation_m) / r[good])[:, None]
        T = torch.as_tensor(T_S, dtype=torch.float32, device=q.device)
        ql = q @ T[:3, :3].T + T[:3, 3]
        lo = torch.minimum(ql.amin(0), T[:3, 3]).cpu().numpy()
        hi = torch.maximum(ql.amax(0), T[:3, 3]).cpu().numpy()
        rpr = lidar.vertical_fov_rad / max(lidar.rows - 1, 1)
        reach = min(p.max_integration_distance_m, lidar.max_range_m) \
            + p.truncation_m
        margin = reach * (0.75 * rpr + 2 * np.pi / lidar.cols) \
            + 2 * p.voxel_size_m
        return self.region_of_points(lo, hi[None], margin)

    def integrate_color(self, color, T_L_C: np.ndarray, cam: Pinhole,
                        depth=None) -> None:
        """One u8[H, W, 3] color image; `depth` (f32[Hd, Wd], sampled at
        uv * Hd / H) makes occluded voxels keep their color."""
        p = self.params
        trunc = p.truncation_m
        # Every voxel of the map: a voxel in view at the integration
        # distance lies farther than that from the camera off the axis.
        lo, hi = np.zeros(3, np.int64), np.asarray(self.dims, np.int64)
        T = torch.as_tensor(inverse_pose(T_L_C), device=self.device,
                            dtype=self.dtype)
        u, v, z, ok = cam.project(apply_pose(T, self._centers(lo, hi)))
        d_v, w_v = self._view(self.d, lo, hi), self._view(self.w, lo, hi)
        from .view import touched_by_camera
        full = torch.full((cam.height, cam.width),
                          p.max_integration_distance_m, device=self.device)
        upd = (ok & (w_v > 1e-6) & (torch.abs(d_v) <= trunc)
               & (z <= p.max_integration_distance_m)
               & self._touched(lo, hi, touched_by_camera, full, T_L_C, cam))
        if depth is not None:
            scale = f32(np.float32(depth.shape[0]) / np.float32(cam.height))
            meas = sample_nearest(depth.to(self.dtype), u * scale, v * scale)
            upd = upd & (meas > 0.0) & (z <= meas + trunc)
        w_new = weight_of(p.weighting_mode, z, torch.zeros_like(z), trunc,
                          p.voxel_size_m)
        w_new = torch.where(upd, w_new, torch.zeros_like(w_new))
        cw = self._view(self.color[3], lo, hi)
        w_sum = cw + w_new
        inv = 1.0 / torch.clamp_min(w_sum, 1e-6)
        rgb = color.to(self.dtype)
        for ch in range(3):
            c_v = self._view(self.color[ch], lo, hi)
            sample = sample_nearest(rgb[..., ch], u, v)
            c_f = torch.where(w_sum > 1e-6,
                              fma(c_v, cw, sample * w_new) * inv, c_v)
            c_v.copy_(torch.where(upd, c_f, c_v))
        cw.copy_(torch.where(upd, torch.clamp_max(w_sum, p.max_weight), cw))

    # ------------------------------------------------------------ reading
    def block_aabb_observed(self, min_weight: float):
        """(lo, hi) global block indices of the observed voxels' blocks,
        inclusive; None when nothing is observed."""
        obs = self.w >= min_weight
        if not bool(obs.any()):
            return None
        idx = torch.nonzero(obs.view(self.dims[0] // 8, 8, self.dims[1] // 8,
                                     8, self.dims[2] // 8, 8)
                            .any(5).any(3).any(1))
        lo = idx.amin(0).cpu().numpy() + self.origin // 8
        hi = idx.amax(0).cpu().numpy() + self.origin // 8
        return lo, hi
