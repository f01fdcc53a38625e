"""Pose-graph / keyframe submaps: globally consistent map fusion (port of
isaac_ros_nvblox_tpu/mapper/submaps.py).

  * `SubmapCollection`: integration goes into the active submap (a
    DeviceMapper) in its own anchor frame; a new submap starts when the
    sensor moves or turns past thresholds. Frames integrate at
    T_S_C = T_W_S^-1 @ T_W_C, so a submap only sees its own window's drift.
  * `PoseGraph`: an SE(3) graph over the submap anchors. Odometry
    between-factors link consecutive submaps; loop closures come from any
    front end (`add_between`). Damped Gauss-Newton on the se(3) residuals
    r = log(T_meas^-1 T_i^-1 T_j), node 0 held fixed, the Jacobian by
    `torch.func.jacfwd`, the normal equations solved densely in float32
    on the host (graphs of tens to hundreds of submaps).
  * `fuse()`: the submaps' TSDFs, re-anchored at their optimized poses,
    are merged (nearest-voxel splat, weighted average in float64 on the
    host, as the reference does) into one fresh DeviceMapper on the
    collection's device, on which the rest of the pipeline runs.

A cold path: fusion runs at service rate; the per-frame step stays the
DeviceMapper's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import device_ints
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
from isaac_ros_nvblox_tpu_torch.models.camera import Camera

_F32 = torch.float32

# --------------------------------------------------------------------------
# se(3) log / exp (rotation vector + translation)
# --------------------------------------------------------------------------


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return torch.tensor(np.asarray(x, np.float32))


def _hat(w):
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def so3_exp(w):
    """Rotation vector -> rotation matrix (Rodrigues, small-angle safe)."""
    w = _f32(w)
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2 + 1e-24)
    A = torch.sin(th) / th
    B = (1.0 - torch.cos(th)) / (th2 + 1e-24)
    # Taylor forms near 0 keep the Jacobian finite at w = 0.
    small = th < 1e-5
    A = torch.where(small, 1.0 - th2 / 6.0, A)
    B = torch.where(small, 0.5 - th2 / 24.0, B)
    W = _hat(w)
    return torch.eye(3, dtype=_F32, device=w.device) + A * W + B * (W @ W)


def so3_log(R):
    """Rotation matrix -> rotation vector: the angle from atan2 of the
    skew part's norm and the trace, smooth under jacfwd except at pi."""
    R = _f32(R)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])               # 2 sin(th) * axis
    s = torch.sqrt(torch.sum(w * w) / 4.0 + 1e-24)     # sin(th)
    c = torch.clamp((R[0, 0] + R[1, 1] + R[2, 2] - 1.0) / 2.0, -1.0, 1.0)
    th = torch.atan2(s, c)
    # w * th / (2 sin th), which tends to w / 2 as th -> 0.
    scale = th / torch.clamp_min(2.0 * s, 1e-12)
    scale = torch.where(s < 1e-6, torch.full_like(scale, 0.5), scale)
    return w * scale


def _bottom_row(like):
    return torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=_F32,
                        device=like.device)


def se3_exp(xi):
    """xi = (w[3], v[3]) -> f32[4, 4], with the first-order coupling
    V ~= I (enough for the small increments of a damped solve)."""
    xi = _f32(xi)
    top = torch.cat([so3_exp(xi[:3]), xi[3:, None]], dim=1)
    return torch.cat([top, _bottom_row(xi)], dim=0)


def se3_log(T):
    """f32[4, 4] -> (w[3], v[3]), the same first-order convention."""
    T = _f32(T)
    return torch.cat([so3_log(T[:3, :3]), T[:3, 3]])


def _inverse(T):
    """Rigid inverse written without in-place writes (jacfwd traces it)."""
    Rt = T[:3, :3].transpose(0, 1)
    top = torch.cat([Rt, -(Rt @ T[:3, 3])[:, None]], dim=1)
    return torch.cat([top, _bottom_row(T)], dim=0)


# --------------------------------------------------------------------------
# Pose graph
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BetweenFactor:
    i: int
    j: int
    T_i_j: np.ndarray      # measured relative pose (frame i from frame j)
    weight: float = 1.0


class PoseGraph:
    """SE(3) pose graph over submap anchor frames: damped Gauss-Newton on
    the stacked se(3) between-residuals, node 0 the gauge (held fixed)."""

    def __init__(self):
        self.factors: List[BetweenFactor] = []

    def add_between(self, i: int, j: int, T_i_j, weight: float = 1.0):
        self.factors.append(
            BetweenFactor(i, j, np.asarray(T_i_j, np.float32), weight))

    def optimize(self, T_W_S: List[np.ndarray], iters: int = 20,
                 damping: float = 1e-6) -> List[np.ndarray]:
        """Optimized copies of the anchor poses (float32, on the host)."""
        if not self.factors or len(T_W_S) < 2:
            return [np.asarray(T) for T in T_W_S]
        n = len(T_W_S)
        T0 = torch.stack([_f32(T) for T in T_W_S])
        Tm_inv = [_inverse(_f32(f.T_i_j)) for f in self.factors]
        sw = [float(np.sqrt(np.float32(f.weight))) for f in self.factors]

        def poses(xi_flat):
            # Node k = exp(xi_k) @ T0_k; node 0 fixed (xi_0 = 0).
            xi = torch.cat([torch.zeros((1, 6), dtype=_F32),
                            xi_flat.reshape(n - 1, 6)])
            return torch.func.vmap(lambda x, T: se3_exp(x) @ T)(xi, T0)

        def residuals(xi_flat):
            Ts = poses(xi_flat)
            return torch.cat([
                se3_log(Tm_inv[k] @ (_inverse(Ts[f.i]) @ Ts[f.j])) * sw[k]
                for k, f in enumerate(self.factors)])

        xi = torch.zeros(((n - 1) * 6,), dtype=_F32)
        eye = torch.eye(xi.shape[0], dtype=_F32)
        for _ in range(iters):
            J = torch.func.jacfwd(residuals)(xi)
            r = residuals(xi)
            H = J.T @ J + damping * eye
            xi = xi + torch.linalg.solve(H, -(J.T @ r))
        out = poses(xi)
        return [out[k].numpy().copy() for k in range(n)]

    def residual_norm(self, T_W_S: List[np.ndarray]) -> float:
        total = 0.0
        for f in self.factors:
            Ti = np.asarray(T_W_S[f.i], np.float64)
            Tj = np.asarray(T_W_S[f.j], np.float64)
            err = np.linalg.inv(np.asarray(f.T_i_j, np.float64)) \
                @ np.linalg.inv(Ti) @ Tj
            r = se3_log(err.astype(np.float32)).numpy()
            total += f.weight * float(np.sum(r * r))
        return total


# --------------------------------------------------------------------------
# Submap collection
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SubmapParams:
    max_translation_m: float = 2.0   # keyframe spawn thresholds
    max_rotation_rad: float = 0.8
    odometry_weight: float = 1.0


def _odometry(T_prev: np.ndarray, T_this: np.ndarray) -> np.ndarray:
    """The between-factor measurement T_prev^-1 T_this (float32)."""
    return (np.linalg.inv(np.asarray(T_prev, np.float64))
            @ np.asarray(T_this, np.float64)).astype(np.float32)


class SubmapCollection:
    """Keyframed submap mapping with pose-graph anchors.

    integrate_depth(depth, T_W_C_est, camera): T_W_C_est is the (drifting)
    odometry estimate. The active submap anchors at the first camera pose
    it sees (translation only, snapped to the voxel grid); consecutive
    submaps are linked by odometry between-factors, loop closures come
    from the caller (`add_loop_closure`).
    """

    def __init__(self, make_mapper, params: Optional[SubmapParams] = None):
        """make_mapper: () -> DeviceMapper factory (a fresh map per
        submap; its device is the collection's)."""
        self.make_mapper = make_mapper
        self.params = params or SubmapParams()
        self.mappers: List[DeviceMapper] = []
        self.T_W_S_est: List[np.ndarray] = []    # odometry anchor estimates
        self.T_W_S_opt: List[np.ndarray] = []    # optimized anchors
        self._first_cam: List[np.ndarray] = []   # keyframe policy reference
        self.graph = PoseGraph()

    # --------------------------------------------------------- integration
    def _spawn(self, T_W_C: np.ndarray) -> None:
        self.mappers.append(self.make_mapper())
        # Anchor = translation only, snapped to the voxel grid: submap
        # grids stay axis- and voxel-aligned with the world, so fusion
        # resamples exactly until the pose graph rotates an anchor.
        vs = self.mappers[-1].voxel_size_m
        anchor = np.eye(4, dtype=np.float32)
        anchor[:3, 3] = np.round(
            np.asarray(T_W_C, np.float64)[:3, 3] / vs) * vs
        self.T_W_S_est.append(anchor)
        self.T_W_S_opt.append(anchor.copy())
        self._first_cam.append(np.asarray(T_W_C, np.float32))
        k = len(self.mappers) - 1
        if k > 0:
            self.graph.add_between(
                k - 1, k, _odometry(self.T_W_S_est[k - 1], anchor),
                weight=self.params.odometry_weight)

    def _needs_new_submap(self, T_W_C: np.ndarray) -> bool:
        if not self.mappers:
            return True
        T_rel = np.linalg.inv(
            np.asarray(self._first_cam[-1], np.float64)) @ np.asarray(
                T_W_C, np.float64)
        trans = float(np.linalg.norm(T_rel[:3, 3]))
        cos_th = np.clip((np.trace(T_rel[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rot = float(np.arccos(cos_th))
        return (trans > self.params.max_translation_m
                or rot > self.params.max_rotation_rad)

    def integrate_depth(self, depth, T_W_C_est, camera: Camera,
                        **kw) -> None:
        """Fuse one frame into the active submap (T_W_C_est on the host:
        the keyframe policy reads it)."""
        T_W_C_est = np.asarray(T_W_C_est)
        if self._needs_new_submap(T_W_C_est):
            self._spawn(T_W_C_est)
        self.mappers[-1].integrate_depth(
            depth, _odometry(self.T_W_S_est[-1], T_W_C_est), camera, **kw)

    @property
    def num_submaps(self) -> int:
        return len(self.mappers)

    # ---------------------------------------------------------- pose graph
    def add_loop_closure(self, i: int, j: int, T_Si_Sj,
                         weight: float = 10.0) -> None:
        """Constraint between submap anchor frames (from any front end)."""
        self.graph.add_between(i, j, T_Si_Sj, weight=weight)

    def optimize(self, iters: int = 20) -> None:
        self.T_W_S_opt = self.graph.optimize(self.T_W_S_est, iters=iters)

    # -------------------------------------------------------------- fusion
    def fuse(self, world: Optional[wg.WorldGridConfig] = None,
             use_optimized: bool = True,
             indices: Optional[List[int]] = None) -> DeviceMapper:
        """Merge the submaps (all, or `indices`) into one fresh DeviceMapper.

        Each submap's observed voxels splat (nearest voxel at the shared
        resolution) into the global grid with weighted averaging, the
        combination rule projective integration uses per frame, applied
        across submaps. Cold path: the splat runs on the host in float64
        (numpy, the reference's order of additions); the rows then go to
        the fused mapper on the collection's device.
        """
        assert self.mappers, "no submaps to fuse"
        poses = self.T_W_S_opt if use_optimized else self.T_W_S_est
        vs = self.mappers[0].voxel_size_m
        if indices is None:
            indices = list(range(len(self.mappers)))

        pts_all, d_all, w_all = [], [], []
        for k in indices:
            m, T = self.mappers[k], np.asarray(poses[k], np.float64)
            n = m.block_count()
            if n == 0:
                continue
            bidx = m.state.block_index_of_slot[:n].cpu().numpy()
            d = m.channels["tsdf_distance"][:n].cpu().numpy().reshape(-1)
            w = m.channels["tsdf_weight"][:n].cpu().numpy().reshape(-1)
            lane = np.arange(512)
            lx, ly, lz = lane // 64, (lane // 8) % 8, lane % 8
            centers = (np.repeat(bidx, 512, axis=0) * 8
                       + np.stack([np.tile(lx, n), np.tile(ly, n),
                                   np.tile(lz, n)], 1) + 0.5) * vs
            keep = w > 1e-6
            pts_all.append((T[:3, :3] @ centers[keep].T).T + T[:3, 3])
            d_all.append(d[keep])
            w_all.append(w[keep])
        pts = np.concatenate(pts_all)
        dv = np.concatenate(d_all)
        wv = np.concatenate(w_all)

        vox = np.floor(pts / vs).astype(np.int64)
        if world is None:
            lo_b = np.floor(vox.min(0) / 8).astype(np.int64) - 1
            hi_b = np.floor(vox.max(0) / 8).astype(np.int64) + 1
            dims = tuple(int(x) for x in (hi_b - lo_b + 1))
            world = wg.WorldGridConfig(
                dims=dims, capacity=int(np.prod(dims)),
                origin_block=tuple(int(x) for x in lo_b))

        # Dense weighted average over the fused AABB.
        origin_vox = np.asarray(world.origin_block, np.int64) * 8
        ext = np.asarray(world.dims, np.int64) * 8
        cell = vox - origin_vox
        ok = np.all((cell >= 0) & (cell < ext), axis=1)
        cell = cell[ok]
        flat = (cell[:, 0] * ext[1] + cell[:, 1]) * ext[2] + cell[:, 2]
        W = np.zeros(int(np.prod(ext)), np.float64)
        WD = np.zeros(int(np.prod(ext)), np.float64)
        np.add.at(W, flat, wv[ok])
        np.add.at(WD, flat, wv[ok] * dv[ok])

        dev = self.mappers[0].device
        fused = DeviceMapper(
            voxel_size_m=vs, params=self.mappers[0].params, world=world,
            enable_color=False, enable_esdf=True, device=dev)

        def block_rows(a):
            return a.reshape(world.dims[0], 8, world.dims[1], 8,
                             world.dims[2], 8).transpose(
                0, 2, 4, 1, 3, 5).reshape(*world.dims, 512)

        # Allocate every block with observed mass, then write its rows.
        Wrows = block_rows(W)
        G = max(world.dims)
        mask = np.zeros((G, G, G), bool)
        mask[:world.dims[0], :world.dims[1], :world.dims[2]] = \
            Wrows.sum(-1) > 0
        fused.state = wg.allocate_from_mask(
            fused.state, torch.as_tensor(mask, device=dev),
            device_ints(world.origin_block, torch.int32, dev))
        n = fused.block_count()
        slot_grid = fused.state.slot_grid.cpu().numpy()
        bidx = fused.state.block_index_of_slot[:n].cpu().numpy()
        cells_b = bidx - np.asarray(world.origin_block)
        at = (cells_b[:, 0], cells_b[:, 1], cells_b[:, 2])
        w_rows = Wrows[at]
        d_rows = np.where(w_rows > 0,
                          block_rows(WD)[at] / np.maximum(w_rows, 1e-12), 0.0)
        slots = torch.as_tensor(slot_grid[at].astype(np.int64), device=dev)
        ch = fused.channels
        ch["tsdf_distance"][slots] = torch.as_tensor(
            d_rows.astype(np.float32), device=dev)
        ch["tsdf_weight"][slots] = torch.as_tensor(
            w_rows.astype(np.float32), device=dev)
        fused.dirty[slots] = True
        fused.esdf_dirty[slots] = True
        fused._region_unknown = True
        return fused
