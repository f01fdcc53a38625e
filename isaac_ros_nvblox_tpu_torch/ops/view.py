"""ViewCalculator: which blocks does a depth view touch?
(port of isaac_ros_nvblox_tpu/ops/view.py)

The touch test is evaluated densely per cell of a G^3 block grid placed
on the camera's optical axis: a block is touched if its center projects
into the (footprint-inflated) image and lies in front of the maximum
valid depth over its pixel footprint plus the truncation band. The
footprint maximum comes from two max-pooled coarse images. The result
must equal the reference's grid cell for cell: one flipped cell changes
the allocation and reorders every later slot, so the comparisons and
roundings follow the reference (its coarse samples go through bfloat16).
"""

from __future__ import annotations

import dataclasses
import enum
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from isaac_ros_nvblox_tpu_torch.core.types import (Transform, block_size_m,
                                                   fma, norm3, recip32)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera


class WorkspaceBoundsType(enum.Enum):
    UNBOUNDED = "unbounded"
    HEIGHT_BOUNDS = "height_bounds"
    BOUNDING_BOX = "bounding_box"


@dataclasses.dataclass(frozen=True)
class ViewCalculatorParams:
    raycast_subsampling_factor: int = 4
    workspace_bounds_type: WorkspaceBoundsType = WorkspaceBoundsType.UNBOUNDED
    workspace_bounds_min_corner_m: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    workspace_bounds_max_corner_m: Tuple[float, float, float] = (0.0, 0.0, 0.0)


def _grid_radius_blocks(max_distance_m: float, voxel_size_m: float) -> int:
    bs = block_size_m(voxel_size_m)
    return int(np.ceil(max_distance_m / bs)) + 1


@functools.lru_cache(maxsize=None)
def _camera_grid_geometry(camera: Camera, voxel_size_m: float,
                          max_distance_m: float) -> Tuple[float, int]:
    """Static per-camera geometry of the touch test's support region:
    (h_m, R_blocks), grid center = camera origin + h_m * optical axis,
    grid half-extent R_blocks cells (the region's minimal enclosing
    sphere sits on the optical axis)."""
    bs = block_size_m(voxel_size_m)
    D = max_distance_m + bs
    m = bs * float(np.sqrt(3.0)) / 4.0   # lateral inflation (half_diag cap)
    tu = max(camera.cx, camera.width - 1.0 - camera.cx) / camera.fx
    tv = max(camera.cy, camera.height - 1.0 - camera.cy) / camera.fy
    b = 1.5 * bs   # near-camera ball
    pts = [(0.0, 0.0, -b), (b, 0.0, 0.0), (-b, 0.0, 0.0),
           (0.0, b, 0.0), (0.0, -b, 0.0)]
    for su in (-1.0, 1.0):
        for sv in (-1.0, 1.0):
            pts.append((su * (m + b), sv * (m + b), 0.0))
            pts.append((su * (D * tu + m), sv * (D * tv + m), D))
    pts = np.asarray(pts)

    def rad(h):
        return float(np.max(np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2
                                    + (pts[:, 2] - h) ** 2)))

    lo, hi = 0.0, D   # rad(h) is convex -> ternary search
    for _ in range(80):
        m1, m2 = lo + (hi - lo) / 3.0, hi - (hi - lo) / 3.0
        if rad(m1) < rad(m2):
            hi = m2
        else:
            lo = m1
    h = 0.5 * (lo + hi)
    return h, int(np.ceil(rad(h) / bs)) + 1


def _cell_iota(G: int, device) -> torch.Tensor:
    r = torch.arange(G, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1)


@torch.no_grad()
def touched_block_grid(depth, T_L_C, *, camera: Camera, voxel_size_m: float,
                       max_distance_m: float, truncation_m: float):
    """Mark the blocks touched by a depth frame.

    Returns (grid bool[G,G,G], origin_block i32[3]) where grid[i,j,k] marks
    block `origin_block + (i,j,k)`. Tensors stay on the depth's device;
    nothing is read back to the host.
    """
    dev = depth.device
    bs = block_size_m(voxel_size_m)
    h_m, R = _camera_grid_geometry(camera, voxel_size_m, max_distance_m)
    G = 2 * R + 1

    cam_origin = T_L_C[:3, 3]
    grid_center = fma(T_L_C[:3, 2], h_m, cam_origin)
    origin_block = (torch.floor(grid_center * recip32(bs)).to(torch.int32)
                    - R)

    # Max-valid-depth coarse images at 32 and 64 px cells, each widened by
    # a centered 3x3 max so that a sample at the containing cell covers
    # +- one full cell. 2x2 pooling pads odd sizes at the end (ceil mode).
    d_valid = torch.where(torch.isfinite(depth) & (depth > 0.0), depth,
                          torch.zeros_like(depth))
    lvl_a, lvl_b = 5, 6
    coarse = {}
    img = d_valid[None, None]
    for lvl in range(lvl_b + 1):
        if lvl in (lvl_a, lvl_b):
            coarse[lvl] = F.max_pool2d(img, 3, stride=1, padding=1)[0, 0]
        img = F.max_pool2d(img, 2, stride=2, ceil_mode=True)
    global_max = torch.amax(d_valid)

    centers = ((_cell_iota(G, dev).float() + origin_block.float() + 0.5)
               * bs).reshape(-1, 3)
    p_C = Transform.apply(Transform.inverse(T_L_C), centers)
    z = p_C[:, 2]
    eps = 1e-6
    z_safe = torch.where(z > eps, z, torch.ones_like(z))
    u = camera.fx * p_C[:, 0] / z_safe + camera.cx
    v = camera.fy * p_C[:, 1] / z_safe + camera.cy

    # Pixel footprint of a block at this depth; the in-view test is
    # inflated by the block's projected half diagonal.
    f_max = max(camera.fx, camera.fy)
    footprint = f_max * bs / torch.clamp_min(z, eps)
    half_diag = footprint * float(np.sqrt(3.0) / 2.0) * 0.5
    in_view = ((z > eps)
               & (u >= -half_diag) & (u <= camera.width - 1.0 + half_diag)
               & (v >= -half_diag) & (v <= camera.height - 1.0 + half_diag))

    def sample(img_l, lvl):
        # The reference samples through a bfloat16 one-hot product, so
        # the sampled maximum is the bfloat16 rounding of the cell value.
        H_l, W_l = img_l.shape
        big = float(2 ** 30)
        cu = (u / (2 ** lvl)).clamp(-big, big).to(torch.int32).clamp(0, W_l - 1)
        cv = (v / (2 ** lvl)).clamp(-big, big).to(torch.int32).clamp(0, H_l - 1)
        return img_l[cv.long(), cu.long()].to(torch.bfloat16).float()

    maxd = torch.where(footprint <= 2.0 ** (lvl_a + 1),
                       sample(coarse[lvl_a], lvl_a),
                       torch.where(footprint <= 2.0 ** (lvl_b + 1),
                                   sample(coarse[lvl_b], lvl_b), global_max))

    margin = truncation_m + bs * float(np.sqrt(3.0) / 2.0)
    touched = (in_view & (z <= max_distance_m + bs)
               & (z <= maxd + margin) & (maxd > 0.0))
    # Blocks at the camera origin are always touched.
    near_camera = norm3(centers - cam_origin) < 1.5 * bs
    touched = touched | near_camera
    return touched.reshape(G, G, G), origin_block


def _max_pool_same(img, window, stride):
    """2-D max pool with XLA's "SAME" padding: the output has ceil(n /
    stride) cells per axis, the input is padded with -inf by
    (out - 1) * stride + window - n, the smaller half before it."""
    pads = []
    for n, k, s in zip(img.shape, window, stride):
        out = -(-n // s)
        pad = max((out - 1) * s + k - n, 0)
        pads.append((pad // 2, pad - pad // 2))
    (t, b), (left, right) = pads
    x = F.pad(img[None, None], (left, right, t, b), value=float("-inf"))
    return F.max_pool2d(x, window, stride=stride)[0, 0]


@torch.no_grad()
def touched_block_grid_lidar(range_image, T_L_S, *, lidar,
                             voxel_size_m: float, max_distance_m: float,
                             truncation_m: float):
    """Mark the blocks touched by a lidar range image (the camera test
    with the spherical model).

    The grid is centred on the sensor. Each cell's block center is tested
    against the maximum valid range over its angular footprint, sampled
    from two coarse max images ((8, 32) and (32, 128) pixel cells, each
    widened by a centred 3x3 max). The pooling pads both ends as the
    reference's "SAME" windows do, while the sample index int(u / cell)
    counts cells from column 0, so at 1800 columns the first cell of the
    (8, 32) level holds columns 0-19: the reference's offset, kept.
    Returns (grid bool[G,G,G], origin_block i32[3]); nothing is read back.
    """
    bs = block_size_m(voxel_size_m)
    R = _grid_radius_blocks(max_distance_m, voxel_size_m)
    G = 2 * R + 1
    rows, cols = range_image.shape

    origin = T_L_S[:3, 3]
    origin_block = torch.floor(origin * recip32(bs)).to(torch.int32) - R

    r_valid = torch.where(torch.isfinite(range_image) & (range_image > 0.0),
                          range_image, torch.zeros_like(range_image))
    lvl_a, lvl_b = (8, 32), (32, 128)
    coarse = {lvl: _max_pool_same(_max_pool_same(r_valid, lvl, lvl), (3, 3),
                                  (1, 1))
              for lvl in (lvl_a, lvl_b)}
    global_max = torch.amax(r_valid)

    centers = ((_cell_iota(G, range_image.device).float()
                + origin_block.float() + 0.5) * bs).reshape(-1, 3)
    p_S = Transform.apply(Transform.inverse(T_L_S), centers)
    uv, r, valid = lidar.project(p_S)
    u, v = uv[..., 0], uv[..., 1]

    # Angular footprint of a block at range r, in pixels.
    ang = bs / torch.clamp_min(r, 1e-6)
    fp_u = ang * (cols / (2.0 * np.pi))
    fp_v = ang * ((lidar.num_elevation_divisions - 1)
                  / max(lidar.elevation_range_rad, 1e-6))

    def sample(lvl):
        # The reference samples through a bfloat16 one-hot product.
        img_l = coarse[lvl]
        H_l, W_l = img_l.shape
        big = float(2 ** 30)
        cu = (u / lvl[1]).clamp(-big, big).to(torch.int32).clamp(0, W_l - 1)
        cv = (v / lvl[0]).clamp(-big, big).to(torch.int32).clamp(0, H_l - 1)
        return img_l[cv.long(), cu.long()].to(torch.bfloat16).float()

    fits_a = (fp_v <= 2.0 * lvl_a[0]) & (fp_u <= 2.0 * lvl_a[1])
    fits_b = (fp_v <= 2.0 * lvl_b[0]) & (fp_u <= 2.0 * lvl_b[1])
    maxr = torch.where(fits_a, sample(lvl_a),
                       torch.where(fits_b, sample(lvl_b), global_max))

    margin = truncation_m + bs * float(np.sqrt(3.0) / 2.0)
    touched = (valid & (r <= max_distance_m + bs)
               & (r <= maxr + margin) & (maxr > 0.0))
    near_sensor = norm3(centers - origin) < 1.5 * bs
    return (touched | near_sensor).reshape(G, G, G), origin_block


def apply_workspace_bounds_to_grid(grid, origin_block, *, voxel_size_m: float,
                                   params: ViewCalculatorParams):
    """Mask a touched-block grid by the configured workspace bounds: blocks
    not intersecting the workspace are never allocated or integrated."""
    if params.workspace_bounds_type == WorkspaceBoundsType.UNBOUNDED:
        return grid
    bs = block_size_m(voxel_size_m)
    cells = _cell_iota(grid.shape[0], grid.device).to(torch.int32) \
        + origin_block
    lo_m = cells.float() * bs
    hi_m = lo_m + bs
    # float32 bounds as Python scalars: no host->device copy per frame.
    w_lo = [float(np.float32(c)) for c in params.workspace_bounds_min_corner_m]
    w_hi = [float(np.float32(c)) for c in params.workspace_bounds_max_corner_m]
    axes = ((2,) if params.workspace_bounds_type
            == WorkspaceBoundsType.HEIGHT_BOUNDS else (0, 1, 2))
    keep = grid
    for a in axes:
        keep = keep & (hi_m[..., a] > w_lo[a]) & (lo_m[..., a] < w_hi[a])
    return keep


def frustum_block_aabb(T_L_C_np: np.ndarray, camera: Camera,
                       max_distance_m: float, voxel_size_m: float,
                       margin_blocks: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side conservative block AABB of a view (covers
    touched_block_grid), from the host pose alone — no device sync."""
    bs = block_size_m(voxel_size_m)
    T = np.asarray(T_L_C_np, np.float64)
    us = np.array([0.0, camera.width - 1.0])
    vs = np.array([0.0, camera.height - 1.0])
    corners = [T[:3, 3]]
    for u in us:
        for v in vs:
            ray = np.array([(u - camera.cx) / camera.fx,
                            (v - camera.cy) / camera.fy, 1.0])
            ray_l = T[:3, :3] @ ray
            corners.append(T[:3, 3] + ray_l * max_distance_m)
    corners = np.asarray(corners)
    lo = np.floor(corners.min(axis=0) / bs).astype(np.int64) - margin_blocks
    hi = np.floor(corners.max(axis=0) / bs).astype(np.int64) + margin_blocks
    return lo, hi
