"""Which blocks a view touches: the allocation rule of the configured
mapper (nvblox's view calculator as the TPU package's dense form of it
states it), evaluated on given blocks.

Camera: a block is touched when its centre projects into the image
widened by half its projected half-diagonal, lies no farther than the
integration distance plus a block, and no farther than the largest valid
depth over its pixel footprint plus the truncation and half a block
diagonal; that largest depth is read from the image max-pooled to 32 or
64 pixel cells (each widened by a 3 x 3 max), by the block's footprint,
or the image's maximum beyond, and rounded to bfloat16. Blocks within
1.5 blocks of the camera are always touched. Only blocks of a cube of
cells around the view (centre on the optical axis, radius enclosing the
frustum) are candidates.

Lidar: the same test in the spherical model, from range images
max-pooled to (8, 32) and (32, 128) cells with "SAME" padding, over the
cube of blocks within the integration distance of the sensor.

A frame updates only voxels of the blocks it touches. This module imports
torch and numpy only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .fusion import apply_pose, fma, inverse_pose, recip32, sqrt


def _norm3(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return sqrt(fma(z, z, fma(y, y, x * x)))


@functools.lru_cache(maxsize=None)
def camera_cube(fx, fy, cx, cy, width, height, bs: float,
                max_distance_m: float):
    """(h, R): the candidate cube's centre lies h metres along the optical
    axis, its half extent R blocks (the smallest sphere on the axis that
    holds the frustum to the integration distance plus a block, widened
    laterally, and the ball near the camera)."""
    D = max_distance_m + bs
    m = bs * math.sqrt(3.0) / 4.0
    tu = max(cx, width - 1.0 - cx) / fx
    tv = max(cy, height - 1.0 - cy) / fy
    b = 1.5 * bs
    pts = [(0.0, 0.0, -b), (b, 0.0, 0.0), (-b, 0.0, 0.0), (0.0, b, 0.0),
           (0.0, -b, 0.0)]
    for su in (-1.0, 1.0):
        for sv in (-1.0, 1.0):
            pts.append((su * (m + b), sv * (m + b), 0.0))
            pts.append((su * (D * tu + m), sv * (D * tv + m), D))
    pts = np.asarray(pts)

    def rad(h):
        return float(np.max(np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2
                                    + (pts[:, 2] - h) ** 2)))

    lo, hi = 0.0, D
    for _ in range(80):
        m1, m2 = lo + (hi - lo) / 3.0, hi - (hi - lo) / 3.0
        if rad(m1) < rad(m2):
            hi = m2
        else:
            lo = m1
    h = 0.5 * (lo + hi)
    return h, int(math.ceil(rad(h) / bs)) + 1


def _in_cube(blocks, lo_block, R: int):
    G = 2 * R + 1
    c = blocks - lo_block
    return ((c >= 0) & (c < G)).all(-1)


def _sample_bf16(img, u, v, cell_u: float, cell_v: float):
    H, W = img.shape
    big = float(2 ** 30)
    cu = (u / cell_u).clamp(-big, big).to(torch.int32).clamp(0, W - 1)
    cv = (v / cell_v).clamp(-big, big).to(torch.int32).clamp(0, H - 1)
    return img[cv.long(), cu.long()].to(torch.bfloat16).float()


def touched_by_camera(depth, T_L_C: np.ndarray, cam, blocks, *,
                      voxel_size_m: float, max_distance_m: float,
                      truncation_m: float):
    """bool[M] for global block indices `blocks` i64[M, 3] (a tensor)."""
    dev = blocks.device
    bs = voxel_size_m * 8
    h, R = camera_cube(cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                       cam.height, bs, max_distance_m)
    T = torch.as_tensor(np.asarray(T_L_C, np.float32), device=dev)
    o = T[:3, 3]
    centre = fma(T[:3, 2], h, o)
    lo_block = torch.floor(centre * recip32(bs)).to(torch.int64) - R
    d = depth.float()
    d_valid = torch.where(torch.isfinite(d) & (d > 0.0), d,
                          torch.zeros_like(d))
    coarse, img = {}, d_valid[None, None]
    for lvl in range(7):
        if lvl in (5, 6):
            coarse[lvl] = F.max_pool2d(img, 3, stride=1, padding=1)[0, 0]
        img = F.max_pool2d(img, 2, stride=2, ceil_mode=True)
    gmax = torch.amax(d_valid)
    centers = (blocks.float() + 0.5) * bs
    Ti = torch.as_tensor(inverse_pose(T_L_C), device=dev)
    p = apply_pose(Ti, centers)
    z = p[:, 2]
    eps = 1e-6
    zs = torch.where(z > eps, z, torch.ones_like(z))
    u = cam.fx * p[:, 0] / zs + cam.cx
    v = cam.fy * p[:, 1] / zs + cam.cy
    foot = max(cam.fx, cam.fy) * bs / torch.clamp_min(z, eps)
    hd = foot * float(np.sqrt(3.0) / 2.0) * 0.5
    in_view = ((z > eps) & (u >= -hd) & (u <= cam.width - 1.0 + hd)
               & (v >= -hd) & (v <= cam.height - 1.0 + hd))
    maxd = torch.where(foot <= 2.0 ** 6,
                       _sample_bf16(coarse[5], u, v, 2.0 ** 5, 2.0 ** 5),
                       torch.where(foot <= 2.0 ** 7,
                                   _sample_bf16(coarse[6], u, v, 2.0 ** 6,
                                                2.0 ** 6), gmax))
    margin = truncation_m + bs * float(np.sqrt(3.0) / 2.0)
    touched = (in_view & (z <= max_distance_m + bs) & (z <= maxd + margin)
               & (maxd > 0.0))
    near = _norm3(centers - o) < 1.5 * bs
    return (touched | near) & _in_cube(blocks, lo_block, R)


def _max_pool_same(img, window, stride):
    pads = []
    for n, k, s in zip(img.shape, window, stride):
        out = -(-n // s)
        pad = max((out - 1) * s + k - n, 0)
        pads.append((pad // 2, pad - pad // 2))
    (t, b), (left, right) = pads
    x = F.pad(img[None, None], (left, right, t, b), value=float("-inf"))
    return F.max_pool2d(x, window, stride=stride)[0, 0]


def touched_by_lidar(range_image, T_L_S: np.ndarray, lidar, blocks, *,
                     voxel_size_m: float, max_distance_m: float,
                     truncation_m: float):
    """bool[M] for global block indices `blocks` i64[M, 3] (a tensor)."""
    dev = blocks.device
    bs = voxel_size_m * 8
    R = int(math.ceil(max_distance_m / bs)) + 1
    rows, cols = range_image.shape
    T = torch.as_tensor(np.asarray(T_L_S, np.float32), device=dev)
    o = T[:3, 3]
    lo_block = torch.floor(o * recip32(bs)).to(torch.int64) - R
    r_img = range_image.float()
    r_valid = torch.where(torch.isfinite(r_img) & (r_img > 0.0), r_img,
                          torch.zeros_like(r_img))
    coarse = {lvl: _max_pool_same(_max_pool_same(r_valid, lvl, lvl), (3, 3),
                                  (1, 1)) for lvl in ((8, 32), (32, 128))}
    gmax = torch.amax(r_valid)
    centers = (blocks.float() + 0.5) * bs
    Ti = torch.as_tensor(inverse_pose(T_L_S), device=dev)
    u, v, r, valid = lidar.project(apply_pose(Ti, centers))
    ang = bs / torch.clamp_min(r, 1e-6)
    fp_u = ang * (cols / (2.0 * np.pi))
    fp_v = ang * ((lidar.rows - 1) / max(lidar.vertical_fov_rad, 1e-6))

    def sample(lvl):
        return _sample_bf16(coarse[lvl], u, v, lvl[1], lvl[0])

    fits_a = (fp_v <= 16.0) & (fp_u <= 64.0)
    fits_b = (fp_v <= 64.0) & (fp_u <= 256.0)
    maxr = torch.where(fits_a, sample((8, 32)),
                       torch.where(fits_b, sample((32, 128)), gmax))
    margin = truncation_m + bs * float(np.sqrt(3.0) / 2.0)
    touched = (valid & (r <= max_distance_m + bs) & (r <= maxr + margin)
               & (maxr > 0.0))
    near = _norm3(centers - o) < 1.5 * bs
    return (touched | near) & _in_cube(blocks, lo_block, R)
