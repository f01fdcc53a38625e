"""Projective color integrator (port of isaac_ros_nvblox_tpu/ops/color.py).

`integrate_color_planar` is the plain PyTorch version of the color fusion
kernel (`ops/color_cuda.py`, `csrc/color_fuse.cu`): per voxel of a batch of
pool rows it projects the voxel center, and where the voxel is observed near
the surface (w > 1e-6, |d| <= truncation), in range, in view and not
occluded by the depth frame, it folds the nearest color sample into the
running average with the weight `compute_weight` gives at sdf = 0.

`integrate_tsdf_color` is the plain version of the fused TSDF + color kernel
(`ops/tsdf_color_cuda.py`, `csrc/tsdf_color_fuse.cu`): the TSDF fusion of
ops/tsdf.py, then the same color step on the rows it has just written, with
the depth frame itself as the occlusion test.

`integrate_color` is the packed form (`f32[cap, 512, 3]` colors) of the
host-table Mapper: the same voxel test, blended by a division by the
summed weight where the planar form multiplies by its reciprocal (the two
differ in the last bit). The reference computes it outside any Pallas
kernel; so does the port, on whatever device the pool lives.

All three mirror the reference's XLA path step for step, including its
float32 rounding (core/types.py).
"""

from __future__ import annotations

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (Transform, fma,
                                                   set_rows_drop,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera, sample_image_nearest
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                 compute_weight, integrate_tsdf)


def _fuse_color(color_r, color_g, color_b, color_weight, tsdf_distance,
                tsdf_weight, slots, block_indices, color_image, depth, T_L_C,
                has_depth, *, camera: Camera, voxel_size_m: float,
                params: TsdfIntegratorParams):
    """The color step of both plain versions. `has_depth` (bool tensor)
    switches the occlusion test on; the depth is sampled at uv * Hd / H."""
    cap = color_r.shape[0]
    truncation = params.truncation_m(voxel_size_m)
    centers_L = voxel_centers_for_blocks(block_indices, voxel_size_m)
    p_C = Transform.apply(Transform.inverse(T_L_C), centers_L)
    uv, in_view = camera.project(p_C)
    z = p_C[..., 2]

    rgb = sample_image_nearest(color_image.to(torch.float32), uv)  # [N,512,3]
    safe = slots.clamp(0, cap - 1).long()
    near_surface = ((tsdf_weight[safe] > 1e-6)
                    & (torch.abs(tsdf_distance[safe]) <= truncation))
    update = in_view & near_surface & (z <= params.max_integration_distance_m)

    scale = float(np.float32(depth.shape[0]) / np.float32(camera.height))
    measured = sample_image_nearest(depth, uv * scale)
    not_occluded = (~has_depth) | ((measured > 0.0)
                                   & (z <= measured + truncation))
    update = update & not_occluded & ((slots >= 0) & (slots < cap))[:, None]

    w_new = compute_weight(params.weighting_mode, z, torch.zeros_like(z),
                           truncation, dropoff_epsilon_m=voxel_size_m)
    w_new = torch.where(update, w_new, torch.zeros_like(w_new))
    w_old = color_weight[safe]
    w_sum = w_old + w_new
    inv = 1.0 / torch.clamp_min(w_sum, 1e-6)
    blend_ok = w_sum > 1e-6
    for ch, pool in enumerate((color_r, color_g, color_b)):
        c_old = pool[safe]
        # (c_old * w_old + rgb * w_new) * inv, contracted as XLA does.
        c_fused = torch.where(blend_ok,
                              fma(c_old, w_old, rgb[..., ch] * w_new) * inv,
                              c_old)
        set_rows_drop(pool, slots, torch.where(update, c_fused, c_old))
    w_fused = torch.clamp_max(w_sum, params.max_weight)
    set_rows_drop(color_weight, slots, torch.where(update, w_fused, w_old))
    return color_r, color_g, color_b, color_weight


@torch.no_grad()
def integrate_color_planar(color_r, color_g, color_b, color_weight,
                           tsdf_distance, tsdf_weight, slots, block_indices,
                           color_image, depth, T_L_C, *, camera: Camera,
                           voxel_size_m: float, params: TsdfIntegratorParams):
    """Fuse one color frame into planar color channels, in place.

    Args:
      color_r, color_g, color_b, color_weight: `f32[cap, 512]` (0-255
        scale), updated in place.
      tsdf_distance, tsdf_weight: TSDF channels (read only).
      slots: `i32[N]`; entries outside [0, cap) are padding.
      block_indices: `i32[N, 3]`.
      color_image: `u8/f32[H, W, 3]` at the camera's resolution.
      depth: `f32[Hd, Wd]` occlusion depth, sampled at uv * Hd / H; an
        all-zero image switches the occlusion test off.
      T_L_C: layer_T_camera `f32[4, 4]`.

    Returns the four color channels (the same tensors).
    """
    has_depth = torch.any(depth > 0.0)
    return _fuse_color(color_r, color_g, color_b, color_weight, tsdf_distance,
                       tsdf_weight, slots, block_indices, color_image, depth,
                       T_L_C, has_depth, camera=camera,
                       voxel_size_m=voxel_size_m, params=params)


@torch.no_grad()
def integrate_tsdf_color(distance, weight, color_r, color_g, color_b,
                         color_weight, slots, block_indices, depth,
                         color_image, T_L_C, *, camera: Camera,
                         voxel_size_m: float, params: TsdfIntegratorParams):
    """TSDF fusion then color fusion of one aligned RGB-D frame on one
    batch, in place: the color step reads the rows the TSDF step wrote and
    is occluded where the depth sample is invalid or the voxel lies more
    than the truncation behind it. Returns the six channels."""
    integrate_tsdf(distance, weight, slots, block_indices, depth, T_L_C,
                   camera=camera, voxel_size_m=voxel_size_m, params=params)
    _fuse_color(color_r, color_g, color_b, color_weight, distance, weight,
                slots, block_indices, color_image, depth, T_L_C,
                torch.ones((), dtype=torch.bool, device=depth.device),
                camera=camera, voxel_size_m=voxel_size_m, params=params)
    return distance, weight, color_r, color_g, color_b, color_weight


@torch.no_grad()
def integrate_color(color_rgb, color_weight, tsdf_distance, tsdf_weight,
                    slots, block_indices, color_image, depth, T_L_C, *,
                    camera: Camera, voxel_size_m: float,
                    params: TsdfIntegratorParams):
    """Fuse one color frame into packed color channels, in place.

    Args:
      color_rgb: `f32[cap, 512, 3]` (0-255 scale); color_weight
        `f32[cap, 512]`.
      tsdf_distance, tsdf_weight: TSDF channels (read only).
      slots: `i32[N]`; entries outside [0, cap) are padding.
      block_indices: `i32[N, 3]`.
      color_image: `u8/f32[H, W, 3]`.
      depth: `f32[Hd, Wd]` occlusion depth, sampled at uv * Hd / H; an
        all-zero image switches the occlusion test off.

    Returns (color_rgb, color_weight), the same tensors.
    """
    cap = color_rgb.shape[0]
    truncation = params.truncation_m(voxel_size_m)
    centers_L = voxel_centers_for_blocks(block_indices, voxel_size_m)
    p_C = Transform.apply(Transform.inverse(T_L_C), centers_L)
    uv, in_view = camera.project(p_C)
    z = p_C[..., 2]

    rgb = sample_image_nearest(color_image.to(torch.float32), uv)  # [N,512,3]
    safe = slots.clamp(0, cap - 1).long()
    near_surface = ((tsdf_weight[safe] > 1e-6)
                    & (torch.abs(tsdf_distance[safe]) <= truncation))
    update = in_view & near_surface & (z <= params.max_integration_distance_m)

    has_depth = torch.any(depth > 0.0)
    scale = float(np.float32(depth.shape[0]) / np.float32(camera.height))
    measured = sample_image_nearest(depth, uv * scale)
    not_occluded = (~has_depth) | ((measured > 0.0)
                                   & (z <= measured + truncation))
    update = update & not_occluded & ((slots >= 0) & (slots < cap))[:, None]

    w_new = compute_weight(params.weighting_mode, z, torch.zeros_like(z),
                           truncation, dropoff_epsilon_m=voxel_size_m)
    w_new = torch.where(update, w_new, torch.zeros_like(w_new))
    c_old = color_rgb[safe]
    w_old = color_weight[safe]
    w_sum = w_old + w_new
    # (c_old * w_old + rgb * w_new) / max(w_sum, 1e-6), contracted as XLA
    # does.
    c_fused = torch.where(
        (w_sum > 1e-6)[..., None],
        fma(c_old, w_old[..., None], rgb * w_new[..., None])
        / torch.clamp_min(w_sum, 1e-6)[..., None],
        c_old)
    w_fused = torch.clamp_max(w_sum, params.max_weight)
    set_rows_drop(color_rgb, slots,
                  torch.where(update[..., None], c_fused, c_old))
    set_rows_drop(color_weight, slots, torch.where(update, w_fused, w_old))
    return color_rgb, color_weight
