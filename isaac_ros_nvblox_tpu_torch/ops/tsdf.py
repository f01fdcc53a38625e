"""Projective TSDF integrator (port of isaac_ros_nvblox_tpu/ops/tsdf.py).

`integrate_tsdf` is the plain PyTorch version of the TSDF fusion kernel
(`ops/tsdf_cuda.py`, `csrc/tsdf_fuse.cu`): per voxel of a batch of pool
rows it projects the voxel center, samples the depth image (nearest, at
full resolution), and folds `min(sdf, truncation)` into the running
average with one of the six weighting modes. It mirrors the reference's
XLA path step for step, including float32 rounding (see core/types.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (Transform, fma, recip32,
                                                   set_rows_drop,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera, sample_image_nearest


class WeightingFunctionType(enum.Enum):
    """The six weighting modes (nvblox mapper_initialization.cpp:27-51)."""
    CONSTANT = "constant"
    CONSTANT_DROPOFF = "constant_dropoff"
    INVERSE_SQUARE = "inverse_square"
    INVERSE_SQUARE_DROPOFF = "inverse_square_dropoff"
    INVERSE_SQUARE_TSDF_DISTANCE_PENALTY = "inverse_square_tsdf_distance_penalty"
    LINEAR_WITH_MAX = "linear_with_max"


# Kernel-side code of each mode (csrc/tsdf_fuse.cu, `enum Mode`).
MODE_CODE = {m: i for i, m in enumerate(WeightingFunctionType)}


@dataclasses.dataclass(frozen=True)
class TsdfIntegratorParams:
    """Projective-integrator parameters (the reference's
    projective_integrator_* names)."""
    max_integration_distance_m: float = 7.0
    truncation_distance_vox: float = 4.0
    max_weight: float = 5.0
    weighting_mode: WeightingFunctionType = (
        WeightingFunctionType.INVERSE_SQUARE_DROPOFF)

    def truncation_m(self, voxel_size_m: float) -> float:
        return self.truncation_distance_vox * voxel_size_m


def weight_constants(truncation_m: float, dropoff_epsilon_m: float):
    """float32 reciprocals of the dropoff and penalty denominators."""
    denom = max(truncation_m - dropoff_epsilon_m, 1e-6)
    return recip32(denom), recip32(max(truncation_m, 1e-6))


def compute_weight(mode: WeightingFunctionType, z, sdf, truncation_m: float,
                   dropoff_epsilon_m: float):
    """Per-sample fusion weight.

    `z` is the voxel's z-depth in the camera frame, `sdf` the unclamped
    projective signed distance (measured_depth - z). Dropoff fades the
    weight linearly to zero between `-dropoff_epsilon` and `-truncation`
    behind the surface.
    """
    r_drop, r_pen = weight_constants(truncation_m, dropoff_epsilon_m)
    one = torch.ones_like(z)
    inv_sq = 1.0 / torch.clamp_min(z * z, 1e-4)
    dropoff = torch.clamp((truncation_m + sdf) * r_drop, 0.0, 1.0)
    if mode == WeightingFunctionType.CONSTANT:
        return one
    if mode == WeightingFunctionType.CONSTANT_DROPOFF:
        return dropoff
    if mode == WeightingFunctionType.INVERSE_SQUARE:
        return inv_sq
    if mode == WeightingFunctionType.INVERSE_SQUARE_DROPOFF:
        return inv_sq * dropoff
    if mode == WeightingFunctionType.INVERSE_SQUARE_TSDF_DISTANCE_PENALTY:
        penalty = torch.clamp(fma(-torch.abs(sdf), r_pen, 1.0), 0.0, 1.0)
        return inv_sq * penalty
    if mode == WeightingFunctionType.LINEAR_WITH_MAX:
        # Constant up to 1 m, then 1/z falloff.
        return torch.minimum(one, 1.0 / torch.clamp_min(z, 1e-4))
    raise ValueError(f"unknown weighting mode {mode}")


def fuse(d_old, w_old, sdf, w_new, update, truncation_m: float,
         max_weight: float):
    """Running-average update of (distance, weight) where `update`."""
    sdf_clamped = torch.clamp_max(sdf, truncation_m)
    w_sum = w_old + w_new
    d_fused = torch.where(
        w_sum > 1e-6,
        fma(d_old, w_old, sdf_clamped * w_new) / torch.clamp_min(w_sum, 1e-6),
        d_old)
    w_fused = torch.clamp_max(w_sum, max_weight)
    return (torch.where(update, d_fused, d_old),
            torch.where(update, w_fused, w_old))


@torch.no_grad()
def integrate_tsdf(distance, weight, slots, block_indices, depth, T_L_C,
                   *, camera: Camera, voxel_size_m: float,
                   params: TsdfIntegratorParams
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one depth frame into the TSDF pool, in place.

    Args:
      distance, weight: pool channels `f32[cap, 512]`, updated in place.
      slots: `i32[N]` pool slots to update; entries outside [0, cap) are
        padding and leave the pool untouched.
      block_indices: `i32[N, 3]` block index per slot.
      depth: `f32[H, W]` z-depth image, 0 / non-finite = invalid.
      T_L_C: layer_T_camera `f32[4, 4]`.

    Returns (distance, weight), the same tensors.
    """
    cap = distance.shape[0]
    truncation = params.truncation_m(voxel_size_m)
    centers_L = voxel_centers_for_blocks(block_indices, voxel_size_m)
    T_C_L = Transform.inverse(T_L_C)
    p_C = Transform.apply(T_C_L, centers_L)  # [N, 512, 3]
    uv, in_view = camera.project(p_C)
    z = p_C[..., 2]

    measured = sample_image_nearest(depth, uv)  # [N, 512]
    depth_valid = (measured > 0.0) & torch.isfinite(measured)

    sdf = measured - z
    update = (in_view & depth_valid
              & (z <= params.max_integration_distance_m)
              & (sdf >= -truncation))
    update = update & ((slots >= 0) & (slots < cap))[:, None]

    w_new = compute_weight(params.weighting_mode, z, sdf, truncation,
                           dropoff_epsilon_m=voxel_size_m)
    w_new = torch.where(update, w_new, torch.zeros_like(w_new))

    safe = slots.clamp(0, cap - 1).long()
    d_out, w_out = fuse(distance[safe], weight[safe], sdf, w_new, update,
                        truncation, params.max_weight)
    set_rows_drop(distance, slots, d_out)
    set_rows_drop(weight, slots, w_out)
    return distance, weight


@torch.no_grad()
def integrate_tsdf_lidar(distance, weight, slots, block_indices, range_image,
                         T_L_S, *, lidar, voxel_size_m: float,
                         params: TsdfIntegratorParams
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one lidar range image `f32[rows, cols]` (spherical model), in
    place: `integrate_tsdf` with the voxel's range `r` in place of `z`,
    in the distance and in the weight. Azimuths past the last column clamp
    to it (no wrap at the +-pi seam). Same pool contract as
    `integrate_tsdf`; returns (distance, weight), the same tensors."""
    cap = distance.shape[0]
    truncation = params.truncation_m(voxel_size_m)
    centers_L = voxel_centers_for_blocks(block_indices, voxel_size_m)
    p_S = Transform.apply(Transform.inverse(T_L_S), centers_L)
    uv, r_vox, in_view = lidar.project(p_S)

    measured = sample_image_nearest(range_image, uv)
    depth_valid = (measured > 0.0) & torch.isfinite(measured)
    sdf = measured - r_vox
    update = (in_view & depth_valid
              & (r_vox <= params.max_integration_distance_m)
              & (sdf >= -truncation))
    update = update & ((slots >= 0) & (slots < cap))[:, None]

    w_new = compute_weight(params.weighting_mode, r_vox, sdf, truncation,
                           dropoff_epsilon_m=voxel_size_m)
    w_new = torch.where(update, w_new, torch.zeros_like(w_new))
    safe = slots.clamp(0, cap - 1).long()
    d_out, w_out = fuse(distance[safe], weight[safe], sdf, w_new, update,
                        truncation, params.max_weight)
    set_rows_drop(distance, slots, d_out)
    set_rows_drop(weight, slots, w_out)
    return distance, weight


def tsdf_lidar_scalars(lidar, voxel_size_m: float,
                       params: TsdfIntegratorParams) -> np.ndarray:
    """The float32 constants the lidar fusion kernel takes: the TSDF
    kernel's block (`tsdf_scalars` layout, camera entries 0) followed by
    the lidar's (`Lidar.scalars`)."""
    truncation = params.truncation_m(voxel_size_m)
    r_drop, r_pen = weight_constants(truncation, voxel_size_m)
    return np.concatenate([np.asarray(
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, voxel_size_m, truncation,
         params.max_integration_distance_m, params.max_weight, r_drop,
         r_pen], np.float32), lidar.scalars()])


def tsdf_scalars(camera: Camera, voxel_size_m: float,
                 params: TsdfIntegratorParams) -> np.ndarray:
    """The float32 constants the fusion kernel takes, rounded as the plain
    version rounds them."""
    truncation = params.truncation_m(voxel_size_m)
    r_drop, r_pen = weight_constants(truncation, voxel_size_m)
    return np.asarray(
        [camera.fx, camera.fy, camera.cx, camera.cy,
         camera.width - 1.0, camera.height - 1.0, voxel_size_m, truncation,
         params.max_integration_distance_m, params.max_weight, r_drop,
         r_pen], np.float32)
