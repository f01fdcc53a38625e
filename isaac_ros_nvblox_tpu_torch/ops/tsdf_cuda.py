"""TSDF fusion on the card: wrapper of the `tsdf_fuse` CUDA kernel
(`csrc/tsdf_fuse.cu`), the port's counterpart of ops/tsdf_pallas.py.

`integrate_tsdf_cuda` launches the kernel for CUDA tensors and uses the
plain PyTorch version (`ops/tsdf.py::integrate_tsdf`) for CPU tensors.
A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (MODE_CODE,
                                                 TsdfIntegratorParams,
                                                 integrate_tsdf, tsdf_scalars)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"integrate_tsdf_cuda: {msg}")


@torch.no_grad()
def integrate_tsdf_cuda(distance, weight, slots, block_indices, depth, T_L_C,
                        *, camera: Camera, voxel_size_m: float,
                        params: TsdfIntegratorParams
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse one depth frame into the pool rows `slots`, in place.

    Same contract as `ops/tsdf.py::integrate_tsdf`: distance/weight
    `f32[cap, 512]`, slots `i32[N]` (entries outside [0, cap) are padding),
    block_indices `i32[N, 3]`, depth `f32[H, W]`, T_L_C `f32[4, 4]`.
    """
    if distance.device.type == "cpu":
        return integrate_tsdf(distance, weight, slots, block_indices, depth,
                              T_L_C, camera=camera, voxel_size_m=voxel_size_m,
                              params=params)
    _require(distance.device.type == "cuda", f"unsupported device {distance.device}")
    cap = distance.shape[0]
    _require(distance.shape == (cap, 512) and weight.shape == (cap, 512),
             "pool channels must be f32[cap, 512]")
    for name, t, dt in (("distance", distance, torch.float32),
                        ("weight", weight, torch.float32),
                        ("slots", slots, torch.int32),
                        ("block_indices", block_indices, torch.int32),
                        ("depth", depth, torch.float32),
                        ("T_L_C", T_L_C, torch.float32)):
        _require(t.device == distance.device, f"{name} on {t.device}")
        _require(t.dtype == dt, f"{name} must be {dt}, got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    n = slots.shape[0]
    _require(slots.dim() == 1 and block_indices.shape == (n, 3),
             "slots i32[N] and block_indices i32[N, 3]")
    _require(depth.dim() == 2 and T_L_C.shape == (4, 4), "depth f32[H, W]")
    H, W = depth.shape
    _require((H, W) == (camera.height, camera.width),
             "depth shape must match the camera")

    scalars = tsdf_scalars(camera, voxel_size_m, params)
    lib = kernels.library("tsdf_fuse")
    err = lib.tsdf_fuse(
        distance.data_ptr(), weight.data_ptr(), slots.data_ptr(),
        block_indices.data_ptr(), depth.data_ptr(), T_L_C.data_ptr(),
        scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, cap, H, W,
        MODE_CODE[params.weighting_mode], kernels.stream_handle(distance))
    kernels.LAUNCHES["tsdf_fuse"] += 1
    kernels.check("tsdf_fuse", err, "tsdf_fuse launch")
    return distance, weight
