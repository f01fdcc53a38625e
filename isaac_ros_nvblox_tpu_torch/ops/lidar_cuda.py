"""Lidar TSDF fusion on the card: wrapper of the `tsdf_lidar_fuse` CUDA
kernel (`csrc/tsdf_lidar_fuse.cu`), the port's counterpart of
ops/lidar_pallas.py.

`integrate_tsdf_lidar_cuda` launches the kernel for CUDA tensors and uses
the plain PyTorch version (`ops/tsdf.py::integrate_tsdf_lidar`) for CPU
tensors. A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (MODE_CODE,
                                                 TsdfIntegratorParams,
                                                 integrate_tsdf_lidar,
                                                 tsdf_lidar_scalars)

_F32 = (torch.float32,)
_I32 = (torch.int32,)


@torch.no_grad()
def integrate_tsdf_lidar_cuda(distance, weight, slots, block_indices,
                              range_image, T_L_S, *, lidar,
                              voxel_size_m: float,
                              params: TsdfIntegratorParams):
    """Fuse one range image into the TSDF rows `slots`, in place.

    Same contract as `ops/tsdf.py::integrate_tsdf_lidar`: distance/weight
    `f32[cap, 512]`, slots `i32[N]` (entries outside [0, cap) are
    padding), block_indices `i32[N, 3]`, range_image `f32[rows, cols]`,
    T_L_S `f32[4, 4]`.
    """
    if distance.device.type == "cpu":
        return integrate_tsdf_lidar(
            distance, weight, slots, block_indices, range_image, T_L_S,
            lidar=lidar, voxel_size_m=voxel_size_m, params=params)
    what = "integrate_tsdf_lidar_cuda"
    dev = distance.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    cap = distance.shape[0]
    n = slots.shape[0]
    E, A = lidar.num_elevation_divisions, lidar.num_azimuth_divisions
    if (distance.shape != (cap, 512) or weight.shape != (cap, 512)
            or slots.dim() != 1 or block_indices.shape != (n, 3)
            or range_image.shape != (E, A) or T_L_S.shape != (4, 4)):
        raise ValueError(f"{what}: distance/weight f32[cap, 512], slots "
                         "i32[N], block_indices i32[N, 3], range image "
                         "[rows, cols] of the lidar, T_L_S [4, 4]")
    kernels.check_tensors(what, dev, [
        ("distance", distance, _F32), ("weight", weight, _F32),
        ("slots", slots, _I32), ("block_indices", block_indices, _I32),
        ("range_image", range_image, _F32), ("T_L_S", T_L_S, _F32)])
    scalars = tsdf_lidar_scalars(lidar, voxel_size_m, params)
    lib = kernels.library("tsdf_lidar_fuse")
    err = lib.tsdf_lidar_fuse(
        distance.data_ptr(), weight.data_ptr(), slots.data_ptr(),
        block_indices.data_ptr(), range_image.data_ptr(), T_L_S.data_ptr(),
        scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, cap, E, A,
        MODE_CODE[params.weighting_mode], kernels.stream_handle(distance))
    kernels.LAUNCHES["tsdf_lidar_fuse"] += 1
    kernels.check("tsdf_lidar_fuse", err, "tsdf_lidar_fuse launch")
    return distance, weight
