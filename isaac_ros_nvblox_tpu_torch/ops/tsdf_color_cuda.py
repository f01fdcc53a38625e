"""Fused TSDF + color fusion on the card: wrapper of the `tsdf_color_fuse`
CUDA kernel (`csrc/tsdf_color_fuse.cu`), the port's counterpart of
ops/tsdf_color_pallas.py.

`integrate_tsdf_color_cuda` launches the kernel for CUDA tensors and uses
the plain PyTorch version (`ops/color.py::integrate_tsdf_color`) for CPU
tensors. A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.color import integrate_tsdf_color
from isaac_ros_nvblox_tpu_torch.ops.color_cuda import COLOR_DTYPES, F32, I32
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (MODE_CODE,
                                                 TsdfIntegratorParams,
                                                 tsdf_scalars)


@torch.no_grad()
def integrate_tsdf_color_cuda(distance, weight, color_r, color_g, color_b,
                              color_weight, slots, block_indices, depth,
                              color_image, T_L_C, *, camera: Camera,
                              voxel_size_m: float,
                              params: TsdfIntegratorParams):
    """Fuse one aligned RGB-D frame into the TSDF and color rows `slots`,
    in place. Same contract as `ops/color.py::integrate_tsdf_color`: six
    channels `f32[cap, 512]`, slots `i32[N]`, block_indices `i32[N, 3]`,
    depth `f32[H, W]`, color `u8/f32[H, W, 3]`, T_L_C `f32[4, 4]`."""
    chans = (distance, weight, color_r, color_g, color_b, color_weight)
    if distance.device.type == "cpu":
        return integrate_tsdf_color(
            *chans, slots, block_indices, depth, color_image, T_L_C,
            camera=camera, voxel_size_m=voxel_size_m, params=params)
    what = "integrate_tsdf_color_cuda"
    dev = distance.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    cap = distance.shape[0]
    n = slots.shape[0]
    H, W = camera.height, camera.width
    if (any(t.shape != (cap, 512) for t in chans) or slots.dim() != 1
            or block_indices.shape != (n, 3) or depth.shape != (H, W)
            or color_image.shape != (H, W, 3) or T_L_C.shape != (4, 4)):
        raise ValueError(f"{what}: channels f32[cap, 512], slots i32[N], "
                         "block_indices i32[N, 3], aligned depth [H, W] and "
                         "color [H, W, 3], T_L_C [4, 4]")
    kernels.check_tensors(
        what, dev, [(f"channel {i}", t, F32) for i, t in enumerate(chans)]
        + [("slots", slots, I32), ("block_indices", block_indices, I32),
           ("depth", depth, F32), ("color_image", color_image, COLOR_DTYPES),
           ("T_L_C", T_L_C, F32)])
    scalars = tsdf_scalars(camera, voxel_size_m, params)
    lib = kernels.library("tsdf_color_fuse")
    err = lib.tsdf_color_fuse(
        kernels.pointer_array(chans), slots.data_ptr(),
        block_indices.data_ptr(), depth.data_ptr(), color_image.data_ptr(),
        int(color_image.dtype == torch.uint8), T_L_C.data_ptr(),
        scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, cap, H, W,
        MODE_CODE[params.weighting_mode], kernels.stream_handle(distance))
    kernels.LAUNCHES["tsdf_color_fuse"] += 1
    kernels.check("tsdf_color_fuse", err, "tsdf_color_fuse launch")
    return chans
