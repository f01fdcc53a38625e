"""Color fusion on the card: wrapper of the `color_fuse` CUDA kernel
(`csrc/color_fuse.cu`), the port's counterpart of ops/color_pallas.py.

`integrate_color_cuda` launches the kernel for CUDA tensors and uses the
plain PyTorch version (`ops/color.py::integrate_color_planar`) for CPU
tensors. A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.color import integrate_color_planar
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (MODE_CODE,
                                                 TsdfIntegratorParams,
                                                 tsdf_scalars)

F32 = (torch.float32,)
I32 = (torch.int32,)
COLOR_DTYPES = (torch.uint8, torch.float32)


@torch.no_grad()
def integrate_color_cuda(color_r, color_g, color_b, color_weight,
                         tsdf_distance, tsdf_weight, slots, block_indices,
                         color_image, depth, T_L_C, *, camera: Camera,
                         voxel_size_m: float, params: TsdfIntegratorParams):
    """Fuse one color frame into the planar color rows `slots`, in place.

    Same contract as `ops/color.py::integrate_color_planar`: channels
    `f32[cap, 512]`, slots `i32[N]`, block_indices `i32[N, 3]`, color
    `u8/f32[H, W, 3]`, occlusion depth `f32[Hd, Wd]` (all zero: no
    occlusion test), T_L_C `f32[4, 4]`.
    """
    chans = (color_r, color_g, color_b, color_weight)
    if color_r.device.type == "cpu":
        return integrate_color_planar(
            *chans, tsdf_distance, tsdf_weight, slots, block_indices,
            color_image, depth, T_L_C, camera=camera,
            voxel_size_m=voxel_size_m, params=params)
    what = "integrate_color_cuda"
    dev = color_r.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    cap = color_r.shape[0]
    n = slots.shape[0]
    for t in chans + (tsdf_distance, tsdf_weight):
        if t.shape != (cap, 512):
            raise ValueError(f"{what}: pool channels must be f32[cap, 512]")
    H, W = camera.height, camera.width
    if (slots.dim() != 1 or block_indices.shape != (n, 3)
            or color_image.shape != (H, W, 3) or depth.dim() != 2
            or T_L_C.shape != (4, 4)):
        raise ValueError(f"{what}: slots i32[N], block_indices i32[N, 3], "
                         "color [H, W, 3], depth [Hd, Wd], T_L_C [4, 4]")
    kernels.check_tensors(what, dev, [
        ("color_r", color_r, F32), ("color_g", color_g, F32),
        ("color_b", color_b, F32), ("color_weight", color_weight, F32),
        ("tsdf_distance", tsdf_distance, F32),
        ("tsdf_weight", tsdf_weight, F32), ("slots", slots, I32),
        ("block_indices", block_indices, I32),
        ("color_image", color_image, COLOR_DTYPES), ("depth", depth, F32),
        ("T_L_C", T_L_C, F32)])
    Hd, Wd = depth.shape
    scale = float(np.float32(Hd) / np.float32(H))
    # Whether the occlusion test applies, decided on the device.
    has_depth = torch.any(depth > 0.0).to(torch.uint8)
    scalars = tsdf_scalars(camera, voxel_size_m, params)
    lib = kernels.library("color_fuse")
    err = lib.color_fuse(
        kernels.pointer_array(chans), tsdf_distance.data_ptr(),
        tsdf_weight.data_ptr(), slots.data_ptr(), block_indices.data_ptr(),
        color_image.data_ptr(), int(color_image.dtype == torch.uint8),
        depth.data_ptr(),
        T_L_C.data_ptr(), has_depth.data_ptr(),
        scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, cap, H, W,
        Hd, Wd, scale, MODE_CODE[params.weighting_mode],
        kernels.stream_handle(color_r))
    kernels.LAUNCHES["color_fuse"] += 1
    kernels.check("color_fuse", err, "color_fuse launch")
    return chans
