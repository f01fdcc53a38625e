"""Occupancy fusion on the card: wrapper of the `occupancy_fuse` CUDA
kernel (`csrc/occupancy_fuse.cu`), the port's counterpart of
ops/occupancy_pallas.py.

`integrate_occupancy_cuda` launches the kernel for CUDA tensors and uses
the plain PyTorch version (`ops/occupancy.py::integrate_occupancy`) for CPU
tensors. A build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.occupancy import (
    OccupancyIntegratorParams, integrate_occupancy, occupancy_scalars)

_F32 = (torch.float32,)
_I32 = (torch.int32,)


@torch.no_grad()
def integrate_occupancy_cuda(log_odds, observed, slots, block_indices, depth,
                             T_L_C, *, camera: Camera, voxel_size_m: float,
                             params: OccupancyIntegratorParams):
    """Fuse one depth frame into the occupancy rows `slots`, in place.

    Same contract as `ops/occupancy.py::integrate_occupancy`: log_odds
    `f32[cap, 512]`, observed `u8[cap, 512]`, slots `i32[N]` (entries
    outside [0, cap) are padding), block_indices `i32[N, 3]`, depth
    `f32[H, W]`, T_L_C `f32[4, 4]`.
    """
    if log_odds.device.type == "cpu":
        return integrate_occupancy(
            log_odds, observed, slots, block_indices, depth, T_L_C,
            camera=camera, voxel_size_m=voxel_size_m, params=params)
    what = "integrate_occupancy_cuda"
    dev = log_odds.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    cap = log_odds.shape[0]
    n = slots.shape[0]
    H, W = camera.height, camera.width
    if (log_odds.shape != (cap, 512) or observed.shape != (cap, 512)
            or slots.dim() != 1 or block_indices.shape != (n, 3)
            or depth.shape != (H, W) or T_L_C.shape != (4, 4)):
        raise ValueError(f"{what}: log_odds f32[cap, 512], observed "
                         "u8[cap, 512], slots i32[N], block_indices "
                         "i32[N, 3], depth [H, W] of the camera, T_L_C [4, 4]")
    kernels.check_tensors(what, dev, [
        ("log_odds", log_odds, _F32), ("observed", observed, (torch.uint8,)),
        ("slots", slots, _I32), ("block_indices", block_indices, _I32),
        ("depth", depth, _F32), ("T_L_C", T_L_C, _F32)])
    scalars = occupancy_scalars(camera, voxel_size_m, params)
    lib = kernels.library("occupancy_fuse")
    err = lib.occupancy_fuse(
        log_odds.data_ptr(), observed.data_ptr(), slots.data_ptr(),
        block_indices.data_ptr(), depth.data_ptr(), T_L_C.data_ptr(),
        scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, cap, H, W,
        kernels.stream_handle(log_odds))
    kernels.LAUNCHES["occupancy_fuse"] += 1
    kernels.check("occupancy_fuse", err, "occupancy_fuse launch")
    return log_odds, observed
