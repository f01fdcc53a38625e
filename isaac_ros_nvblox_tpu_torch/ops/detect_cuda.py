"""Dynamic-pixel detection on the card: wrapper of the `detect_dynamic` CUDA
kernel (`csrc/detect_dynamic.cu`), the port's counterpart of
ops/detect_pallas.py.

`detect_dynamic` launches the kernel for CUDA tensors and uses the plain
PyTorch version (`ops/detect.py::detect_dynamic_plain`) for CPU tensors. A
build or launch failure raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.detect import (detect_dynamic_plain,
                                                   detection_scalars)

_I32 = (torch.int32,)


@torch.no_grad()
def detect_dynamic(state, high_confidence, depth, T_L_C, *, camera: Camera,
                   voxel_size_m: float, max_depth_m: float,
                   subsample: int = 1) -> torch.Tensor:
    """The dynamic-pixel mask `u8[H, W]` (1 = dynamic) of
    `detect_dynamic_plain`, same arguments."""
    if depth.device.type == "cpu":
        mask, _ = detect_dynamic_plain(
            state, high_confidence, depth, T_L_C, camera=camera,
            voxel_size_m=voxel_size_m, max_depth_m=max_depth_m,
            subsample=subsample)
        return mask.to(torch.uint8)
    what = "detect_dynamic"
    dev = depth.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    H, W = depth.shape
    cap = high_confidence.shape[0]
    if (high_confidence.shape != (cap, 512) or T_L_C.shape != (4, 4)
            or state.slot_grid.dim() != 3 or state.origin_block.shape != (3,)
            or int(subsample) < 1):
        raise ValueError(f"{what}: high_confidence bool[cap, 512], T_L_C "
                         "[4, 4], slot_grid i32[Dx, Dy, Dz], origin i32[3], "
                         "subsample >= 1")
    kernels.check_tensors(what, dev, [
        ("high_confidence", high_confidence, (torch.bool, torch.uint8)),
        ("depth", depth, (torch.float32,)), ("T_L_C", T_L_C, (torch.float32,)),
        ("slot_grid", state.slot_grid, _I32),
        ("origin_block", state.origin_block, _I32)])
    out = torch.empty((H, W), dtype=torch.uint8, device=dev)
    scalars = detection_scalars(camera, voxel_size_m, max_depth_m)
    D = state.slot_grid.shape
    lib = kernels.library("detect_dynamic")
    err = lib.detect_dynamic(
        out.data_ptr(), depth.data_ptr(), T_L_C.data_ptr(),
        state.slot_grid.data_ptr(), state.origin_block.data_ptr(),
        high_confidence.data_ptr(),
        scalars.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), H, W,
        int(subsample), D[0], D[1], D[2], cap, kernels.stream_handle(depth))
    kernels.LAUNCHES["detect_dynamic"] += 1
    kernels.check("detect_dynamic", err, "detect_dynamic launch")
    return out
