"""Dynamic-pixel detection, plain PyTorch version (port of
isaac_ros_nvblox_tpu/mapper/multi_mapper.py::_detect_dynamic_fused).

A depth pixel is dynamic when its back-projected endpoint lands in a voxel
of high-confidence freespace: the voxel was free for long enough, so
whatever the pixel sees now has moved in. `detect_dynamic_plain` is the
reference's exact per-pixel lookup; ops/detect_cuda.py::detect_dynamic
computes it with kernel `detect_dynamic` (`csrc/detect_dynamic.cu`) on the
card. Both follow the reference's float32 steps on XLA's CPU backend
(core/types.py): the divisions by the focal lengths and by the voxel size
are products with float32 reciprocals, the transform accumulates as
`Transform.apply` does.
"""

from __future__ import annotations

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (VOXELS_PER_SIDE, Transform,
                                                   recip32)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera

B = VOXELS_PER_SIDE
# Voxel coordinates are clamped to +-2^30 before the integer conversion
# (NaN and far-out points stay defined); any such voxel lies outside every
# world grid.
_BIG = float(2 ** 30)


def detection_scalars(camera: Camera, voxel_size_m: float,
                      max_depth_m: float) -> np.ndarray:
    """The float32 constants of the detection, in the order the CUDA
    kernel reads them: fx, fy, cx, cy, 1/fx, 1/fy, 1/voxel, max depth."""
    return np.asarray([camera.fx, camera.fy, camera.cx, camera.cy,
                       recip32(camera.fx), recip32(camera.fy),
                       recip32(voxel_size_m), max_depth_m], np.float32)


@torch.no_grad()
def detect_dynamic_plain(state, high_confidence, depth, T_L_C, *,
                         camera: Camera, voxel_size_m: float,
                         max_depth_m: float, subsample: int = 1):
    """Dynamic-pixel mask: depth pixels whose endpoint lands in a
    high-confidence freespace voxel (slot_grid lookup on the device).

    state: the static mapper's WorldGridState; high_confidence bool[cap,
    512]; depth f32[H, W]; T_L_C f32[4, 4]. `subsample` > 1 evaluates the
    pixels (v, u) with v and u multiples of it and repeats each result over
    its subsample x subsample tile. Returns (mask bool[H, W], p_L
    f32[Hs*Ws, 3], the evaluated endpoints in the layer frame).
    """
    cap = high_confidence.shape[0]
    H, W = depth.shape
    s = int(subsample)
    d_s = depth[::s, ::s] if s > 1 else depth
    Hs, Ws = d_s.shape
    dev = depth.device
    uu = torch.arange(Ws, dtype=torch.float32, device=dev)[None, :] * s
    vv = torch.arange(Hs, dtype=torch.float32, device=dev)[:, None] * s
    x = (uu - camera.cx) * recip32(camera.fx) * d_s
    y = (vv - camera.cy) * recip32(camera.fy) * d_s
    p_L = Transform.apply(T_L_C, torch.stack([x, y, d_s], -1).reshape(-1, 3))
    gvox = torch.floor(p_L * recip32(voxel_size_m)).clamp(-_BIG, _BIG).to(
        torch.int32)
    b = torch.div(gvox, B, rounding_mode="floor")
    cell = b - state.origin_block[None, :]
    dims = state.slot_grid.shape
    in_b = torch.ones(cell.shape[0], dtype=torch.bool, device=dev)
    safe = []
    for a in range(3):
        in_b &= (cell[:, a] >= 0) & (cell[:, a] < dims[a])
        safe.append(cell[:, a].clamp(0, dims[a] - 1).long())
    slot = state.slot_grid[safe[0], safe[1], safe[2]]
    l = gvox - b * B
    vox = (l[:, 0] * B + l[:, 1]) * B + l[:, 2]
    hc = high_confidence[slot.clamp(0, cap - 1).long(), vox.long()]
    d = d_s.reshape(-1)
    ok = in_b & (slot >= 0) & (d > 0) & (d <= max_depth_m)
    mask = (hc & ok).reshape(Hs, Ws)
    if s > 1:
        mask = mask.repeat_interleave(s, 0).repeat_interleave(s, 1)[:H, :W]
    return mask, p_L
