"""Segmentation-mask preprocessing and masked depth splitting (port of
isaac_ros_nvblox_tpu/ops/masking.py).

nvblox's mask preprocessing for the human and dynamic mapping modes:
connected-component filtering of a mask (`remove_small_connected_components`
and `connected_mask_component_size_threshold`), the foreground /
background depth split and the debug overlay. The filter exists twice: on
the host through scipy, and on the device at a coarser granularity (no
host sync).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def remove_small_connected_components(mask, size_threshold: int
                                      ) -> np.ndarray:
    """Drop the mask's 4-connected components smaller than
    `size_threshold` pixels (host, scipy). Returns u8[H, W]."""
    from scipy import ndimage
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    mask = np.asarray(mask) > 0
    labels, n = ndimage.label(mask)
    if n == 0:
        return mask.astype(np.uint8)
    sizes = np.bincount(labels.reshape(-1))
    keep = sizes >= size_threshold
    keep[0] = False
    return keep[labels].astype(np.uint8)


@torch.no_grad()
def remove_small_connected_components_device(mask, size_threshold: int,
                                             downsample: int = 4,
                                             iters: int = 48
                                             ) -> torch.Tensor:
    """Small-component removal on the mask's device, without a host sync,
    at `downsample` granularity: (1) max-pool the mask `downsample`x;
    (2) `iters` rounds of 3x3 min-label propagation (8-connected; labels
    converge to each component's smallest linear index, and a component
    wider than `iters` cells stays split and is kept piecewise); (3)
    component sizes by sorting the labels and differencing run starts; (4)
    keep the components of at least size_threshold / downsample^2 cells,
    upsample and AND with the input. Returns u8[H, W].
    """
    H, W = mask.shape
    m = mask > 0
    ds = int(downsample)
    Hp, Wp = -(-H // ds) * ds, -(-W // ds) * ds
    mp = F.pad(m.float()[None, None], (0, Wp - W, 0, Hp - H))
    small = F.max_pool2d(mp, ds, stride=ds)[0, 0] > 0.5
    h, w = small.shape
    n = h * w
    dev = mask.device
    # The labels run through max_pool2d (it has no integer CUDA path) as
    # float32: they are below n = (H/ds)*(W/ds), 19 200 for a VGA mask at
    # ds = 4, far below 2^24, so float32 holds them exactly.
    big = torch.full((), float(n), device=dev)
    labels = torch.where(small, torch.arange(n, device=dev, dtype=torch.float32)
                         .reshape(h, w), big)
    for _ in range(int(iters)):
        # 3x3 minimum; out-of-image neighbours (the reference's `n` fill)
        # never win.
        prop = -F.max_pool2d(-labels[None, None], 3, stride=1, padding=1)[0, 0]
        labels = torch.where(small, prop, big)
    # Sizes by sorted run length: each element's component size is the
    # next run start minus its own run start.
    flat = labels.reshape(-1).to(torch.int32)
    s, order = torch.sort(flat, stable=True)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          s[1:] != s[:-1]])
    start_pos = torch.cummax(torch.where(is_start, idx, 0), 0).values
    nxt = torch.where(is_start, idx, n)
    nxt = torch.cat([nxt[1:], torch.full((1,), n, dtype=torch.int32,
                                         device=dev)])
    next_start = torch.flip(torch.cummin(torch.flip(nxt, [0]), 0).values,
                            [0])
    keep_sorted = (s < n) & ((next_start - start_pos) * (ds * ds)
                             >= size_threshold)
    keep = torch.zeros((n,), dtype=torch.bool, device=dev)
    keep[order] = keep_sorted
    keep = keep.reshape(h, w)
    keep_full = keep.repeat_interleave(ds, 0).repeat_interleave(ds, 1)[:H, :W]
    return (m & keep_full).to(torch.uint8)


def split_depth_by_mask(depth, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """(background depth, foreground depth): the masked (mask > 0) pixels
    are invalid (0) in the background, the others in the foreground."""
    fg = mask > 0
    zero = torch.zeros((), dtype=depth.dtype, device=depth.device)
    return torch.where(fg, zero, depth), torch.where(fg, depth, zero)


def mask_overlay(image, mask, color=(255, 0, 0), alpha=0.5) -> torch.Tensor:
    """Debug overlay `u8[H, W, 3]`: masked pixels blended with `color`."""
    img = image.to(torch.float32)
    if img.dim() == 2:
        img = torch.stack([img] * 3, dim=-1)
    c = torch.tensor(color, dtype=torch.float32).to(img.device)
    fg = (mask > 0)[..., None]
    out = torch.where(fg, img * (1 - alpha) + c * alpha, img)
    return torch.clamp(out, 0, 255).to(torch.uint8)
