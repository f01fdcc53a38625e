"""Segmentation-mask preprocessing and masked depth splitting (port of
isaac_ros_nvblox_tpu/ops/masking.py).

nvblox's mask preprocessing for the human and dynamic mapping modes:
connected-component filtering of a mask (`remove_small_connected_components`
and `connected_mask_component_size_threshold`), the foreground /
background depth split and the debug overlay.

The filter the mapping path takes is `remove_small_connected_components_
exact`: nvblox's rule (8-connected components at full resolution, those
under the threshold dropped), on the card through kernel mask_components
(`csrc/mask_components.cu`, union-find labelling; no host sync), on the
CPU through its plain version. The reference's host form stays for
parity (scipy, 4-connected); its pooled device approximation has no
counterpart here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from isaac_ros_nvblox_tpu_torch import kernels


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
def remove_small_connected_components_plain(mask, size_threshold: int
                                            ) -> torch.Tensor:
    """Plain version of kernel mask_components: each foreground pixel
    (mask > 0) takes the smallest linear index of its 8-connected
    component (3 x 3 minimum rounds, each followed by a pointer jump
    through the labels, to convergence), the components are counted and
    those of at least `size_threshold` pixels kept. Returns u8[H, W]
    (0 / 1)."""
    H, W = mask.shape
    n = H * W
    fg = mask > 0
    dev = mask.device
    big = torch.full((), n, dtype=torch.int64, device=dev)
    labels = torch.where(fg, torch.arange(n, device=dev).reshape(H, W), big)
    while True:
        p = F.pad(labels, (1, 1, 1, 1), value=n)
        m = labels
        for dy in range(3):
            for dx in range(3):
                m = torch.minimum(m, p[dy:dy + H, dx:dx + W])
        m = torch.where(fg, m, big)
        # A label is a pixel of the same component: jump to its label.
        ext = torch.cat([m.reshape(-1), big[None]])
        m = torch.where(fg, ext[m], big)
        if torch.equal(m, labels):
            break
        labels = m
    flat = labels.reshape(-1)
    sizes = torch.bincount(flat[flat < n], minlength=n)
    keep = torch.cat([sizes >= int(size_threshold),
                      torch.zeros((1,), dtype=torch.bool, device=dev)])
    return keep[flat].reshape(H, W).to(torch.uint8)


@torch.no_grad()
def remove_small_connected_components_exact(mask, size_threshold: int
                                            ) -> torch.Tensor:
    """nvblox's mask filter: the 8-connected components of `mask`
    (u8[H, W], > 0 = foreground) with fewer than `size_threshold` pixels
    dropped. Returns u8[H, W] (0 / 1) on the mask's device: on the card
    through kernel mask_components (four launches, no host sync), on the
    CPU through `remove_small_connected_components_plain`; both equal
    scipy.ndimage.label's components with a 3 x 3 structure."""
    if mask.device.type == "cpu":
        return remove_small_connected_components_plain(mask, size_threshold)
    what = "mask_components"
    if mask.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {mask.device}")
    if mask.dim() != 2:
        raise ValueError(f"{what}: mask must be u8[H, W]")
    if mask.dtype != torch.uint8:
        mask = (mask > 0).to(torch.uint8)
    mask = mask.contiguous()
    H, W = mask.shape
    out = torch.empty_like(mask)
    work = torch.empty((2, H * W), dtype=torch.int32, device=mask.device)
    lib = kernels.library(what)
    err = lib.mask_components(mask.data_ptr(), out.data_ptr(),
                              work[0].data_ptr(), work[1].data_ptr(), H, W,
                              int(size_threshold),
                              kernels.stream_handle(mask))
    kernels.LAUNCHES[what] += 1
    kernels.check(what, err, "mask_components launch")
    return out


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
