"""Image preprocessing utilities (port of
isaac_ros_nvblox_tpu/ops/image_preproc.py, numpy only): pad/crop to DNN
input sizes, semantic-label masks, sRGB gamma LUT.

Reference parity:
  * nvblox_image_padding (image_padding_cropping_node.cpp:30-80): pad or
    crop images to a segmentation network's input resolution and back.
  * semantic_label_conversion (semantic_label_converter.py:32-184): map
    ground-truth semantic label images to mono8 people masks via a LUT.
  * the sRGB undo-gamma LUT used when publishing colored voxels
    (layer_publishing.cpp:59-107).
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence, Tuple

import numpy as np


def pad_or_crop(image: np.ndarray, target_h: int, target_w: int,
                fill=0) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Center pad/crop to (target_h, target_w). Returns (image, (off_y,
    off_x)) where offsets locate the original image's top-left inside the
    output (negative when cropped)."""
    h, w = image.shape[:2]
    out_shape = (target_h, target_w) + image.shape[2:]
    out = np.full(out_shape, fill, image.dtype)
    off_y = (target_h - h) // 2
    off_x = (target_w - w) // 2
    src_y0, src_x0 = max(0, -off_y), max(0, -off_x)
    dst_y0, dst_x0 = max(0, off_y), max(0, off_x)
    copy_h = min(h - src_y0, target_h - dst_y0)
    copy_w = min(w - src_x0, target_w - dst_x0)
    out[dst_y0:dst_y0 + copy_h, dst_x0:dst_x0 + copy_w] = \
        image[src_y0:src_y0 + copy_h, src_x0:src_x0 + copy_w]
    return out, (off_y, off_x)


def uncrop(image: np.ndarray, original_h: int, original_w: int,
           offsets: Tuple[int, int]) -> np.ndarray:
    """Inverse of pad_or_crop for masks coming back from the DNN."""
    off_y, off_x = offsets
    out = np.zeros((original_h, original_w) + image.shape[2:], image.dtype)
    src_y0, src_x0 = max(0, off_y), max(0, off_x)
    dst_y0, dst_x0 = max(0, -off_y), max(0, -off_x)
    copy_h = min(image.shape[0] - src_y0, original_h - dst_y0)
    copy_w = min(image.shape[1] - src_x0, original_w - dst_x0)
    out[dst_y0:dst_y0 + copy_h, dst_x0:dst_x0 + copy_w] = \
        image[src_y0:src_y0 + copy_h, src_x0:src_x0 + copy_w]
    return out


def semantic_labels_to_mask(label_image: np.ndarray,
                            positive_labels: Sequence[int],
                            positive_value: int = 255) -> np.ndarray:
    """Label image (int) -> mono8 mask where any positive label -> 255."""
    mask = np.isin(np.asarray(label_image), np.asarray(list(positive_labels)))
    return (mask * positive_value).astype(np.uint8)


def rgb_semantic_to_mask(rgb_image: np.ndarray,
                         color_to_label: Dict[Tuple[int, int, int], int],
                         positive_labels: Sequence[int]) -> np.ndarray:
    """RGB-coded semantics (Isaac Sim style) -> mono8 people mask."""
    rgb = np.asarray(rgb_image)[..., :3]
    mask = np.zeros(rgb.shape[:2], bool)
    positives = set(positive_labels)
    for color, label in color_to_label.items():
        if label in positives:
            mask |= np.all(rgb == np.asarray(color, rgb.dtype), axis=-1)
    return (mask * 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def srgb_to_linear_lut() -> np.ndarray:
    """u8 -> u8 LUT undoing sRGB gamma (parity: layer_publishing.cpp's
    undo-gamma LUT for voxel colors)."""
    x = np.arange(256, dtype=np.float64) / 255.0
    linear = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    return np.clip(np.round(linear * 255.0), 0, 255).astype(np.uint8)


def undo_srgb_gamma(rgb_u8: np.ndarray) -> np.ndarray:
    return srgb_to_linear_lut()[np.asarray(rgb_u8)]
