"""Port vs reference: mask preprocessing, the depth split and the overlay
(CPU). All are exact functions of their inputs: equal to the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.ops import image_preproc as jip
from isaac_ros_nvblox_tpu.ops import masking as jmask
from isaac_ros_nvblox_tpu_torch.ops import image_preproc as tip
from isaac_ros_nvblox_tpu_torch.ops import masking as tmask

torch.set_num_threads(2)


def _mask(seed=0):
    """The mask of tests/test_detect_pallas.py:131-137: a big blob, a
    16-pixel blob and speck noise."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((120, 160), np.uint8)
    mask[30:70, 40:90] = 1
    mask[100:104, 10:14] = 1
    for _ in range(30):
        y, x = rng.integers(0, 118), rng.integers(100, 158)
        mask[y:y + 2, x:x + 2] = 1
    return mask


@pytest.mark.parametrize("threshold,downsample,iters",
                         [(400, 4, 48), (16, 2, 8), (64, 4, 3)])
def test_remove_small_components_device_matches_reference(threshold,
                                                          downsample, iters):
    mask = _mask()
    mask[5:9, 0:40] = 255            # a thin strip wider than `iters` cells
    want = np.asarray(jmask.remove_small_connected_components_device(
        jnp.asarray(mask), threshold, downsample=downsample, iters=iters))
    got = tmask.remove_small_connected_components_device(
        torch.from_numpy(mask), threshold, downsample=downsample, iters=iters)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < (mask > 0).sum()


def test_remove_small_components_host_matches_reference():
    mask = _mask(1)
    for thr in (1, 5, 400):
        np.testing.assert_array_equal(
            tmask.remove_small_connected_components(torch.from_numpy(mask),
                                                    thr),
            jmask.remove_small_connected_components(mask, thr))
    empty = np.zeros((8, 8), np.uint8)
    np.testing.assert_array_equal(
        tmask.remove_small_connected_components(empty, 3),
        jmask.remove_small_connected_components(empty, 3))


def test_split_depth_and_overlay_match_reference():
    rng = np.random.default_rng(2)
    depth = rng.uniform(0, 5, (90, 120)).astype(np.float32)
    mask = (rng.random((90, 120)) < 0.3).astype(np.uint8) * 255
    for g, w in zip(tmask.split_depth_by_mask(torch.from_numpy(depth),
                                              torch.from_numpy(mask)),
                    jmask.split_depth_by_mask(jnp.asarray(depth),
                                              jnp.asarray(mask))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    gray = np.clip(depth * 50.0, 0, 255).astype(np.float32)
    rgb = rng.integers(0, 256, (90, 120, 3)).astype(np.uint8)
    for image in (gray, rgb):
        got = tmask.mask_overlay(torch.from_numpy(image),
                                 torch.from_numpy(mask))
        want = np.asarray(jmask.mask_overlay(jnp.asarray(image),
                                             jnp.asarray(mask)))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)


def test_image_preproc_matches_reference():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (37, 50, 3)).astype(np.uint8)
    for th, tw in ((64, 64), (30, 40), (37, 51)):
        a, off_a = tip.pad_or_crop(img, th, tw)
        b, off_b = jip.pad_or_crop(img, th, tw)
        np.testing.assert_array_equal(a, b)
        assert off_a == off_b
        np.testing.assert_array_equal(tip.uncrop(a, 37, 50, off_a),
                                      jip.uncrop(b, 37, 50, off_b))
    labels = rng.integers(0, 5, (20, 30))
    np.testing.assert_array_equal(tip.semantic_labels_to_mask(labels, [1, 3]),
                                  jip.semantic_labels_to_mask(labels, [1, 3]))
    colors = {(255, 0, 0): 1, (0, 255, 0): 2}
    rgb = np.zeros((10, 10, 3), np.uint8)
    rgb[2:5, 3:7] = (255, 0, 0)
    np.testing.assert_array_equal(tip.rgb_semantic_to_mask(rgb, colors, [1]),
                                  jip.rgb_semantic_to_mask(rgb, colors, [1]))
    np.testing.assert_array_equal(tip.undo_srgb_gamma(img),
                                  jip.undo_srgb_gamma(img))
