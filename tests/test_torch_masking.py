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


def _disk(mask, cy, cx, r):
    yy, xx = np.mgrid[:mask.shape[0], :mask.shape[1]]
    mask[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1


def _filter_case(name):
    """(mask u8[H, W], threshold) of an exact-filter case."""
    m = np.zeros((240, 320), np.uint8)
    if name == "wide":
        # One component 300 px wide and a diagonal line (8-connected only),
        # both far wider than the old filter's 192-pixel propagation.
        m[100:104, 10:310] = 1
        for i in range(200):
            m[20 + i // 2, 40 + i] = 1
        return m, 1000
    if name == "under":
        _disk(m, 60, 60, 25)             # 1961 pixels: dropped at 1962
        _disk(m, 160, 200, 30)
        return m, int(m[:120, :120].sum()) + 1
    if name == "over":
        _disk(m, 60, 60, 25)             # kept at exactly its size
        _disk(m, 180, 250, 12)           # dropped
        return m, int(m[:120, :120].sum())
    if name == "touching":
        # Two disks that meet only at a corner pixel: one component.
        m[50:70, 50:70] = 1
        m[70:90, 70:90] = 1
        return m, 500
    if name == "empty":
        return m, 2000
    if name == "full":
        return np.full((240, 320), 255, np.uint8), 2000
    raise ValueError(name)


def _scipy_filter(mask, threshold):
    from scipy import ndimage
    labels, _ = ndimage.label(mask > 0, structure=np.ones((3, 3)))
    sizes = np.bincount(labels.reshape(-1))
    keep = sizes >= threshold
    keep[0] = False
    return keep[labels].astype(np.uint8)


@pytest.mark.parametrize("name", ["wide", "under", "over", "touching",
                                  "empty", "full"])
def test_exact_filter_matches_scipy(name):
    """The mapping path's filter: nvblox's 8-connected components at full
    resolution, each kept where it holds at least the threshold."""
    mask, threshold = _filter_case(name)
    got = tmask.remove_small_connected_components_exact(
        torch.from_numpy(mask), threshold)
    want = _scipy_filter(mask, threshold)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if name in ("wide", "over", "touching", "full"):
        assert want.sum() > 0
    if name == "under":
        assert want[:120, :120].sum() == 0 and want.sum() > 0


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (37, 53), (60, 80)])
def test_exact_filter_random_masks_match_scipy(shape):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    for _ in range(2):
        for p in (0.2, 0.45, 0.6):
            mask = (rng.random(shape) < p).astype(np.uint8)
            thr = int(rng.integers(1, 40))
            np.testing.assert_array_equal(
                tmask.remove_small_connected_components_exact(
                    torch.from_numpy(mask), thr).numpy(),
                _scipy_filter(mask, thr))


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
