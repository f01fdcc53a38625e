"""Port vs reference: the geometry and camera helpers, the allocated-slot
batch and the MultiMapper's mapper accessors (CPU).

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in isaac_ros_nvblox_tpu_torch. Tolerances: the box test,
voxel indices, scaled cameras, intrinsics and the batch are exact;
bilinear samples and frustum corners agree within 1e-6 (float32 products
whose order XLA may choose).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import types as jt
from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import multi_mapper as jmm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu_torch.core import types as tt
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import multi_mapper as tmm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.models import camera as tc

torch.set_num_threads(1)

CAM_ARGS = dict(fx=500.0, fy=500.0, cx=319.5, cy=239.5, width=640,
                height=480)
ODD_CAM = dict(fx=173.3, fy=171.9, cx=79.7, cy=61.2, width=161, height=123)
SMALL_WORLD = dict(dims=(16, 16, 8), capacity=1024, origin_block=(-8, -8, -2))


@pytest.mark.parametrize("seed", [0, 1])
def test_aabb_and_global_voxel_index_match_reference(seed):
    rng = np.random.default_rng(seed)
    box = dict(min_m=tuple(rng.uniform(-2, 0, 3)),
               max_m=tuple(rng.uniform(0, 2, 3)))
    pts = rng.uniform(-3, 3, (4096, 3)).astype(np.float32)
    # Points on the faces count as inside.
    pts[:3] = np.float32(box["min_m"])
    pts[3:6] = np.float32(box["max_m"])
    jbox, tbox = jt.AABB(**box), tt.AABB(**box)
    got = tbox.contains(torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbox.contains(
        jnp.asarray(pts))))
    assert got[:6].all() and 0 < got.mean() < 1
    np.testing.assert_array_equal(tbox.size(), jbox.size())
    for voxel in (0.05, 0.1, 0.037):
        want = np.asarray(jt.global_voxel_index_of_position(
            jnp.asarray(pts), voxel))
        got = tt.global_voxel_index_of_position(torch.from_numpy(pts), voxel)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("args", [CAM_ARGS, ODD_CAM], ids=["vga", "odd"])
@pytest.mark.parametrize("factor", [0.5, 0.25, 1.5, 0.3])
def test_camera_scaled_matches_reference(args, factor):
    want = jc.Camera(**args).scaled(factor)
    got = tc.Camera(**args).scaled(factor)
    assert isinstance(got, tc.Camera)
    assert (got.width, got.height) == (want.width, want.height)
    for f in ("fx", "fy", "cx", "cy"):
        assert np.float32(getattr(got, f)) == np.float32(getattr(want, f)), f
    np.testing.assert_array_equal(got.intrinsics().numpy(),
                                  np.asarray(want.intrinsics()))


@pytest.mark.parametrize("args", [CAM_ARGS, ODD_CAM], ids=["vga", "odd"])
def test_camera_intrinsics_and_frustum_corners_match_reference(args):
    jcam, tcam = jc.Camera(**args), tc.Camera(**args)
    got = tcam.intrinsics()
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcam.intrinsics()))
    for max_depth in (1.0, 5.0, 7.3):
        want = np.asarray(jcam.frustum_corner_directions(max_depth))
        got = tcam.frustum_corner_directions(max_depth)
        assert got.shape == (4, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_image_bilinear_matches_reference(seed):
    rng = np.random.default_rng(seed)
    H, W = 37 + seed, 53 - seed
    image = rng.uniform(-2, 5, (H, W)).astype(np.float32)
    # In the image, on pixel centres, on the border and outside it (the
    # reference clamps to the image).
    uv = np.concatenate([
        rng.uniform(-5, max(H, W) + 5, (4096, 2)),
        np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2),
        [[0, 0], [W - 1, H - 1], [W - 1, 0], [-1e6, 1e6], [W - 1.5, H - 1]],
    ]).astype(np.float32)
    want = np.asarray(jc.sample_image_bilinear(jnp.asarray(image),
                                               jnp.asarray(uv)))
    got = tc.sample_image_bilinear(torch.from_numpy(image),
                                   torch.from_numpy(uv)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # Pixel centres sample the pixel itself.
    centres = got[4096:4096 + H * W].reshape(H, W)
    np.testing.assert_allclose(centres, image, rtol=0, atol=1e-6)


@pytest.mark.parametrize("max_blocks", [1, 5, 37, 64])
def test_allocated_batch_matches_reference(max_blocks):
    """The batch of every allocated slot, after two allocations and a free
    (freed slots stay in the batch, as in the reference), padded with the
    capacity beyond alloc_count."""
    rng = np.random.default_rng(max_blocks)
    j = jwg.create_world_grid(jwg.WorldGridConfig(**SMALL_WORLD))
    t = twg.create_world_grid(twg.WorldGridConfig(**SMALL_WORLD),
                              device="cpu")
    for _ in range(2):
        grid = rng.random((16, 16, 8)) < 0.05
        origin = np.asarray(SMALL_WORLD["origin_block"], np.int32)
        j, *_ = jwg.allocate_and_batch(j, jnp.asarray(grid),
                                       jnp.asarray(origin), max_blocks=64)
        t, *_ = twg.allocate_and_batch(t, torch.from_numpy(grid),
                                       torch.from_numpy(origin),
                                       max_blocks=64)
    j = jwg.free_slots(j, jnp.asarray([2, 3], jnp.int32))
    t = twg.free_slots(t, torch.tensor([2, 3], dtype=torch.int32))
    assert int(t.alloc_count) == int(j.alloc_count) > 40
    want = jwg.allocated_batch(j, max_blocks=max_blocks)
    got = twg.allocated_batch(t, max_blocks=max_blocks)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    slots = got[0].numpy()
    n = min(int(t.alloc_count), max_blocks)
    assert int(got[2]) == n
    np.testing.assert_array_equal(slots[:n], np.arange(n))
    assert (slots[n:] == SMALL_WORLD["capacity"]).all()


@pytest.mark.parametrize("mode", ["STATIC_TSDF", "HUMAN_WITH_STATIC_TSDF",
                                  "HUMAN_WITH_STATIC_OCCUPANCY", "DYNAMIC"])
def test_background_and_foreground_mappers_match_reference(mode):
    out = []
    for mod, mmod, dev in ((jp, jmm, {}), (tp, tmm, {"device": "cpu"})):
        mm = mmod.MultiMapper(
            mod.MultiMapperParams(mapping_type=getattr(mod.MappingType, mode),
                                  block_capacity=4096), **dev)
        assert mm.background_mapper() is mm.static_mapper
        assert mm.foreground_mapper() is mm.dynamic_mapper
        fg = mm.foreground_mapper()
        out.append((mm.background_mapper().projective_layer.value,
                    mm.background_mapper().capacity,
                    None if fg is None else (fg.projective_layer.value,
                                             fg.capacity)))
    assert out[0] == out[1]
