"""Port vs reference: the view test (touched-block grid) and its helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import view as jv
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.ops import view as tv

torch.set_num_threads(1)

VOXEL = 0.05


def _cams(w, h, f):
    args = dict(fx=f, fy=f, cx=(w - 1) / 2, cy=(h - 1) / 2, width=w, height=h)
    return jc.Camera(**args), tc.Camera(**args)


# 160x120: the 2x2 pooling chain reaches the odd sizes 15 and 5 (ceil mode);
# 100x70 reaches 35, 9, 5 and 3.
@pytest.mark.parametrize("size", [(160, 120, 160.0), (100, 70, 90.0)])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_touched_block_grid_identical(size, k):
    jcam, tcam = _cams(*size)
    T = js.orbit_pose(2 * np.pi * k / 5 + 0.1, radius=1.5 + 0.3 * k)
    depth = np.array(js.render_depth(js.default_test_scene(), jcam,
                                     jnp.asarray(T)))
    if k == 3:
        depth[::7, ::5] = np.nan      # invalid pixels never raise the max
        depth[::11, ::3] = 0.0
    kw = dict(voxel_size_m=VOXEL, max_distance_m=5.0, truncation_m=0.2)
    g_j, o_j = jv.touched_block_grid(jnp.asarray(depth), jnp.asarray(T),
                                     camera=jcam, **kw)
    g_t, o_t = tv.touched_block_grid(torch.from_numpy(depth),
                                     torch.from_numpy(T), camera=tcam, **kw)
    assert np.asarray(g_j).sum() > 100
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    # Cell for cell: one flipped cell reorders every later slot.
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("bounds", ["height_bounds", "bounding_box",
                                    "unbounded"])
def test_workspace_bounds_identical(bounds):
    rng = np.random.RandomState(1)
    grid = rng.rand(9, 9, 9) < 0.5
    origin = np.array([-3, 2, -4], np.int32)
    kw = dict(workspace_bounds_min_corner_m=(-0.5, 0.9, -1.0),
              workspace_bounds_max_corner_m=(1.3, 2.5, 0.2))
    p_j = jv.ViewCalculatorParams(
        workspace_bounds_type=jv.WorkspaceBoundsType(bounds), **kw)
    p_t = tv.ViewCalculatorParams(
        workspace_bounds_type=tv.WorkspaceBoundsType(bounds), **kw)
    r_j = jv.apply_workspace_bounds_to_grid(
        jnp.asarray(grid), jnp.asarray(origin), voxel_size_m=VOXEL, params=p_j)
    r_t = tv.apply_workspace_bounds_to_grid(
        torch.from_numpy(grid), torch.from_numpy(origin), voxel_size_m=VOXEL,
        params=p_t)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))


def test_frustum_aabb_and_geometry():
    jcam, tcam = _cams(160, 120, 160.0)
    for k in range(3):
        T = js.orbit_pose(0.7 * k, radius=2.0)
        lo_j, hi_j = jv.frustum_block_aabb(T, jcam, 5.0, VOXEL)
        lo_t, hi_t = tv.frustum_block_aabb(T, tcam, 5.0, VOXEL)
        np.testing.assert_array_equal(lo_t, lo_j)
        np.testing.assert_array_equal(hi_t, hi_j)
    assert (tv._camera_grid_geometry(tcam, VOXEL, 5.0)
            == jv._camera_grid_geometry(jcam, VOXEL, 5.0))
    assert tv._grid_radius_blocks(5.0, VOXEL) == jv._grid_radius_blocks(
        5.0, VOXEL)
