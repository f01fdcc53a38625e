"""Port vs reference: the ground-plane estimator (CPU).

Candidate extraction is exact: bit-equal to the reference on the same
halo grids. RANSAC takes its hypothesis draws as an input, so that the
reference's draws can be fed to the port; the least-squares refit then
agrees to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper.params import MapperParams as JParams
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import ground_plane as jgp
from isaac_ros_nvblox_tpu.ops.halo import gather_halo
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams as TParams
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.ops import ground_plane as tgp

torch.set_num_threads(2)

CAM = dict(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
WORLD = dict(dims=(48, 48, 24), capacity=2048, origin_block=(-24, -24, -6))
VOXEL = 0.05


@pytest.fixture(scope="module")
def floor():
    """tests/test_multi_mapper.py:98-116: a floor plane at z = 0 seen from
    above by two views, integrated by the reference; its halo grids and
    candidates."""
    jcam = jc.Camera(**CAM)
    scene = js.Scene(primitives=(js.Plane(normal=(0, 0, 1), offset=0.0),))
    m = jdm.DeviceMapper(VOXEL, params=JParams(),
                         world=jwg.WorldGridConfig(**WORLD),
                         enable_color=False, max_blocks_per_frame=2048)
    frames = []
    for k in range(2):
        T = js.orbit_pose(0.3 * k, radius=1.5, height=1.2, target=(0.5, 0, 0))
        depth = np.array(js.render_depth(scene, jcam, jnp.asarray(T)))
        m.integrate_depth(depth, T, jcam)
        frames.append((depth, T))
    cap = WORLD["capacity"]
    nbrs = jwg.neighbor_slots_of(m.state, m.state.block_index_of_slot)
    pads = [np.array(gather_halo(m.channels[k].reshape(cap, 8, 8, 8), nbrs,
                                 lo=0, hi=1, fill=0.0))
            for k in ("tsdf_distance", "tsdf_weight")]
    bidx = np.array(m.state.block_index_of_slot)
    live = np.array(jwg.live_slot_mask(m.state))
    return frames, pads, bidx, live


def test_candidates_match_reference(floor):
    _, (d_pad, w_pad), bidx, live = floor
    p = jgp.GroundPlaneEstimatorParams()
    kw = dict(voxel_size_m=VOXEL, min_z_m=p.ground_points_candidates_min_z_m,
              max_z_m=p.ground_points_candidates_max_z_m)
    want = jgp.tsdf_zero_crossings_ground_candidates(
        jnp.asarray(d_pad), jnp.asarray(w_pad), jnp.asarray(bidx),
        jnp.asarray(live), **kw)
    got = tgp.tsdf_zero_crossings_ground_candidates(
        torch.from_numpy(d_pad), torch.from_numpy(w_pad),
        torch.from_numpy(bidx), torch.from_numpy(live), **kw)
    assert np.asarray(want[1]).sum() > 1000
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ransac_with_reference_draws_matches(floor):
    _, (d_pad, w_pad), bidx, live = floor
    p = jgp.GroundPlaneEstimatorParams()
    pts, valid = jgp.tsdf_zero_crossings_ground_candidates(
        jnp.asarray(d_pad), jnp.asarray(w_pad), jnp.asarray(bidx),
        jnp.asarray(live), voxel_size_m=VOXEL,
        min_z_m=p.ground_points_candidates_min_z_m,
        max_z_m=p.ground_points_candidates_max_z_m)
    pts, valid = pts.reshape(-1, 3), valid.reshape(-1)
    key = jax.random.PRNGKey(7)
    coeffs, inliers, ok = jgp.ransac_plane_fit(pts, valid, key, params=p)
    # The reference's raw draws (ops/ground_plane.py::ransac_plane_fit).
    draw = jax.random.randint(key, (p.num_ransac_iterations, 3), 0,
                              min(pts.shape[0], 16384))
    tp = tgp.GroundPlaneEstimatorParams()
    c_t, n_t, ok_t = tgp.ransac_plane_fit(
        torch.from_numpy(np.array(pts)), torch.from_numpy(np.array(valid)),
        params=tp, draw=torch.from_numpy(np.array(draw)))
    assert bool(ok) and bool(ok_t)
    assert int(n_t) == int(inliers) > 1000
    np.testing.assert_allclose(c_t.numpy(), np.asarray(coeffs), rtol=0,
                               atol=1e-5)


def test_estimate_device_finds_the_floor(floor):
    """The bounds of tests/test_multi_mapper.py:98-116 through the port's
    DeviceMapper and GroundPlaneEstimator.estimate_device."""
    frames = floor[0]
    m = tdm.DeviceMapper(VOXEL, params=TParams(),
                         world=twg.WorldGridConfig(**WORLD),
                         enable_color=False, max_blocks_per_frame=2048,
                         device="cpu")
    for depth, T in frames:
        m.integrate_depth(depth, T, tc.Camera(**CAM))
    est = tgp.GroundPlaneEstimator()
    plane = est.estimate_device(m)
    assert plane is not None and est.last_plane is plane
    assert abs(plane.height_at(0.5, 0.0)) < 0.08
    assert plane.normal()[2] > 0.95
    # No TSDF, no plane.
    occ = tdm.DeviceMapper(VOXEL, world=twg.WorldGridConfig(**WORLD),
                           projective_layer=tdm.ProjectiveLayerType.OCCUPANCY,
                           device="cpu")
    assert est.estimate_device(occ) is None


# ------------------------------------------- the host-table Mapper backend
@pytest.fixture(scope="module")
def host_floor(tmp_path_factory):
    """tests/test_multi_mapper.py:98-116 on the reference's host-table
    Mapper (a floor at z = 0, two views from above), saved as a map file
    and loaded into the port's Mapper (the files cross-load)."""
    from isaac_ros_nvblox_tpu.io import serialization as jser
    from isaac_ros_nvblox_tpu.mapper.mapper import Mapper as JMapper
    from isaac_ros_nvblox_tpu_torch.io import serialization as tser
    from isaac_ros_nvblox_tpu_torch.mapper.mapper import Mapper as TMapper
    jcam = jc.Camera(**CAM)
    scene = js.Scene(primitives=(js.Plane(normal=(0, 0, 1), offset=0.0),))
    jm = JMapper(voxel_size_m=VOXEL, capacity=4096, enable_color=False,
                 enable_esdf=False)
    for k in range(2):
        T = js.orbit_pose(0.3 * k, radius=1.5, height=1.2, target=(0.5, 0, 0))
        jm.integrate_depth(js.render_depth(scene, jcam, jnp.asarray(T)), T,
                           jcam)
    path = tmp_path_factory.mktemp("floor") / "floor.nvblx"
    jser.save_map(jm, path)
    tm = TMapper(voxel_size_m=VOXEL, capacity=4096, enable_color=False,
                 enable_esdf=False, device="cpu")
    assert tser.load_map(tm, path) == jm.table.num_allocated > 50
    return jm, tm


def test_estimate_on_host_mapper_finds_the_floor():
    """tests/test_multi_mapper.py:98-116 through the port's host-table
    Mapper and GroundPlaneEstimator.estimate: height within 0.08 m at
    (0.5, 0), normal z > 0.95."""
    from isaac_ros_nvblox_tpu_torch.mapper.mapper import Mapper as TMapper
    from isaac_ros_nvblox_tpu_torch.models import scene as ts
    tcam = tc.Camera(**CAM)
    scene = ts.Scene(primitives=(ts.Plane(normal=(0, 0, 1), offset=0.0),))
    m = TMapper(voxel_size_m=VOXEL, capacity=4096, enable_color=False,
                enable_esdf=False, device="cpu")
    for k in range(2):
        T = ts.orbit_pose(0.3 * k, radius=1.5, height=1.2, target=(0.5, 0, 0))
        m.integrate_depth(ts.render_depth(scene, tcam, torch.from_numpy(T),
                                          device="cpu"), T, tcam)
    est = tgp.GroundPlaneEstimator()
    plane = est.estimate(m)
    assert plane is not None and est.last_plane is plane
    assert abs(plane.height_at(0.5, 0.0)) < 0.08
    assert plane.normal()[2] > 0.95
    assert est.last_candidates.shape[1] == 3
    assert len(est.last_candidates) > 1000
    # No blocks or no TSDF: no plane.
    assert tgp.GroundPlaneEstimator().estimate(TMapper(
        voxel_size_m=VOXEL, capacity=64, enable_color=False,
        device="cpu")) is None
    occ = TMapper(voxel_size_m=VOXEL, capacity=64, device="cpu",
                  projective_layer=tdm.ProjectiveLayerType.OCCUPANCY)
    assert tgp.GroundPlaneEstimator().estimate(occ) is None


def test_estimate_on_host_mapper_matches_reference(host_floor, monkeypatch):
    """On one map (the reference's, loaded into the port): the valid
    candidates equal the reference's exactly; with the reference's own
    draws (its estimator's first split of PRNGKey(0)) the plane agrees
    within 1e-5."""
    jm, tm = host_floor
    jest = jgp.GroundPlaneEstimator()
    jplane = jest.estimate(jm)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    n = len(tm.table.allocated_slots()) * 64
    draw = np.array(jax.random.randint(
        sub, (jest.params.num_ransac_iterations, 3), 0, min(n, 16384)))
    fit = tgp.ransac_plane_fit
    monkeypatch.setattr(tgp, "ransac_plane_fit", lambda *a, **kw: fit(
        *a, **{**kw, "draw": torch.from_numpy(draw)}))
    test = tgp.GroundPlaneEstimator()
    plane = test.estimate(tm)
    assert jplane is not None and plane is not None
    assert len(test.last_candidates) > 1000
    np.testing.assert_array_equal(test.last_candidates, jest.last_candidates)
    np.testing.assert_allclose([plane.a, plane.b, plane.c],
                               [jplane.a, jplane.b, jplane.c], rtol=0,
                               atol=1e-5)
