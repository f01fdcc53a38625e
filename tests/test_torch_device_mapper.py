"""The slice as a whole: the port's DeviceMapper against the reference
DeviceMapper on the same frames (CPU; the reference runs its XLA TSDF path
and its EDT kernels in interpret mode)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper.params import MapperParams as JParams
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops.esdf import EsdfIntegratorParams as JEsdf
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu.ops.view import ViewCalculatorParams as JView
from isaac_ros_nvblox_tpu.ops.view import WorkspaceBoundsType as JBounds
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams as TParams
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams as TEsdf
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams as TTsdf
from isaac_ros_nvblox_tpu_torch.ops.view import ViewCalculatorParams as TView
from isaac_ros_nvblox_tpu_torch.ops.view import WorkspaceBoundsType as TBounds
from test_torch_tsdf import near_rounding_tie

torch.set_num_threads(2)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
JCAM = jc.Camera(**CAM_ARGS)
TCAM = tc.Camera(**CAM_ARGS)
VOXEL = 0.05
WORLD = dict(dims=(48, 48, 24), capacity=4096, origin_block=(-24, -24, -6))
STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")
ESDF = ("esdf_sq_dist", "esdf_is_inside", "esdf_observed")


def _jax_mapper(view=None):
    params = JParams(projective=JTsdf(max_integration_distance_m=3.0),
                     esdf=JEsdf(max_esdf_distance_m=0.6))   # band 12
    if view is not None:
        params = dataclasses.replace(params, view=view)
    return jdm.DeviceMapper(VOXEL, params=params,
                            world=jwg.WorldGridConfig(**WORLD),
                            enable_color=False, enable_esdf=True,
                            max_blocks_per_frame=1024)


def _port_mapper(view=None):
    params = TParams(projective=TTsdf(max_integration_distance_m=3.0),
                     esdf=TEsdf(max_esdf_distance_m=0.6))
    if view is not None:
        params = dataclasses.replace(params, view=view)
    return tdm.DeviceMapper(VOXEL, params=params,
                            world=twg.WorldGridConfig(**WORLD),
                            max_blocks_per_frame=1024, device="cpu")


def _jax_arrays(m):
    out = {f: np.asarray(getattr(m.state, f)) for f in STATE}
    out.update({k: np.asarray(v) for k, v in m.channels.items()})
    return out


@pytest.fixture(scope="module")
def frames():
    scene = js.default_test_scene()
    out = []
    for k in range(4):
        T = js.orbit_pose(2 * np.pi * k / 8, radius=1.8)
        out.append((np.array(js.render_depth(scene, JCAM, jnp.asarray(T))), T))
    return out


@pytest.fixture(scope="module")
def reference(frames):
    """The reference mapper's arrays after 2 frames, and after 3 frames plus
    its first (full) ESDF update."""
    m = _jax_mapper()
    for depth, T in frames[:2]:
        m.integrate_depth(depth, T, JCAM)
    after2 = _jax_arrays(m)
    m.integrate_depth(*frames[2], JCAM)
    m.update_esdf()
    return after2, _jax_arrays(m)


def assert_tsdf_matches(got, want, poses, camera):
    """TSDF tolerance of test_torch_tsdf.py: atol 1e-5 on >= 99.9% of the
    observed voxels (weight > 0 on either side); the rest only where the
    voxel projects onto a pixel-rounding tie from one of `poses`. Rows
    beyond alloc_count must be untouched on both sides."""
    n = int(want["alloc_count"])
    d_g, w_g = got["tsdf_distance"], got["tsdf_weight"]
    d_w, w_w = want["tsdf_distance"], want["tsdf_weight"]
    for a in (d_g, w_g, d_w, w_w):
        assert not a[n:].any()
    bad = ((np.abs(d_g[:n] - d_w[:n]) > 1e-5)
           | (np.abs(w_g[:n] - w_w[:n]) > 1e-5))
    observed = (w_g[:n] > 0) | (w_w[:n] > 0)
    assert observed.sum() > 10000
    assert bad.sum() <= 1e-3 * observed.sum(), (bad.sum(), observed.sum())
    bidx = want["block_index_of_slot"][:n]
    ties = np.zeros((n, 512), bool)
    for T in poses:
        ties |= near_rounding_tie(bidx, T, camera)
    assert not (bad & ~ties).any(), (bad & ~ties).sum()


def _assert_map_matches(got, want, poses, esdf=True):
    for f in STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert_tsdf_matches(got, want, poses, TCAM)
    if esdf:
        for c in ESDF:   # exact: integer distances, identical sites
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def test_frames_then_esdf_match_reference(frames, reference):
    m = _port_mapper()
    for depth, T in frames[:3]:
        m.integrate_depth(depth, T, TCAM)
    m.update_esdf()
    got = m.state_arrays()
    _, want = reference
    assert int(want["alloc_count"]) > 300
    assert (got["esdf_sq_dist"] < 1e11).sum() > 10000
    _assert_map_matches(got, want, [T for _, T in frames[:3]])
    assert m.esdf_band_vox == 12


def test_state_carried_across(frames, reference):
    """Load the reference's map after 2 frames, continue on frame 3: same
    map and ESDF as the reference's own run."""
    after2, want = reference
    m = _port_mapper()
    m.load_state_arrays(after2)
    np.testing.assert_array_equal(m.state_arrays()["tsdf_distance"],
                                  after2["tsdf_distance"])
    m.integrate_depth(*frames[2], TCAM)
    m.update_esdf()
    _assert_map_matches(m.state_arrays(), want, [T for _, T in frames[:3]])


def test_masked_and_bounded_integration(frames):
    h = 1.3
    jv = JView(workspace_bounds_type=JBounds.HEIGHT_BOUNDS,
               workspace_bounds_min_corner_m=(0.0, 0.0, 0.2),
               workspace_bounds_max_corner_m=(0.0, 0.0, h))
    tv = TView(workspace_bounds_type=TBounds.HEIGHT_BOUNDS,
               workspace_bounds_min_corner_m=(0.0, 0.0, 0.2),
               workspace_bounds_max_corner_m=(0.0, 0.0, h))
    mask = np.zeros((JCAM.height, JCAM.width), np.uint8)
    mask[30:90, 40:100] = 1
    j, t = _jax_mapper(jv), _port_mapper(tv)
    for depth, T in frames[:2]:
        j.integrate_depth(depth, T, JCAM, mask=mask, mask_mode=1)
        t.integrate_depth(depth, T, TCAM, mask=mask, mask_mode=1)
    _assert_map_matches(t.state_arrays(), _jax_arrays(j),
                        [T for _, T in frames[:2]], esdf=False)


def test_incremental_esdf_equals_full(frames):
    inc, full = _port_mapper(), _port_mapper()
    for depth, T in frames:
        inc.integrate_depth(depth, T, TCAM)
        full.integrate_depth(depth, T, TCAM)
        inc.update_esdf()          # full on the first frame, then dirty AABB
    full.update_esdf(full=True)
    a, b = inc.state_arrays(), full.state_arrays()
    for c in ESDF:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)
    before = a["esdf_sq_dist"].copy()
    inc.update_esdf()              # nothing dirty: no change
    np.testing.assert_array_equal(inc.state_arrays()["esdf_sq_dist"], before)


def test_replay_equals_frame_by_frame(frames):
    depths = np.stack([d for d, _ in frames])
    poses = np.stack([T for _, T in frames])
    step = _port_mapper()
    for depth, T in frames:
        step.integrate_depth(depth, T, TCAM)
    region = step.esdf_region(margin_blocks=0, mult=1)
    sq, ins, obs = tdm._esdf_solve(
        step.state, step.channels["tsdf_distance"],
        step.channels["tsdf_weight"], torch.as_tensor(region[0]),
        dims_b=region[1], band=step.esdf_band_vox, voxel_size_m=VOXEL,
        esdf_params=step.params.esdf)
    rep = _port_mapper()
    rep.replay_frames(depths, poses, TCAM, esdf_every=2, esdf_region=region)
    got, want = rep.state_arrays(), step.state_arrays()
    for k in STATE + ("tsdf_distance", "tsdf_weight"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["esdf_sq_dist"], sq.numpy())
    np.testing.assert_array_equal(got["esdf_is_inside"], ins.numpy())
    np.testing.assert_array_equal(got["esdf_observed"], obs.numpy())
    assert not bool(rep.esdf_dirty.any())
    # The mesh cadence drains the dirty bits (tests/test_torch_mesh_mapper.py
    # holds the mesh and color cadences to the reference).
    assert bool(rep.dirty.any())
    rep.replay_frames(depths[:1], poses[:1], TCAM, mesh_every=1)
    assert not bool(rep.dirty.any())


def test_replay_slot_bucket_is_exact(frames):
    """An ESDF restricted to the pool prefix equals the whole-pool solve
    while allocation stays inside the bucket; check_slot_bucket() catches
    a bucket that allocation outgrew."""
    depths = np.stack([d for d, _ in frames])
    poses = np.stack([T for _, T in frames])
    whole, bucketed = _port_mapper(), _port_mapper()
    whole.replay_frames(depths, poses, TCAM)
    region = whole.esdf_region(margin_blocks=0, mult=1)
    n = int(whole.state.alloc_count)
    whole.replay_frames(depths, poses, TCAM, esdf_every=2, esdf_region=region)
    bucketed.replay_frames(depths, poses, TCAM)
    bucketed.replay_frames(depths, poses, TCAM, esdf_every=2,
                           esdf_region=region, slot_bucket=n + 8)
    bucketed.check_slot_bucket()
    a, b = whole.state_arrays(), bucketed.state_arrays()
    assert (a["esdf_sq_dist"] < 1e11).sum() > 10000
    for k in ESDF:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    bucketed.replay_frames(depths[:1], poses[:1], TCAM, esdf_every=1,
                           esdf_region=region, slot_bucket=n // 2)
    with pytest.raises(AssertionError, match="slot_bucket"):
        bucketed.check_slot_bucket()


def test_buckets_and_regions_match_reference():
    for n in (1, 7, 8, 9, 200, 255, 256, 257, 300, 2047, 2049, 5000):
        assert tdm._bucket(n) == jdm._bucket(n)
        assert tdm._bucket_blocks(n) == jdm._bucket_blocks(n)
        assert tdm._bucket_blocks(n, 4) == jdm._bucket_blocks(n, 4)
        assert tdm._bucket_blocks_coarse(n) == jdm._bucket_blocks_coarse(n)
