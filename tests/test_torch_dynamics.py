"""Port vs reference: dynamic-pixel detection (plain version of kernel
detect_dynamic), the MultiMapper's dynamic and human modes, mask
reprojection and depth preprocessing (CPU).

The detector is the reference's exact per-pixel lookup
(`_detect_dynamic_fused`), not the Pallas kernel's voxel-granular form; it
is held to that lookup pixel for pixel, and to the Pallas tests' own
quality bounds against it (tests/test_detect_pallas.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core.world_grid import WorldGridConfig as JWorld
from isaac_ros_nvblox_tpu.mapper import multi_mapper as jmm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import backproject as jbp
from isaac_ros_nvblox_tpu.ops.freespace import (
    FreespaceIntegratorParams as JFree)
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.core.world_grid import WorldGridConfig as TWorld
from isaac_ros_nvblox_tpu_torch.mapper import multi_mapper as tmm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.ops import backproject as tbp
from isaac_ros_nvblox_tpu_torch.ops.detect import detect_dynamic_plain
from isaac_ros_nvblox_tpu_torch.ops.detect_cuda import detect_dynamic
from isaac_ros_nvblox_tpu_torch.ops.freespace import (
    FreespaceIntegratorParams as TFree)
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams as TTsdf
from test_torch_occupancy import jax_mapper_arrays
from test_torch_tsdf import JCAM, TCAM

torch.set_num_threads(2)

ROOM = (js.RoomBox(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
        js.Box(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4)))


def jax_multi_arrays(mm):
    """The reference MultiMapper's two mappers as numpy arrays, keyed as
    the port's `MultiMapper.state_arrays` keys them."""
    out = {}
    for name in ("static_mapper", "dynamic_mapper"):
        m = getattr(mm, name)
        if m is None:
            continue
        arrays = {k: np.array(v) for k, v in jax_mapper_arrays(m).items()}
        if "freespace_consecutive_ms" in m.channels:
            arrays["freespace_last_update_ms"] = np.float32(
                m._freespace_last_update_ms)
        out.update({f"{name}/{k}": v for k, v in arrays.items()})
    return out


def _dynamic_params(mod, free_ms=None, **kw):
    """MultiMapperParams of module `mod` (reference or port) in the dynamic
    mode, without the connected-component filter."""
    fs = mod is jp and JFree or TFree
    sp = mod.MapperParams(
        projective=(JTsdf if mod is jp else TTsdf)(
            max_integration_distance_m=5.0),
        freespace=fs() if free_ms is None else fs(
            min_duration_since_occupied_for_freespace_ms=free_ms))
    sp = dataclasses.replace(sp, remove_small_connected_components=False)
    return mod.MultiMapperParams(mapping_type=mod.MappingType.DYNAMIC,
                                 static_mapper=sp, **kw)


@pytest.fixture(scope="module")
def built():
    """tests/test_detect_pallas.py's fixture: the room mapped with
    freespace over 8 orbit frames 300 ms apart, then a frame in which a
    sphere has appeared; and the port's MultiMapper loaded from it."""
    room = js.Scene(primitives=ROOM)
    dyn = js.Scene(primitives=ROOM + (js.Sphere(center=(0.5, 0.3, 1.0),
                                                radius=0.35),))
    world = dict(dims=(64, 64, 32), capacity=8192, origin_block=(-32, -32, -8))
    jm = jmm.MultiMapper(_dynamic_params(jp, block_capacity=8192),
                         world=JWorld(**world))
    sm = jm.static_mapper
    for k in range(8):
        T = jnp.asarray(js.orbit_pose(2 * np.pi * k / 8, radius=1.5))
        sm.integrate_depth(js.render_depth(room, JCAM, T), T, JCAM)
        sm.update_freespace(k * 300.0, T, JCAM)
    T = js.orbit_pose(0.0, radius=1.5)
    depth = np.array(js.render_depth(dyn, JCAM, jnp.asarray(T)))
    static_depth = np.array(js.render_depth(room, JCAM, jnp.asarray(T)))
    tm = tmm.MultiMapper(_dynamic_params(tp, block_capacity=8192),
                         world=TWorld(**world), device="cpu")
    tm.load_state_arrays(jax_multi_arrays(jm))
    return jm, tm, T, depth, static_depth


def _quality(mask, ref_mask):
    """tests/test_detect_pallas.py::_quality."""
    from scipy import ndimage
    inter = (mask & ref_mask).sum()
    recall = inter / max(ref_mask.sum(), 1)
    precision = inter / max(mask.sum(), 1)
    far_fp = (mask & ~ndimage.binary_dilation(ref_mask, iterations=8)).sum()
    return recall, precision, far_fp


@pytest.mark.parametrize("subsample", [1, 2])
def test_detect_plain_matches_reference(built, subsample):
    jm, tm, T, depth, _ = built
    sm = jm.static_mapper
    want, p_want = jmm._detect_dynamic_fused(
        sm.state, sm.channels["freespace_high_confidence"], jnp.asarray(depth),
        jnp.asarray(T), camera=JCAM, voxel_size_m=0.05, max_depth_m=5.0,
        subsample=subsample)
    want = np.asarray(want)
    t = tm.static_mapper
    got, p_got = detect_dynamic_plain(
        t.state, t.channels["freespace_high_confidence"],
        torch.from_numpy(depth), torch.from_numpy(T), camera=TCAM,
        voxel_size_m=0.05, max_depth_m=5.0, subsample=subsample)
    assert want.sum() > 1000
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_want))
    assert (got.numpy() == want).mean() >= 0.999, (got.numpy() != want).sum()
    # The wrapper and the MultiMapper entry point take the plain version
    # on the CPU and launch nothing.
    kernels.reset_launch_counts()
    mask = detect_dynamic(t.state, t.channels["freespace_high_confidence"],
                          torch.from_numpy(depth), torch.from_numpy(T),
                          camera=TCAM, voxel_size_m=0.05, max_depth_m=5.0,
                          subsample=subsample)
    assert mask.dtype == torch.uint8
    assert torch.equal(mask, got.to(torch.uint8))
    tm.params.dynamic_detection_subsample = subsample
    try:
        assert torch.equal(tm.detect_dynamic(depth, T, TCAM), mask)
    finally:
        tm.params.dynamic_detection_subsample = 1
    assert kernels.LAUNCHES["detect_dynamic"] == 0


def test_detect_plain_matches_reference_on_odd_camera(built):
    """An image whose width is odd and no multiple of the subsample (157
    x 119 at subsample 3): the shapes on which the card kernel takes its
    scalar path and writes partial tiles at the right and bottom edges.
    Endpoints exact, the mask within the bound of the test above."""
    jm, tm, T, _, _ = built
    args = dict(fx=160.0, fy=160.0, cx=78.0, cy=59.0, width=157, height=119)
    dyn = js.Scene(primitives=ROOM + (js.Sphere(center=(0.5, 0.3, 1.0),
                                                radius=0.35),))
    depth = np.array(js.render_depth(dyn, jc.Camera(**args), jnp.asarray(T)))
    sm, t = jm.static_mapper, tm.static_mapper
    want, p_want = jmm._detect_dynamic_fused(
        sm.state, sm.channels["freespace_high_confidence"], jnp.asarray(depth),
        jnp.asarray(T), camera=jc.Camera(**args), voxel_size_m=0.05,
        max_depth_m=5.0, subsample=3)
    got, p_got = detect_dynamic_plain(
        t.state, t.channels["freespace_high_confidence"],
        torch.from_numpy(depth), torch.from_numpy(T),
        camera=tc.Camera(**args), voxel_size_m=0.05, max_depth_m=5.0,
        subsample=3)
    want = np.asarray(want)
    assert got.shape == want.shape == (119, 157)
    assert want.sum() > 500
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_want))
    assert (got.numpy() == want).mean() >= 0.999, (got.numpy() != want).sum()


def test_detect_meets_the_pallas_tests_bounds(built):
    """The bounds tests/test_detect_pallas.py:77-124 holds the Pallas
    kernel to, against the exact detector: recall > 0.9, precision > 0.85,
    far false positives < 2%; a frame of the static room < 0.5%."""
    jm, tm, T, depth, static_depth = built
    sm = jm.static_mapper
    ref, _ = jmm._detect_dynamic_fused(
        sm.state, sm.channels["freespace_high_confidence"], jnp.asarray(depth),
        jnp.asarray(T), camera=JCAM, voxel_size_m=0.05, max_depth_m=5.0)
    ref = np.asarray(ref)
    mask = tm.detect_dynamic(depth, T, TCAM).numpy() > 0
    recall, precision, far_fp = _quality(mask, ref)
    assert recall > 0.9 and precision > 0.85, (recall, precision)
    assert far_fp < 0.02 * max(mask.sum(), 1), far_fp
    still = tm.detect_dynamic(static_depth, T, TCAM).numpy()
    assert still.sum() < 0.005 * still.size, still.sum()


CAM120 = dict(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
SMALL_WORLD = dict(dims=(32, 32, 16), capacity=4096, origin_block=(-16, -16, -4))


def _sphere_pop_frames():
    """tests/test_multi_mapper.py:152-164: a room seen from one pose for
    five frames, a sphere popping in on the sixth, 200 ms apart."""
    cam = jc.Camera(**CAM120)
    room = (js.RoomBox(center=(0.0, 0.0, 1.25), half_extents=(2.2, 1.8, 1.25)),)
    dyn = room + (js.Sphere(center=(0.6, 0.0, 1.0), radius=0.3),)
    T = js.orbit_pose(0.0, radius=1.8, height=1.0, target=(0, 0, 1.0))
    depths = np.stack([np.array(js.render_depth(
        js.Scene(primitives=dyn if k == 5 else room), cam, jnp.asarray(T)))
        for k in range(6)])
    poses = np.stack([np.asarray(T, np.float32)] * 6)
    return depths, poses, (200.0 * np.arange(6)).astype(np.float32)


def _small(mod, **kw):
    p = _dynamic_params(mod, free_ms=100.0, block_capacity=4096, **kw)
    if mod is jp:
        return jmm.MultiMapper(p, world=JWorld(**SMALL_WORLD))
    return tmm.MultiMapper(p, world=TWorld(**SMALL_WORLD), device="cpu")


CHANNELS = (("static_mapper", "tsdf_weight"),
            ("dynamic_mapper", "occupancy_log_odds"),
            ("static_mapper", "freespace_high_confidence"))


@pytest.fixture(scope="module")
def sphere_pop():
    depths, poses, times = _sphere_pop_frames()
    jm = _small(jp)
    jm.replay_frames_dynamic(depths, poses, times, jc.Camera(**CAM120))
    return depths, poses, times, jax_multi_arrays(jm)


def test_replay_frames_dynamic_matches_reference(sphere_pop):
    depths, poses, times, want = sphere_pop
    tm = _small(tp)
    tm.replay_frames_dynamic(depths, poses, times, tc.Camera(**CAM120))
    got = tm.state_arrays()
    for name in ("static_mapper", "dynamic_mapper"):
        for k in ("block_index_of_slot", "alloc_count"):
            np.testing.assert_array_equal(got[f"{name}/{k}"],
                                          want[f"{name}/{k}"])
    for name, ch in CHANNELS:
        a = got[f"{name}/{ch}"].astype(np.float64)
        b = want[f"{name}/{ch}"].astype(np.float64)
        assert abs(a.sum() - b.sum()) <= 1e-3 * max(abs(b.sum()), 1.0), ch
        assert (a == b).mean() >= 0.999, (ch, int((a != b).sum()))
    assert (got["dynamic_mapper/occupancy_log_odds"] > 0).sum() > 50
    np.testing.assert_array_equal(
        got["static_mapper/freespace_last_update_ms"], np.float32(1000.0))


def test_eager_integrate_depth_matches_replay(sphere_pop):
    """tests/test_multi_mapper.py:119-186 within the port: the eager tick
    (the full-pool freespace form once the region is known) against the
    replay (the view-batch form), channel sums within 1e-3."""
    depths, poses, times, _ = sphere_pop
    cam = tc.Camera(**CAM120)
    m1, m2 = _small(tp), _small(tp)
    m1.replay_frames_dynamic(depths, poses, times, cam)
    for k in range(6):
        m2.integrate_depth(depths[k], poses[k], cam, time_ms=float(times[k]))
    a_all, b_all = m1.state_arrays(), m2.state_arrays()
    for name, ch in CHANNELS:
        a = a_all[f"{name}/{ch}"].astype(np.float64)
        b = b_all[f"{name}/{ch}"].astype(np.float64)
        assert abs(a.sum() - b.sum()) <= 1e-3 * max(abs(b.sum()), 1.0), ch
    assert (a_all["dynamic_mapper/occupancy_log_odds"] > 0).sum() > 50


def test_dynamic_detection_subsample_matches_reference():
    """tests/test_multi_mapper.py:189-231 on both sides: detection at
    stride 2 through the eager tick, and the debug getters."""
    depths, poses, times = _sphere_pop_frames()
    jm = _small(jp, dynamic_detection_subsample=2)
    tm = _small(tp, dynamic_detection_subsample=2)
    for m, cam in ((jm, jc.Camera(**CAM120)), (tm, tc.Camera(**CAM120))):
        for k in range(6):
            m.integrate_depth(depths[k], poses[k], cam,
                              time_ms=float(times[k]))
    assert tm.last_dynamic_mask.sum() > 100
    assert (tm.dynamic_mapper.channels["occupancy_log_odds"] > 0).sum() > 50
    for getter in ("last_dynamic_mask", "last_depth_foreground",
                   "last_mask_overlay"):
        a, b = getattr(tm, getter), np.asarray(getattr(jm, getter))
        assert a.shape == b.shape and (a == b).mean() >= 0.999, getter
    a, b = tm.last_dynamic_pointcloud, jm.last_dynamic_pointcloud
    assert a.shape == b.shape and a.shape[0] > 100
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_human_mode_splits_masked_depth():
    """tests/test_multi_mapper.py:20-38 on both sides (parameters built
    directly: `make_params` comes with the runtime), the mask also seen
    from a second camera."""
    cam = jc.Camera(**CAM120)
    scene = js.Scene(primitives=(js.Sphere(center=(0.0, 0.0, 1.0),
                                           radius=0.6),))
    T = js.orbit_pose(0.0, radius=2.0, height=1.0, target=(0, 0, 1.0))
    depth = np.array(js.render_depth(scene, cam, jnp.asarray(T)))
    mask = np.zeros_like(depth, np.uint8)
    mask[:, :40] = 255
    T_CM_CD = np.eye(4, dtype=np.float32)
    T_CM_CD[0, 3] = 0.05
    mask_cam = dict(fx=100.0, fy=100.0, cx=49.5, cy=39.5, width=100,
                    height=80)
    out = []
    for mod, mmod, cmod, dev in ((jp, jmm, jc, {}), (tp, tmm, tc,
                                                     {"device": "cpu"})):
        sp = dataclasses.replace(mod.MapperParams(),
                                 remove_small_connected_components=False)
        mm = mmod.MultiMapper(mod.MultiMapperParams(
            mapping_type=mod.MappingType.HUMAN_WITH_STATIC_TSDF,
            block_capacity=4096, static_mapper=sp), **dev)
        c = cmod.Camera(**CAM120)
        mm.integrate_depth(depth, T, c, mask=mask)
        mm.integrate_depth(depth, T, c, mask=mask[10:90, 10:110],
                           mask_camera=cmod.Camera(**mask_cam),
                           T_CM_CD=T_CM_CD)
        out.append(mm)
    jm, tm = out
    assert tm.static_mapper.block_count() > 0
    assert tm.dynamic_mapper.block_count() > 0
    lo = tm.dynamic_mapper.channels["occupancy_log_odds"].numpy()
    assert (lo > 0).any()
    np.testing.assert_array_equal(tm.last_dynamic_mask,
                                  np.asarray(jm.last_dynamic_mask))
    for name, ch in (("static_mapper", "tsdf_weight"),
                     ("dynamic_mapper", "occupancy_log_odds")):
        a = getattr(tm, name).channels[ch].numpy()
        b = np.asarray(getattr(jm, name).channels[ch])
        assert (a == b).mean() >= 0.999, (ch, int((a != b).sum()))


def test_reproject_mask_and_invalid_depth_dilation_match_reference():
    rng = np.random.default_rng(4)
    dcam, mcam = CAM120, dict(fx=150.0, fy=150.0, cx=79.5, cy=59.5,
                              width=160, height=120)
    depth = rng.uniform(0.5, 4.0, (90, 120)).astype(np.float32)
    depth[rng.random((90, 120)) < 0.1] = 0.0
    mask = (rng.random((120, 160)) < 0.4).astype(np.uint8) * 255
    T = np.eye(4, dtype=np.float32)
    c, s_ = np.cos(0.1), np.sin(0.1)
    T[:3, :3] = [[c, 0, s_], [0, 1, 0], [-s_, 0, c]]
    T[:3, 3] = (0.1, -0.05, 0.02)
    want = np.asarray(jmm.reproject_mask(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(T),
        depth_camera=jc.Camera(**dcam), mask_camera=jc.Camera(**mcam)))
    got = tmm.reproject_mask(torch.from_numpy(depth), torch.from_numpy(mask),
                             torch.from_numpy(T),
                             depth_camera=tc.Camera(**dcam),
                             mask_camera=tc.Camera(**mcam))
    assert got.dtype == torch.uint8 and 0 < want.sum()
    np.testing.assert_array_equal(got.numpy(), want)
    for n in (0, 1, 3):
        np.testing.assert_array_equal(
            tmm.dilate_invalid_depth(torch.from_numpy(depth), n).numpy(),
            np.asarray(jmm.dilate_invalid_depth(jnp.asarray(depth), n)))
    pts, valid = tbp.back_project_depth(torch.from_numpy(depth),
                                        camera=tc.Camera(**dcam),
                                        max_depth_m=3.0)
    pj, vj = jbp.back_project_depth(jnp.asarray(depth),
                                    camera=jc.Camera(**dcam), max_depth_m=3.0)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))


def test_params_match_reference():
    for name in ("MultiMapperParams", "MapperParams", "EsdfSliceParams"):
        a = dataclasses.asdict(getattr(tp, name)())
        b = dataclasses.asdict(getattr(jp, name)())
        assert repr(a) == repr(b), name
    assert [m.value for m in tp.EsdfMode] == [m.value for m in jp.EsdfMode]


def test_multi_mapper_entry_points_and_later_slices():
    """esdf_mode 3d updates both mappers; in 2d both mappers get the planar
    field of the slice band, and the mesh publisher fills the static
    mapper's mesh layer; decay and the slice band."""
    depths, poses, times = _sphere_pop_frames()
    tm = _small(tp, esdf_mode=tp.EsdfMode.K3D)
    cam = tc.Camera(**CAM120)
    tm.replay_frames_dynamic(depths, poses, times, cam)
    tm.update_esdf()
    for m in (tm.static_mapper, tm.dynamic_mapper):
        assert bool((m.channels["esdf_sq_dist"] < 1e11).any())
    tm.decay()
    assert tm.esdf_2d_band() == (0.1, 0.3)
    tm.params.esdf_mode = tp.EsdfMode.K2D
    tm.update_esdf()
    for m in (tm.static_mapper, tm.dynamic_mapper):
        assert m.esdf_2d is not None
        assert m.esdf_2d_frame_heights == (0.1, 0.3)
    assert len(tm.update_mesh()) > 0
    assert len(tm.static_mapper.mesh_layer.blocks) > 0
    color = np.full((90, 120, 3), 200, np.uint8)
    tm.integrate_color(color, poses[0], cam, mask=(depths[0] > 3.0))
    assert bool((tm.static_mapper.channels["color_weight"] > 0).any())
    with pytest.raises(ValueError, match="dynamic mode"):
        tmm.MultiMapper(tp.MultiMapperParams(block_capacity=4096),
                        world=TWorld(**SMALL_WORLD),
                        device="cpu").replay_frames_dynamic(
            depths, poses, times, cam)
