"""The publish slice: the port's 2-D ESDF, DeviceMapper 2-D entry points,
MultiMapper K2D mode and mapper/device_io against the reference (CPU), at
tests/test_device_io.py's sizes. The reference runs its EDT passes and its
marching-cubes kernel in Pallas interpret mode; the port runs the plain
versions of its kernels.

Where a test needs one map on both sides, the port builds it and the
reference is given a copy (`_to_jax`), so that the comparison holds the
function under test alone, bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from isaac_ros_nvblox_tpu import native as jnative
from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_io as jdio
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper import multi_mapper as jmm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import esdf_dense as jed
from isaac_ros_nvblox_tpu.ops import mesh_pallas as jmp
from isaac_ros_nvblox_tpu_torch import kernels, native
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_io as tdio
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper import multi_mapper as tmm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.ops import esdf as tesdf
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ted
from isaac_ros_nvblox_tpu_torch.ops import mesh as tmesh
from isaac_ros_nvblox_tpu_torch.ops import mesh_cuda as tmc
from isaac_ros_nvblox_tpu_torch.utils.timing import Timing
from test_torch_dynamics import CAM120, _small, _sphere_pop_frames

torch.set_num_threads(2)

VOXEL = 0.05
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
JCAM, TCAM = jc.Camera(**CAM_ARGS), tc.Camera(**CAM_ARGS)
WORLD = dict(dims=(64, 64, 32), capacity=8192, origin_block=(-32, -32, -8))
STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")
BAND = (0.8, 1.2)


def _scene(extra=()):
    return js.Scene(primitives=(
        js.RoomBox(center=(0, 0, 1.5), half_extents=(2.0, 1.8, 1.5)),
        js.Sphere(center=(0.6, 0.4, 1.0), radius=0.4)) + tuple(extra))


@pytest.fixture(scope="module")
def frames():
    """Five 120x90 frames (the last sees a second sphere), rendered by the
    reference."""
    out = []
    for k in range(5):
        T = js.orbit_pose(2 * np.pi * k / 8 if k < 4 else np.pi / 7,
                          radius=1.2)
        scene = _scene() if k < 4 else _scene(
            (js.Sphere(center=(-0.5, -0.3, 1.0), radius=0.25),))
        out.append((np.array(js.render_depth(scene, JCAM, jnp.asarray(T))),
                    np.asarray(T, np.float32)))
    return out


def _port_mapper(**kw):
    return tdm.DeviceMapper(VOXEL, world=twg.WorldGridConfig(**WORLD),
                            device="cpu", **kw)


def _jax_mapper(**kw):
    return jdm.DeviceMapper(VOXEL, world=jwg.WorldGridConfig(**WORLD),
                            enable_esdf=True, **kw)


def _host_tracking(src, dst):
    for k in ("_aabb_lo", "_aabb_hi", "_dirty_lo", "_dirty_hi",
              "_dirty2d_lo", "_dirty2d_hi"):
        v = getattr(src, k)
        setattr(dst, k, None if v is None else np.array(v))
    dst._region_unknown = src._region_unknown


def _to_jax(t, j):
    """The port mapper's allocator, channels, rings and host-tracked
    regions into the reference mapper `j` (same channel set)."""
    a = t.state_arrays()
    j.state = jwg.WorldGridState(**{f: jnp.asarray(a[f]) for f in STATE})
    assert sorted(j.channels) == sorted(t.channels)
    j.channels = {k: jnp.asarray(a[k]) for k in t.channels}
    for k in ("mesh_pending", "removed_log", "removed_count"):
        setattr(j, k, jnp.asarray(a[k]))
    j.dirty = jnp.asarray(t.dirty.numpy())
    j.esdf_dirty = jnp.asarray(t.esdf_dirty.numpy())
    _host_tracking(t, j)
    return j


@pytest.fixture(scope="module")
def base(frames):
    """The port's map of frames 0-2 (no color), with a synthetic 3-D ESDF
    (integer squared distances, INF, inside and observed bits from a seed)
    on the live blocks, and the reference mapper holding the same."""
    t = _port_mapper(enable_color=False)
    for depth, T in frames[:3]:
        t.integrate_depth(depth, T, TCAM)
    rng = np.random.default_rng(0)
    cap = t.capacity
    sq = rng.integers(0, 1700, (cap, 512)).astype(np.float32)
    sq[rng.random((cap, 512)) < 0.1] = np.float32(1e12)
    ch = t.channels
    ch["esdf_sq_dist"].copy_(torch.from_numpy(sq))
    ch["esdf_is_inside"].copy_(torch.from_numpy(rng.random((cap, 512)) < 0.2))
    ch["esdf_observed"].copy_(torch.from_numpy(rng.random((cap, 512)) < 0.8))
    j = _to_jax(t, _jax_mapper(enable_color=False))
    return t, j


def _field(m):
    origin, *arrays = m.esdf_2d
    return (tuple(int(v) for v in origin),
            *[np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
              for a in arrays])


def _assert_fields_equal(a, b):
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- the 2-D solve

def _random_pool(seed, cap=48, kind="tsdf"):
    """A random pool: block indices with repeated (x, y) columns at several
    z, slots past alloc_count and outside the region, and channels."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(-3, 4, (cap, 2))
    bz = rng.integers(-2, 4, (cap, 1))
    bidx = np.concatenate([cols, bz], 1).astype(np.int32)
    if kind == "tsdf":
        a = rng.uniform(-0.2, 0.2, (cap, 512)).astype(np.float32)
        b = np.where(rng.random((cap, 512)) < 0.7,
                     rng.uniform(0.0, 3.0, (cap, 512)), 0.0).astype(
            np.float32)
    else:
        a = rng.normal(0.0, 1.0, (cap, 512)).astype(np.float32)
        b = (rng.random((cap, 512)) < 0.6).astype(np.uint8)
    return bidx, a, b


@pytest.mark.parametrize("kind,band_m", [
    ("tsdf", (0.1, 0.3)), ("occupancy", (0.1, 0.3)),
    # Band edges on voxel centres: (2 + 0.5) * 0.05 rounds to 0.125 in
    # float32 (kept); (-16 + 5 + 0.5) * 0.05 rounds one bit below
    # float32(-0.525) (dropped).
    ("tsdf", (-0.525, 0.125))])
def test_esdf2d_solve_matches_reference(kind, band_m):
    """Sites, the float32 height-band mask, the column collapse (a
    scatter-any with padding and out-of-region slots dropped) and the two
    planar passes, against the reference's fused solve (Pallas interpret
    mode): bit for bit."""
    bidx, a, b = _random_pool(1 + len(kind), kind=kind)
    cap = bidx.shape[0]
    alloc, dims_b, band = 40, (5, 4), 12
    origin = np.asarray([-2, -2, 0], np.int32)
    jstate = jwg.WorldGridState(
        slot_grid=jnp.zeros((1, 1, 1), jnp.int32),
        block_index_of_slot=jnp.asarray(bidx),
        alloc_count=jnp.int32(alloc), overflow_count=jnp.int32(0),
        origin_block=jnp.zeros(3, jnp.int32),
        free_stack=jnp.zeros(cap, jnp.int32), free_count=jnp.int32(0))
    tstate = twg.WorldGridState.from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in STATE}, "cpu")
    esdf = tp.MapperParams().esdf
    occ = kind == "occupancy"
    statics = ((float(esdf.occupied_log_odds_threshold),) if occ else
               (float(esdf.max_site_distance_vox), float(esdf.min_weight)))
    want = jdm._esdf2d_solve_fused(
        jstate, jnp.asarray(a), jnp.asarray(b), jnp.asarray(origin),
        jnp.float32(band_m[0]), jnp.float32(band_m[1]), voxel_size_m=VOXEL,
        esdf_statics=statics, is_occupancy=occ, dims_b=dims_b, band=band,
        interp=True)
    got = tdm._esdf2d_solve(
        tstate, torch.from_numpy(a), torch.from_numpy(b),
        torch.from_numpy(origin), *band_m, dims_b=dims_b, band=band,
        voxel_size_m=VOXEL, esdf_params=esdf,
        sites_from="occupancy" if occ else "tsdf")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0] == 0).any() and (got[0] >= 1e11).any()
    assert (got[0] > 0).logical_and(got[0] < 1e11).any()
    mask_t = tdm._voxel_z_band_mask(tstate, *band_m, voxel_size_m=VOXEL)
    mask_j = jdm._voxel_z_band_mask(jstate, jnp.float32(band_m[0]),
                                    jnp.float32(band_m[1]),
                                    voxel_size_m=VOXEL)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    if band_m[1] == 0.125:
        # The centre on the edge is inside: bz = 0, lz = 2 kept, lz = 3
        # dropped.
        rows = bidx[:, 2] == 0
        lz = np.arange(512) % 8
        assert mask_t.numpy()[rows][:, lz == 2].all()
        assert not mask_t.numpy()[rows][:, lz == 3].any()
        rows = bidx[:, 2] == -2
        assert not mask_t.numpy()[rows][:, lz == 5].any()
        assert mask_t.numpy()[rows][:, lz == 6].all()


def test_collapse_2d_mask_and_solve_match_reference_entry_points():
    """`collapse_2d_mask` and `esdf_2d_from_sites` called directly, with
    random sites and band masks, against the reference's own (a band of 5
    voxels, below the 8-voxel block)."""
    rng = np.random.default_rng(7)
    bidx, _, _ = _random_pool(7, cap=64)
    site = rng.random((64, 512)) < 0.01
    z_ok = rng.random((64, 512)) < 0.5
    args_t = (torch.from_numpy(z_ok), torch.from_numpy(bidx),
              torch.tensor(50, dtype=torch.int32),
              torch.tensor([-3, -3, 0], dtype=torch.int32))
    args_j = tuple(jnp.asarray(np.asarray(x)) for x in args_t)
    got = ted.collapse_2d_mask(torch.from_numpy(site), *args_t, dims_b=(7, 7))
    want = jed.collapse_2d_mask(jnp.asarray(site), *args_j, dims_b=(7, 7))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ted.esdf_2d_from_sites(torch.from_numpy(site), *args_t,
                                 dims_b=(7, 7), band=5)
    want = jed.esdf_2d_from_sites(jnp.asarray(site), *args_j, dims_b=(7, 7),
                                  band=5, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got == 0).sum()) > 10


# ----------------------------------------------------- DeviceMapper 2-D ESDF

def _scipy_sq2d(m, band_m):
    """The 2-D field by scipy: the band's site columns collapsed on the
    host, then the exact EDT with its nearest-site indices, squared in
    integers; INF beyond band^2."""
    origin, sq2d, _, _ = _field(m)
    n = int(m.state.alloc_count)
    is_site, _, _ = tesdf.esdf_sites_from_tsdf(
        m.channels["tsdf_distance"], m.channels["tsdf_weight"],
        voxel_size_m=VOXEL,
        max_site_distance_vox=float(m.params.esdf.max_site_distance_vox),
        min_weight=float(m.params.esdf.min_weight))
    z_ok = tdm._voxel_z_band_mask(m.state, *band_m, voxel_size_m=VOXEL)
    col = (is_site & z_ok)[:n].numpy().reshape(n, 8, 8, 8).any(-1)
    X, Y = sq2d.shape
    seeds = np.zeros((X, Y), bool)
    bidx = m.state.block_index_of_slot[:n].numpy()
    for s in range(n):
        cx, cy = bidx[s, 0] - origin[0], bidx[s, 1] - origin[1]
        if 0 <= cx < X // 8 and 0 <= cy < Y // 8:
            seeds[cx * 8:cx * 8 + 8, cy * 8:cy * 8 + 8] |= col[s]
    _, idx = ndimage.distance_transform_edt(~seeds, return_indices=True)
    ii = np.indices((X, Y))
    d2 = ((idx - ii) ** 2).sum(0)
    band = m.esdf_band_vox
    return np.where(d2 <= band * band, d2.astype(np.float32),
                    np.float32(1e12)), int(seeds.sum())


def test_update_esdf_2d_matches_reference_and_scipy(base):
    """One map on both sides: the port's update_esdf_2d equals the
    reference's bit for bit, and equals scipy's exact EDT on every cell
    of the region (no output pruning: distances reach columns with no
    allocated block)."""
    t0, j0 = base
    t = _port_mapper(enable_color=False)
    t.load_state_arrays(t0.state_arrays())
    _host_tracking(t0, t)
    j = _to_jax(t, _jax_mapper(enable_color=False))
    t.update_esdf_2d(*BAND)
    j.update_esdf_2d(*BAND)
    got, want = _field(t), _field(j)
    _assert_fields_equal(got, want)
    assert t._esdf2d_frame == j._esdf2d_frame
    assert t.esdf_2d_frame_heights == j.esdf_2d_frame_heights
    brute, n_sites = _scipy_sq2d(t, BAND)
    assert n_sites > 50
    np.testing.assert_array_equal(got[1], brute)
    alloc = np.zeros(got[1].shape, bool)
    for bx, by, _ in t.state.block_index_of_slot[
            :int(t.state.alloc_count)].numpy():
        cx, cy = bx - got[0][0], by - got[0][1]
        alloc[cx * 8:cx * 8 + 8, cy * 8:cy * 8 + 8] = True
    assert ((got[1] < 1e11) & ~alloc).any()


def test_update_esdf_2d_incremental_and_noop(base, frames):
    """After a frame, the 2-D update (only its dirty window changed) equals
    a full solve; with nothing dirty the call keeps the stored field; a new
    band is a new frame and solves again."""
    t0, _ = base
    t = _port_mapper(enable_color=False)
    t.load_state_arrays(t0.state_arrays())
    _host_tracking(t0, t)
    t.update_esdf_2d(*BAND)
    depth, T = frames[4]
    t.integrate_depth(depth, T, TCAM)
    assert t._dirty2d_lo is not None
    t.update_esdf_2d(*BAND)
    inc = _field(t)
    t.update_esdf_2d(*BAND, full=True)
    _assert_fields_equal(inc, _field(t))
    before = t.esdf_2d
    t.update_esdf_2d(*BAND)
    assert t.esdf_2d is before
    # A 3-D update takes the 3-D dirty window only.
    t.integrate_depth(*frames[3], TCAM)
    t._dirty_lo = t._dirty_hi = None
    t.update_esdf_2d(*BAND)
    assert t.esdf_2d is not before
    before = t.esdf_2d
    t.update_esdf_2d(0.5, 1.0)
    assert t.esdf_2d is not before and t.esdf_2d_frame_heights == (0.5, 1.0)


def test_fused_tick_matches_integrate_then_solve(base, frames):
    """integrate_depth_with_esdf2d equals integrate_depth + update_esdf_2d:
    the whole state and the field. It declines device-tensor poses and an
    occupancy layer."""
    t0, _ = base
    depth, T = frames[4]
    a, b = _port_mapper(enable_color=False), _port_mapper(enable_color=False)
    for m in (a, b):
        m.load_state_arrays(t0.state_arrays())
        _host_tracking(t0, m)
    assert a.integrate_depth_with_esdf2d(depth, T, TCAM, *BAND)
    b.integrate_depth(depth, T, TCAM)
    b.update_esdf_2d(*BAND)
    sa, sb = a.state_arrays(), b.state_arrays()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    np.testing.assert_array_equal(a.dirty.numpy(), b.dirty.numpy())
    _assert_fields_equal(_field(a), _field(b))
    assert a._dirty2d_lo is None and a._dirty_lo is not None
    assert not a.integrate_depth_with_esdf2d(depth, torch.from_numpy(T),
                                             TCAM, *BAND)
    occ = _port_mapper(projective_layer=tp.ProjectiveLayerType.OCCUPANCY)
    assert not occ.integrate_depth_with_esdf2d(depth, T, TCAM, *BAND)


# ------------------------------------------------------- MultiMapper K2D mode

def test_multi_mapper_k2d_static_matches_reference(frames):
    """A default MultiMapper (static TSDF, EsdfMode.K2D): update_esdf solves
    the band's planar field, equal to the reference MultiMapper's on the
    same map; the fused tick runs, and the next update_esdf has nothing
    left to do."""
    tm = tmm.MultiMapper(tp.MultiMapperParams(block_capacity=8192),
                         world=twg.WorldGridConfig(**WORLD), device="cpu")
    jm = jmm.MultiMapper(jp.MultiMapperParams(block_capacity=8192),
                         world=jwg.WorldGridConfig(**WORLD))
    for depth, T in frames[:2]:
        tm.integrate_depth(depth, T, TCAM)
    _to_jax(tm.static_mapper, jm.static_mapper)
    tm.update_esdf()
    jm.update_esdf()
    a = _field(tm.static_mapper)
    _assert_fields_equal(a, _field(jm.static_mapper))
    assert tm.static_mapper.esdf_2d_frame_heights == (0.1, 0.3)
    assert (a[1] < 1e11).sum() > 1000 and a[3].any()
    assert tm.integrate_depth_with_esdf2d(*frames[2], TCAM,
                                          *tm.esdf_2d_band())
    fused = tm.static_mapper.esdf_2d
    tm.update_esdf()
    assert tm.static_mapper.esdf_2d is fused


def test_multi_mapper_k2d_dynamic_matches_reference():
    """The dynamic mode: update_esdf in K2D solves the static TSDF's and the
    dynamic occupancy layer's planar fields (the band at the popped
    sphere's height), each equal to the reference's on the same maps; the
    fused tick declines."""
    depths, poses, times = _sphere_pop_frames()
    tm, jm = _small(tp), _small(jp)
    tm.replay_frames_dynamic(depths, poses, times, tc.Camera(**CAM120))
    for mm, mod in ((tm, tp), (jm, jp)):
        mm.params.static_mapper.esdf_slice = mod.EsdfSliceParams(
            esdf_slice_min_height=0.8, esdf_slice_max_height=1.2)
    for name in ("static_mapper", "dynamic_mapper"):
        m = getattr(tm, name)
        m._refresh_region_from_device()
        _to_jax(m, getattr(jm, name))
    tm.update_esdf()
    jm.update_esdf()
    for name in ("static_mapper", "dynamic_mapper"):
        _assert_fields_equal(_field(getattr(tm, name)),
                             _field(getattr(jm, name)))
    dyn = _field(tm.dynamic_mapper)
    assert (dyn[1] == 0).any() and dyn[3].any()
    assert not tm.integrate_depth_with_esdf2d(
        depths[0], poses[0], tc.Camera(**CAM120), *tm.esdf_2d_band())


# ------------------------------------------------------------------ slicers

def test_slicers_match_reference(base):
    """slice_esdf_device (gather at one height, crop to the known content)
    and slice_esdf_2d_device ([H = y, W = x]) on one map: equal images and
    specs."""
    t, j = base
    for kw in (dict(slice_height_m=1.0, max_distance_m=2.0),
               dict(slice_height_m=0.52, max_distance_m=0.7,
                    unknown_value=50.0, padding_px=3)):
        spec_t, img_t = tdio.slice_esdf_device(t, **kw)
        spec_j, img_j = jdio.slice_esdf_device(j, **kw)
        assert dataclasses.astuple(spec_t) == dataclasses.astuple(spec_j)
        np.testing.assert_array_equal(img_t, img_j)
        assert (img_t < 0).any() and (img_t != kw.get("unknown_value",
                                                      1000.0)).mean() > 0.2
    m = _port_mapper(enable_color=False)
    m.load_state_arrays(t.state_arrays())
    _host_tracking(t, m)
    m.update_esdf_2d(*BAND)
    j2 = _to_jax(m, _jax_mapper(enable_color=False))
    origin, *field = m.esdf_2d
    j2.esdf_2d = (origin, *[jnp.asarray(f.numpy()) for f in field])
    for kw in (dict(max_distance_m=2.0), dict(max_distance_m=0.3,
                                              unknown_value=7.0)):
        spec_t, img_t = tdio.slice_esdf_2d_device(m, **kw)
        spec_j, img_j = jdio.slice_esdf_2d_device(j2, **kw)
        assert dataclasses.astuple(spec_t) == dataclasses.astuple(spec_j)
        assert img_t.shape == (spec_t.height,
                                                    spec_t.width)
        np.testing.assert_array_equal(img_t, img_j)
    assert tdio.slice_esdf_2d_device(_port_mapper(), max_distance_m=1.0) \
        is None


@pytest.mark.parametrize("shift", [(0, 0, 0, 0), (-16, 8, 24, -40),
                                   (40, -24, -72, 16)])
def test_slice_2d_takes_a_given_frame(base, shift):
    """slice_esdf_2d_device with another spec (origin moved by dx, dy
    voxels, shape changed by dw, dh): the field placed in that frame,
    cropped where it reaches past it and unknown where it does not cover
    it, as the node combines the dynamic mapper's field with the static
    slice."""
    t, _ = base
    m = _port_mapper(enable_color=False)
    m.load_state_arrays(t.state_arrays())
    _host_tracking(t, m)
    m.update_esdf_2d(*BAND)
    kw = dict(max_distance_m=2.0, unknown_value=7.0)
    spec, img = tdio.slice_esdf_2d_device(m, **kw)
    dx, dy, dw, dh = shift
    vs = spec.voxel_size_m
    other = dataclasses.replace(
        spec, origin_x_m=spec.origin_x_m + dx * vs,
        origin_y_m=spec.origin_y_m + dy * vs, width=spec.width + dw,
        height=spec.height + dh)
    got_spec, got = tdio.slice_esdf_2d_device(m, spec=other, **kw)
    assert got_spec == other and got.shape == (other.height, other.width)
    want = np.full(got.shape, np.float32(7.0))
    ys, xs = np.mgrid[:img.shape[0], :img.shape[1]]
    ty, tx = ys - dy, xs - dx
    inside = (ty >= 0) & (ty < other.height) & (tx >= 0) & (tx < other.width)
    want[ty[inside], tx[inside]] = img[inside]
    np.testing.assert_array_equal(got, want)
    assert (got != np.float32(7.0)).any()


def test_dense_grid_and_gradients_match_reference(base):
    t, j = base
    for lo, hi in (((-1.0, -1.0, 0.5), (1.0, 1.0, 1.5)),
                   ((-2.21, 0.3, -0.4), (-1.0, 0.93, 0.31))):
        gt, grt, ot = tdio.esdf_and_gradients_device(t, lo, hi,
                                                     default_value=99.0)
        gj, grj, oj = jdio.esdf_and_gradients_device(j, lo, hi,
                                                     default_value=99.0)
        np.testing.assert_array_equal(gt, np.asarray(gj))
        np.testing.assert_array_equal(ot, oj)
        np.testing.assert_allclose(grt, np.asarray(grj), rtol=0, atol=1e-6)
        assert (gt != 99.0).mean() > 0.2 and (gt < 0).any()


# ------------------------------------------------------------------ removals

@pytest.mark.parametrize("count,read", [(0, 0), (5, 2), (11, 0), (40, 10),
                                        (40, 40)])
def test_take_removed_blocks_matches_reference(count, read):
    """The ring read, oldest first, with overflow (more freed than the ring
    holds since the last read: the newest `cap` come back)."""
    world = dict(dims=(8, 8, 8), capacity=16, origin_block=(0, 0, 0))
    t = tdm.DeviceMapper(VOXEL, world=twg.WorldGridConfig(**world),
                         device="cpu")
    j = jdm.DeviceMapper(VOXEL, world=jwg.WorldGridConfig(**world))
    log = np.random.default_rng(count).integers(-50, 50, (16, 3)).astype(
        np.int32)
    t.removed_log.copy_(torch.from_numpy(log))
    t.removed_count.fill_(count)
    j.removed_log, j.removed_count = jnp.asarray(log), jnp.int32(count)
    t._removed_read = j._removed_read = read
    got = tdio.take_removed_blocks(t)
    assert got == jdio.take_removed_blocks(j)
    assert len(got) == min(count - read, 16)
    assert t._removed_read == j._removed_read
    assert tdio.take_removed_blocks(t) == []


def test_removed_blocks_of_a_clearing(base):
    t0, _ = base
    t = _port_mapper(enable_color=False)
    t.load_state_arrays(t0.state_arrays())
    n0 = t.block_count()
    t.clear_outside_radius((0.6, 0.4, 1.0), 0.8)
    removed = tdio.take_removed_blocks(t)
    assert len(removed) == n0 - t.block_count() > 100
    sg = t.state.slot_grid.numpy()
    o = np.asarray(WORLD["origin_block"])
    assert all(sg[tuple(np.asarray(k) - o)] < 0 for k in removed)


# ------------------------------------------------------------------- map IO

def _by_key(arrays):
    """{block key: {channel: row}} of a map's live blocks."""
    n = int(arrays["alloc_count"])
    bidx = arrays["block_index_of_slot"][:n]
    live = bidx[:, 0] < twg.FREED_BLOCK_SENTINEL
    names = [k for k in arrays if k.startswith(("tsdf_", "color_", "esdf_"))]
    return {tuple(int(v) for v in bidx[s]): {k: arrays[k][s] for k in names}
            for s in np.nonzero(live)[0]}


def _assert_same_blocks(a, b):
    ka, kb = _by_key(a), _by_key(b)
    assert ka.keys() == kb.keys() and len(ka) > 300
    for key, rows in ka.items():
        for name, row in rows.items():
            assert row.dtype == kb[key][name].dtype, name
            np.testing.assert_array_equal(row, kb[key][name], err_msg=name)


@pytest.fixture(scope="module")
def color_map(frames):
    t = _port_mapper()
    rng = np.random.default_rng(3)
    for depth, T in frames[:3]:
        t.integrate_depth(depth, T, TCAM)
        t.integrate_color(rng.integers(0, 256, (90, 120, 3), dtype=np.uint8),
                          T, TCAM, depth=depth)
    t.clear_outside_radius((0.0, 0.0, 1.0), 2.6)   # freed slots in the pool
    return t


def test_save_load_round_trip_and_cross_load(color_map, tmp_path):
    """save -> load within the port; port -> reference and reference ->
    port (format 2, same keys and dtypes): every channel of every live
    block equal, compared by block key."""
    t = color_map
    assert int(t.state.free_count) > 0
    want = t.state_arrays()
    tdio.save_map_device(t, tmp_path / "port.nvblx")
    t2 = _port_mapper()
    n = tdio.load_map_device(t2, tmp_path / "port.nvblx")
    assert n == t.block_count() == t2.block_count()
    _assert_same_blocks(t2.state_arrays(), want)
    assert bool(t2.dirty[:n].all()) and not bool(t2.dirty[n:].any())
    assert int(t2.removed_count) == 0 and t2._region_unknown
    assert float(t2.channels["esdf_sq_dist"][n:].min()) == float(
        np.float32(1e12))
    # port -> reference
    j = _jax_mapper(enable_color=True)
    assert jdio.load_map_device(j, tmp_path / "port.nvblx") == n
    _assert_same_blocks({**{f: np.asarray(getattr(j.state, f))
                            for f in STATE},
                         **{k: np.asarray(v) for k, v in j.channels.items()}},
                        want)
    # reference -> port
    jdio.save_map_device(_to_jax(t, _jax_mapper(enable_color=True)),
                         tmp_path / "jax.nvblx")
    t3 = _port_mapper()
    assert tdio.load_map_device(t3, tmp_path / "jax.nvblx") == n
    _assert_same_blocks(t3.state_arrays(), want)
    with np.load(tmp_path / "port.nvblx") as a, \
            np.load(tmp_path / "jax.nvblx") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
    with pytest.raises(ValueError, match="channel mismatch"):
        tdio.load_map_device(_port_mapper(enable_color=False),
                             tmp_path / "port.nvblx")
    with pytest.raises(ValueError, match="voxel size"):
        tdio.load_map_device(tdm.DeviceMapper(
            0.1, world=twg.WorldGridConfig(**WORLD), device="cpu"),
            tmp_path / "port.nvblx")


# ------------------------------------------------------------- mesh layer

def test_mesh_layer_matches_reference_kernel_branch(color_map):
    """update_mesh_layer against the reference's kernel branch on the same
    map: its marching-cubes kernel (interpret mode), local_to_world_verts
    and native compaction into the layer; equal re-serialized keys, and
    equal vertices, colors and triangles per block. Then the removals of
    a clearing reach the layer."""
    t = _port_mapper()
    t.load_state_arrays(color_map.state_arrays())
    t.dirty.copy_(twg.live_slot_mask(t.state))
    j = _to_jax(t, _jax_mapper(enable_color=True))
    t._removed_read = j._removed_read = int(t.removed_count)
    keys = tdio.update_mesh_layer(t, max_blocks=512)

    verts, colors, mask, bidx, slots = j.update_mesh_dirty_device(
        max_blocks=512, use_pallas=True, return_slots=True)
    n_live = int(jnp.sum(slots < j.capacity))
    world, _ = jmp.local_to_world_verts(verts[:n_live], bidx[:n_live], VOXEL)
    offsets, v_flat, c_flat = jnative.compact_mesh_blocks(
        np.asarray(world), np.asarray(colors[:n_live].astype(jnp.float32)),
        np.asarray(mask[:n_live]))
    want_keys = [tuple(int(v) for v in b) for b in np.asarray(bidx[:n_live])]
    cleared = [k for k in j.take_mesh_clear_keys() if k not in want_keys]
    assert keys == want_keys + cleared and len(want_keys) > 50
    assert t.last_meshed_keys == keys and t.last_removed_keys == []
    ref = jdm.MeshLayer(VOXEL, j.params.mesh)
    for i, key in enumerate(want_keys):
        a, b = int(offsets[i]), int(offsets[i + 1])
        ref.update_block(key, v_flat[a:b].reshape(-1, 3, 3),
                         c_flat[a:b].reshape(-1, 3, 3))
    assert t.mesh_layer.blocks.keys() == ref.blocks.keys()
    for key, blk in ref.blocks.items():
        got = t.mesh_layer.blocks[key]
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(got, f), getattr(blk, f))
    v, c, tri = t.mesh_layer.as_arrays()
    assert tri.shape[0] > 500 and c.max() > 10
    n0 = len(t.mesh_layer.blocks)
    t.clear_outside_radius((0.6, 0.4, 1.0), 0.8)
    tdio.update_mesh_layer(t, max_blocks=512)
    assert len(t.last_removed_keys) > 0
    assert not set(t.last_removed_keys) & set(t.mesh_layer.blocks)
    assert len(t.mesh_layer.blocks) < n0


def test_mesh_layer_matches_host_csr(color_map):
    """update_mesh_layer, its soup compacted on the device, against the
    host CSR it replaces on a copy of the same map (local_to_world_verts,
    the full padded rows copied, native.compact_mesh_blocks): the same
    MeshLayer block for block. Its readback makes three reads, two fewer
    than the padded copy's five (counts, vertices, mask, block indices,
    colors), and copies the counts, the CSR ints and the live vertices'
    positions and colors alone."""
    t, old = _port_mapper(), _port_mapper()
    for m in (t, old):
        m.load_state_arrays(color_map.state_arrays())
        m.dirty.copy_(twg.live_slot_mask(m.state))
        m._removed_read = int(m.removed_count)
    Timing.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        keys = tdio.update_mesh_layer(t, max_blocks=512)
    spans = {r.name: r for r in Timing.span_log()}
    Timing.reset()

    verts, colors, _, bidx, slots = old.update_mesh_dirty_device(
        max_blocks=512, return_slots=True)
    n_live = int((slots < old.capacity).sum())
    world, mask = tmc.local_to_world_verts(verts[:n_live], bidx[:n_live],
                                           VOXEL)
    offsets, v_flat, c_flat = native.compact_mesh_blocks(
        world.numpy(), colors[:n_live].float().numpy(), mask.numpy())
    want = tmesh.MeshLayer(VOXEL, old.params.mesh)
    want_keys = [tuple(int(v) for v in b) for b in bidx[:n_live].numpy()]
    for i, key in enumerate(want_keys):
        a, b = int(offsets[i]), int(offsets[i + 1])
        want.update_block(key, v_flat[a:b].reshape(-1, 3, 3),
                          c_flat[a:b].reshape(-1, 3, 3))
    assert keys[:n_live] == want_keys and n_live > 50
    assert t.mesh_layer.blocks.keys() == want.blocks.keys()
    for key, blk in want.blocks.items():
        got = t.mesh_layer.blocks[key]
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(got, f), getattr(blk, f))

    readback = spans["mapper/mesh/readback"].counters
    total = int(offsets[-1])
    assert readback["host/reads"] == [3.0, 3]
    assert readback["mapper/mesh/live_vertices"] == [float(total), 1]
    assert t.last_mesh_host_bytes == 3 * 8 + (4 * n_live + 1) * 8 \
        + 2 * total * 3 * 4
    assert t.last_mesh_host_bytes * 10 < world.numel() * 4


def test_no_kernel_launch_on_cpu(base):
    """The publish entry points on CPU tensors run the plain versions."""
    t0, _ = base
    t = _port_mapper(enable_color=False)
    t.load_state_arrays(t0.state_arrays())
    t.dirty.copy_(twg.live_slot_mask(t.state))
    kernels.reset_launch_counts()
    t.update_esdf_2d(*BAND)
    tdio.update_mesh_layer(t, max_blocks=256)
    assert not any(kernels.LAUNCHES.values())
