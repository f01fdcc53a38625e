"""Port vs reference: the lidar model, the lidar view grid, spherical TSDF
fusion (plain version of tsdf_lidar_fuse) and the lidar mapper as a whole
(CPU).

The port's `Lidar.project` repeats the reference's XLA program (the range,
the folded constants, XLA's arcsin expansion); its atan2 is the CPU's
vectorized one, which differs from the reference's in the last bit on
some inputs, so a voxel whose u or v sits within an ulp of a pixel
boundary may sample the neighbouring pixel. Fusion is held to the
reference within 1e-5 on >= 99.9% of the observed voxels and within
tests/test_lidar_pallas.py's bounds overall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import lidar as jl
from isaac_ros_nvblox_tpu.ops import esdf as jesdf
from isaac_ros_nvblox_tpu.ops import tsdf as jts
from isaac_ros_nvblox_tpu.ops import view as jv
from isaac_ros_nvblox_tpu.ops.lidar_pallas import integrate_tsdf_lidar_pallas
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.core.types import Transform
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.models import lidar as tl
from isaac_ros_nvblox_tpu_torch.models.scene import (
    cluttered_multi_room_scene, default_test_scene)
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ted
from isaac_ros_nvblox_tpu_torch.ops import tsdf as tts
from isaac_ros_nvblox_tpu_torch.ops import view as tv
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams as TEsdf
from isaac_ros_nvblox_tpu_torch.ops.lidar_cuda import (
    integrate_tsdf_lidar_cuda)
from test_torch_occupancy import STATE, jax_mapper_arrays

torch.set_num_threads(2)

VOXEL = 0.05
FOV = np.deg2rad(30.0)
# The node's lidar (1800 x 16) and the reference tests' (512 x 32).
SHAPES = [(1800, 16), (512, 32)]


def lidars(A, E, min_range=0.1, max_range=100.0):
    args = (A, E, FOV, min_range, max_range)
    return jl.Lidar.equal_vertical_fov(*args), tl.Lidar.equal_vertical_fov(
        *args)


def level_pose(x, y, z, yaw):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    T[:3, 3] = (x, y, z)
    return T


def lidar_scan(scene, lidar, T_L_S, num_steps=96, row_offset=0.25):
    """Sphere-trace `scene` along the lidar's `unproject` rays from pose
    T_L_S, each lowered by `row_offset` rows: points `f32[rows * cols, 3]`
    in the sensor frame, (0, 0, 0) (out of range) where a ray hits nothing
    within the max range.

    A point at a beam's own elevation lands within an ulp of its row, and
    the range image truncates v: the reference puts 17% of such points in
    the row above, the port (its CPU atan2) 22%, and the two differ on 5%.
    The quarter-row offset keeps the comparisons off that boundary."""
    T = torch.as_tensor(T_L_S, dtype=torch.float32)
    el = (lidar.max_angle_above_zero_elevation_rad
          - (torch.arange(lidar.num_elevation_divisions) + row_offset)
          * lidar.rads_per_row)
    az = ((torch.arange(lidar.num_azimuth_divisions) + 0.5)
          / lidar.num_azimuth_divisions * (2 * np.pi) - np.pi)
    elg, azg = torch.meshgrid(el.float(), az.float(), indexing="ij")
    dirs_S = torch.stack([torch.cos(elg) * torch.cos(azg),
                          torch.cos(elg) * torch.sin(azg), torch.sin(elg)],
                         -1).reshape(-1, 3)
    dirs_L = Transform.rotate(T, dirs_S)
    t = torch.full((dirs_S.shape[0],), 1e-3)
    for _ in range(num_steps):
        d = scene.sdf(dirs_L * t[:, None] + T[:3, 3])
        t = torch.clamp_max(t + torch.where(d > 1e-4, d, torch.zeros_like(d)),
                            2.0 * lidar.max_valid_range_m)
    hit = ((scene.sdf(dirs_L * t[:, None] + T[:3, 3]) < 1e-3)
           & (t < lidar.max_valid_range_m))
    return torch.where(hit[:, None], dirs_S * t[:, None],
                       torch.zeros_like(dirs_S)).numpy()


def random_points(seed, n=20000):
    """Points in every direction (some outside the elevation band, some
    too close), with repeats so that cells collide."""
    rng = np.random.RandomState(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(-FOV / 2 - 0.05, FOV / 2 + 0.05, n)
    r = rng.uniform(0.05, 12.0, n)
    p = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                  r * np.sin(el)], 1).astype(np.float32)
    return np.concatenate([p, p[: n // 4] * np.float32(1.01)])


@pytest.mark.parametrize("A,E", SHAPES)
def test_project_and_range_image_match_reference(A, E):
    j, t = lidars(A, E)
    pts = random_points(A)
    img_j = np.asarray(jl.pointcloud_to_range_image(jnp.asarray(pts), j))
    img_t = tl.pointcloud_to_range_image(torch.from_numpy(pts), t).numpy()
    assert (img_j > 0).sum() > 0.3 * min(A * E, len(pts))
    np.testing.assert_array_equal(img_t, img_j)
    uv_j, r_j, ok_j = (np.asarray(a)
                       for a in jax.jit(j.project)(jnp.asarray(pts)))
    uv_t, r_t, ok_t = (a.numpy() for a in t.project(torch.from_numpy(pts)))
    np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(uv_t, uv_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.unproject().numpy(), np.asarray(j.unproject()),
                               rtol=0, atol=1e-6)


def test_motion_compensation_matches_reference():
    j, t = lidars(1800, 16)
    rng = np.random.RandomState(7)
    pts = random_points(8, 5000)
    ts = np.sort(rng.uniform(0.0, 0.1, len(pts))).astype(np.float32)
    T0 = level_pose(0.2, -0.1, 1.3, 0.3)
    T1 = level_pose(0.5, 0.1, 1.35, 0.5)
    T1[:3, :3] = T1[:3, :3] @ np.array(
        [[1, 0, 0], [0, np.cos(0.05), -np.sin(0.05)],
         [0, np.sin(0.05), np.cos(0.05)]], np.float32)
    want = np.asarray(jl.motion_compensate_pointcloud(
        jnp.asarray(pts), jnp.asarray(ts), jnp.asarray(T0), jnp.asarray(T1),
        j))
    got = tl.motion_compensate_pointcloud(
        torch.from_numpy(pts), torch.from_numpy(ts), torch.from_numpy(T0),
        torch.from_numpy(T1), t).numpy()
    assert np.abs(want - pts).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _sawtooth_range(A, E):
    """A range image whose footprint maxima depend on where the coarse
    cells start: a sawtooth in azimuth, with gaps."""
    col = np.arange(A)
    base = 1.5 + 4.5 * ((col % 97) / 97.0)
    img = np.broadcast_to(base, (E, A)).copy()
    img[:, (col // 37) % 5 == 0] = 0.0
    img[E // 3] *= 0.7
    return img.astype(np.float32)


def _ceil_mode_pool(img, window, stride):
    """The pooling the reference does NOT do: strided windows padded at
    the end only (the centred 3x3 widening as before)."""
    x = img[None, None]
    if tuple(stride) == (1, 1):
        return torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)[0, 0]
    return torch.nn.functional.max_pool2d(x, window, stride=stride,
                                          ceil_mode=True)[0, 0]


@pytest.mark.parametrize("A,E", SHAPES)
def test_lidar_grid_matches_reference(A, E, monkeypatch):
    """Cell for cell, including the "SAME" pooling offset: at 1800 columns
    the first (8, 32) cell holds columns 0-19."""
    j, t = lidars(A, E)
    img = _sawtooth_range(A, E)
    T = level_pose(0.37, -0.21, 1.3, 2.9)
    kw = dict(voxel_size_m=VOXEL, max_distance_m=7.0, truncation_m=0.2)
    g_j, o_j = jv.touched_block_grid_lidar(jnp.asarray(img), jnp.asarray(T),
                                           lidar=j, **kw)
    g_t, o_t = tv.touched_block_grid_lidar(torch.from_numpy(img),
                                           torch.from_numpy(T), lidar=t, **kw)
    g_j = np.asarray(g_j)
    assert g_j.sum() > 1500
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(g_t.numpy(), g_j)
    if A == 1800:
        # End-only padding would give another grid: the case is exercised.
        monkeypatch.setattr(tv, "_max_pool_same", _ceil_mode_pool)
        g_c, _ = tv.touched_block_grid_lidar(torch.from_numpy(img),
                                             torch.from_numpy(T), lidar=t,
                                             **kw)
        assert (g_c.numpy() != g_j).sum() > 0


def _seam_batch(cap=512, seed=0, near_seam=False):
    """Blocks around the sensor (tests/test_lidar_pallas.py's layout) plus
    padding entries."""
    rng = np.random.RandomState(seed)
    lo = (-12, -4) if near_seam else (-10, 10)
    ylo = (-3, 3) if near_seam else (-10, 10)
    bidx = np.stack([rng.randint(*lo, 200), rng.randint(*ylo, 200),
                     rng.randint(-2, 2, 200)], 1).astype(np.int32)
    bidx = np.unique(bidx, axis=0)
    n = bidx.shape[0]
    slots = np.concatenate([np.arange(n), [cap, -1]]).astype(np.int32)
    bidx = np.concatenate([bidx, [[0, 0, 0], [1, 1, 1]]]).astype(np.int32)
    return slots, bidx


def _textured_range(A, E, seed=2):
    rng = np.random.RandomState(seed)
    base = 3.0 + 0.3 * np.sin(np.linspace(0, 4 * np.pi, A))[None, :]
    img = np.broadcast_to(base, (E, A)).copy() + rng.rand(E, A) * 0.01
    img[rng.rand(E, A) < 0.05] = 0.0
    return img.astype(np.float32)


def _fuse_pair(img, slots, bidx, T, A, E, mode=None, cap=512, pallas=False):
    j, t = lidars(A, E, min_range=0.4, max_range=20.0)
    kw = dict(max_integration_distance_m=6.0)
    if mode is not None:
        kw["weighting_mode"] = mode
    p_j = jts.TsdfIntegratorParams(**kw)
    p_t = tts.TsdfIntegratorParams(
        max_integration_distance_m=6.0,
        weighting_mode=tts.WeightingFunctionType(p_j.weighting_mode.value))
    fn = integrate_tsdf_lidar_pallas if pallas else jts.integrate_tsdf_lidar
    extra = dict(interpret=jax.default_backend() == "cpu") if pallas else {}
    d_j, w_j = fn(jnp.zeros((cap, 512)), jnp.zeros((cap, 512)),
                  jnp.asarray(slots), jnp.asarray(bidx), jnp.asarray(img),
                  jnp.asarray(T), lidar=j, voxel_size_m=VOXEL, params=p_j,
                  **extra)
    d_t, w_t = integrate_tsdf_lidar_cuda(
        torch.zeros(cap, 512), torch.zeros(cap, 512), torch.from_numpy(slots),
        torch.from_numpy(bidx), torch.from_numpy(img), torch.from_numpy(T),
        lidar=t, voxel_size_m=VOXEL, params=p_t)
    return (np.asarray(d_j), np.asarray(w_j)), (d_t.numpy(), w_t.numpy())


def assert_lidar_tsdf_matches(d_t, w_t, d_j, w_j, min_observed=1000):
    """Within 1e-5 on >= 99.9% of the observed voxels; overall within
    tests/test_lidar_pallas.py:64-84's bounds (observed agreement >
    0.995, median error < 0.01, p99 < 0.05)."""
    obs = (w_t > 0) | (w_j > 0)
    assert obs.sum() > min_observed
    bad = (np.abs(d_t - d_j) > 1e-5) | (np.abs(w_t - w_j) > 1e-5)
    assert (bad & obs).sum() <= 1e-3 * obs.sum(), (bad & obs).sum()
    m_t, m_j = w_t > 0, w_j > 0
    assert (m_t == m_j).mean() > 0.995
    err = np.abs(d_t - d_j)[m_t & m_j]
    assert np.median(err) < 0.01 and np.percentile(err, 99) < 0.05


@pytest.mark.parametrize("mode", [None] + list(jts.WeightingFunctionType)[::2])
@pytest.mark.parametrize("near_seam", [False, True])
def test_integrate_tsdf_lidar_matches_reference(mode, near_seam):
    A, E = 512, 32
    slots, bidx = _seam_batch(near_seam=near_seam)
    T = level_pose(0.1, -0.05, 0.02, 0.15)
    (d_j, w_j), (d_t, w_t) = _fuse_pair(_textured_range(A, E), slots, bidx,
                                        T, A, E, mode)
    assert_lidar_tsdf_matches(d_t, w_t, d_j, w_j)
    assert not w_t[len(slots) - 2:].any()   # padding rows untouched


def test_matches_pallas_at_the_seam():
    """The Pallas path wraps the seam, the XLA path (and the port) clamp:
    tests/test_lidar_pallas.py's statistical bounds."""
    slots, bidx = _seam_batch(cap=256, near_seam=True)
    (d_p, w_p), (d_t, w_t) = _fuse_pair(_textured_range(512, 32), slots,
                                        bidx, np.eye(4, dtype=np.float32),
                                        512, 32, cap=256, pallas=True)
    m_p, m_t = w_p > 0, w_t > 0
    assert m_p.sum() > 1000
    assert (m_p == m_t).mean() > 0.995
    err = np.abs(d_t - d_p)[m_p & m_t]
    assert np.median(err) < 0.01 and np.percentile(err, 99) < 0.05


# ---------------------------------------------------------------------------
# The lidar mapper as a whole
# ---------------------------------------------------------------------------

WORLD = dict(dims=(48, 48, 24), capacity=4096, origin_block=(-24, -24, -6))


def test_lidar_mapper_matches_reference():
    """One scan by the reference, loaded into the port; then on both sides
    two scans (one motion-compensated), an ESDF update, clearing outside a
    radius and inside a sphere."""
    A, E = 512, 32
    j_l, t_l = lidars(A, E)
    scene = default_test_scene()
    poses = [level_pose(0.3 * k - 0.5, 0.2 * k, 1.3, 0.8 * k)
             for k in range(4)]
    scans = [lidar_scan(scene, t_l, T) for T in poses]
    assert (np.abs(scans[0]).sum(1) > 0).mean() > 0.9
    stamps = np.linspace(0.0, 0.1, A * E).astype(np.float32)
    j = jdm.DeviceMapper(
        VOXEL, params=jp.MapperParams(
            projective=jts.TsdfIntegratorParams(max_integration_distance_m=3.0),
            esdf=jesdf.EsdfIntegratorParams(max_esdf_distance_m=0.6)),
        world=jwg.WorldGridConfig(**WORLD), enable_color=False,
        max_blocks_per_frame=2048)
    t = tdm.DeviceMapper(
        VOXEL, params=tp.MapperParams(
            projective=tts.TsdfIntegratorParams(max_integration_distance_m=3.0),
            esdf=TEsdf(max_esdf_distance_m=0.6)),
        world=twg.WorldGridConfig(**WORLD), enable_color=False,
        max_blocks_per_frame=2048, device="cpu")
    j.integrate_pointcloud(scans[0], poses[0], j_l)
    t.load_state_arrays(jax_mapper_arrays(j))
    # A loaded map starts clean (load_state_arrays clears the dirty bits).
    j.dirty = jnp.zeros_like(j.dirty)
    for m, lidar in ((j, j_l), (t, t_l)):
        m.integrate_pointcloud(scans[1], poses[1], lidar)
        m.integrate_pointcloud(scans[2], poses[2], lidar, timestamps_s=stamps,
                               T_L_S_end=poses[3])
        m.update_esdf()
    want, got = jax_mapper_arrays(j), t.state_arrays()
    for f in STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert_lidar_tsdf_matches(got["tsdf_distance"], got["tsdf_weight"],
                              want["tsdf_distance"], want["tsdf_weight"],
                              min_observed=50000)
    # The ESDF of the port's own sites is exact (the numpy reference EDT);
    # against the reference's ESDF it differs only near differing sites.
    sq = got["esdf_sq_dist"]
    assert (sq < 1e11).sum() > 20000
    assert (sq == want["esdf_sq_dist"]).mean() > 0.995
    site, _, _ = jesdf.esdf_sites_from_tsdf(
        jnp.asarray(got["tsdf_distance"]), jnp.asarray(got["tsdf_weight"]),
        voxel_size_m=jnp.float32(VOXEL), max_site_distance_vox=1.0,
        min_weight=1e-4)
    n = int(got["alloc_count"])
    origin, dims = t.esdf_region(margin_blocks=0, mult=1)
    ref = ted.esdf_from_sites_reference(
        np.asarray(site), got["block_index_of_slot"] - origin, n, dims, 12)
    live = got["block_index_of_slot"][:, 0] < twg.FREED_BLOCK_SENTINEL
    np.testing.assert_array_equal(sq[live], ref[live])
    # Clearing, on both sides.
    for m in (j, t):
        m.clear_outside_radius(poses[3][:3, 3], 2.0)
        m.clear_tsdf_inside_shapes(spheres=[((0.5, 0.5, 1.0), 0.6)])
    want, got = jax_mapper_arrays(j), t.state_arrays()
    assert int(want["removed_count"]) > 100
    for f in STATE + ("removed_log", "removed_count"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(t.dirty.numpy(), np.asarray(j.dirty))
    assert_lidar_tsdf_matches(got["tsdf_distance"], got["tsdf_weight"],
                              want["tsdf_distance"], want["tsdf_weight"])


def test_cluttered_scene_scan_is_closed():
    """The chip run's lidar scans (the cluttered two-room scene, sensor at
    1.3 m) hit a surface on nearly every ray."""
    _, t_l = lidars(360, 16)
    pts = lidar_scan(cluttered_multi_room_scene(), t_l,
                     level_pose(-3.0 + 1.6, 0.0, 1.3, np.pi / 2))
    r = np.linalg.norm(pts, axis=1)
    assert (r > 0).mean() > 0.99 and r.max() < 14.0
