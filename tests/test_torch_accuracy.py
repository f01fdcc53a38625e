"""Accuracy cross-check at the benchmark's configuration (CPU).

The bench scene (a 6 x 4.4 x 3 m room with a sphere and a box), its
16-frame VGA orbit replayed 4x, 0.05 m voxels and 5 m integration go through
the reference's TSDF path with its numpy ESDF reference, and through the
port's plain path. Both are scored against the analytic scene SDF as bench.py scores them; the
scores hold chip_smoke.py's accuracy limits to what the reference itself
reaches on this path. Run as a script to print the figures:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_accuracy.py

With `--mesh` it prints the reference's own mesh-accuracy figures at the
benchmark's accuracy configuration instead (a few minutes on the CPU);
with `--occupancy` and `--lidar` the reference's own figures for
chip_smoke.py's occupancy and lidar paths (its XLA integrators; the
sources of those paths' limits); with `--dynamics` its figures for the
scored part of chip_smoke.py's `dynamic_frames` phase; with `--node` its
node's figures for chip_smoke.py's `node_ticks` phase; with `--node-modes`
its node's figures (and the port's CPU run's) for the `node_modes` phase;
with `--fuser` its figures for chip_smoke.py's `fuser` phase (a); with
`--human` its figures for chip_smoke.py's `human_frames` phase (the
people-segmentation modes, a person walking through the bench room, the
mask from a separate camera); with `--scenes` its figures for chip_smoke.py's `scenes` phase
(bench.py's large and sparse scenes).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.core.types import voxel_centers_for_blocks
from isaac_ros_nvblox_tpu.mapper.device_mapper import DeviceMapper as JMapper
from isaac_ros_nvblox_tpu.mapper.params import MapperParams as JParams
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import esdf as jesdf
from isaac_ros_nvblox_tpu.ops import esdf_dense as jed
from isaac_ros_nvblox_tpu.ops import view as jv
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu.ops.tsdf_pallas import integrate_tsdf_pallas
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams as TParams
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams as TTsdf
from test_torch_device_mapper import assert_tsdf_matches

torch.set_num_threads(2)

VOXEL = 0.05
BAND = 40            # EsdfIntegratorParams.max_esdf_distance_m 2.0 / 0.05
WORLD = dict(dims=(64, 64, 32), capacity=16384, origin_block=(-32, -32, -8))
# chip_smoke.py's limits. The TSDF limit is the benchmark's; the ESDF one
# sits above the 0.0487 m the reference's XLA TSDF path reaches here, which
# the port mirrors (its Pallas path, which the benchmark ran on the TPU,
# reaches 0.030 m; see main()).
TSDF_MAE_LIMIT_M = 0.035
ESDF_MAE_LIMIT_M = 0.05


def _scores(gt, d, w, sq, inside, where=True):
    """bench.py:628-646 (`where` narrows the ESDF score to some voxels)."""
    near = (np.abs(gt) < 0.1) & (w > 0.5)
    tsdf_mae = float(np.mean(np.abs(d[near] - gt[near])))
    est = np.minimum(np.sqrt(np.minimum(sq, 1e12)) * VOXEL, 2.0)
    est = np.where(inside, -est, est)
    m = (gt > 3 * VOXEL) & (gt < 1.0) & (sq < 1e11) & where
    return tsdf_mae, float(np.mean(np.abs(est[m] - gt[m])))


ARGS = dict(fx=500.0, fy=500.0, cx=319.5, cy=239.5, width=640, height=480)
SCENE = js.Scene(primitives=(
    js.RoomBox(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
    js.Sphere(center=(1.2, 0.8, 1.0), radius=0.5),
    js.Box(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4))))


def _frames(jcam):
    poses = [js.orbit_pose(2 * np.pi * k / 16, radius=1.5) for k in range(16)]
    return poses, [np.array(js.render_depth(SCENE, jcam, jnp.asarray(T)))
                   for T in poses]


def _reference_esdf(d, w, bidx, n, origin, dims):
    """Sites of a TSDF pool and the numpy reference EDT over a region."""
    site, inside, _ = (np.asarray(a) for a in jesdf.esdf_sites_from_tsdf(
        jnp.asarray(d), jnp.asarray(w), voxel_size_m=jnp.float32(VOXEL),
        max_site_distance_vox=1.0, min_weight=1e-4))
    sq = jed.esdf_from_sites_reference(site, bidx - origin, n, tuple(dims),
                                       BAND)
    return site, inside, sq


def run():
    jcam, tcam = jc.Camera(**ARGS), tc.Camera(**ARGS)
    scene = SCENE
    poses, depths = _frames(jcam)

    jm = JMapper(VOXEL, params=JParams(projective=JTsdf(
        max_integration_distance_m=5.0)), world=jwg.WorldGridConfig(**WORLD),
        enable_color=False, enable_esdf=False, max_blocks_per_frame=2048)
    tm = tdm.DeviceMapper(VOXEL, params=TParams(projective=TTsdf(
        max_integration_distance_m=5.0)), world=twg.WorldGridConfig(**WORLD),
        max_blocks_per_frame=2048, device="cpu")
    # The orbit 4x over, as the benchmark replays it (weights saturate).
    for depth, T in list(zip(depths, poses)) * 4:
        jm.integrate_depth(depth, jnp.asarray(T), jcam)
        tm.integrate_depth(depth, torch.from_numpy(T), tcam)

    n = jm.block_count()
    bidx = np.asarray(jm.state.block_index_of_slot)
    d_j = np.asarray(jm.channels["tsdf_distance"])
    w_j = np.asarray(jm.channels["tsdf_weight"])
    # The benchmark's region: the allocated AABB (esdf_region(0, 1)).
    origin, dims = tm.esdf_region(margin_blocks=0, mult=1)
    site, inside, ref_sq = _reference_esdf(d_j, w_j, bidx, n, origin, dims)
    sq_t, ins_t, _ = tdm._esdf_solve(
        tm.state, tm.channels["tsdf_distance"], tm.channels["tsdf_weight"],
        torch.as_tensor(origin), dims_b=dims, band=BAND, voxel_size_m=VOXEL,
        esdf_params=tm.params.esdf)

    centers = np.asarray(voxel_centers_for_blocks(jnp.asarray(bidx[:n]),
                                                  VOXEL))
    gt = np.asarray(scene.sdf(centers))
    t = tm.state_arrays()
    ref_args = (gt, d_j[:n], w_j[:n], ref_sq[:n], inside[:n])
    ref = _scores(*ref_args)
    port = _scores(gt, t["tsdf_distance"][:n], t["tsdf_weight"][:n],
                   sq_t.numpy()[:n], ins_t.numpy()[:n])
    low = centers[..., 2] < 1.0   # below 1 m: above floor the orbit misses
    by_height = (_scores(*ref_args, where=low)[1],
                 _scores(*ref_args, where=~low)[1])
    return dict(jm=jm, tm=tm, n=n, poses=poses, d_j=d_j, w_j=w_j,
                ref_sq=ref_sq,
                sq_t=sq_t.numpy(), region=(origin, dims), ref=ref, port=port,
                by_height=by_height, centers=centers, gt=gt, site=site)


def pallas_scores(r):
    """The same frames through the reference's Pallas TSDF kernel (interpret
    mode; decimated depth sampling), the path the benchmark ran on the TPU.
    Returns its (tsdf_mae, esdf_mae) and its sites."""
    jcam = jc.Camera(**ARGS)
    poses, depths = _frames(jcam)
    params = JTsdf(max_integration_distance_m=5.0)
    st = jwg.create_world_grid(jwg.WorldGridConfig(**WORLD))
    d = jnp.zeros((WORLD["capacity"], 512), jnp.float32)
    w = jnp.zeros_like(d)
    for depth, T in list(zip(depths, poses)) * 4:
        grid, org = jv.touched_block_grid(
            jnp.asarray(depth), jnp.asarray(T), camera=jcam,
            voxel_size_m=VOXEL, max_distance_m=5.0,
            truncation_m=params.truncation_m(VOXEL))
        st, slots, bidx, _ = jwg.allocate_and_batch(st, grid, org,
                                                    max_blocks=2048)
        d, w = integrate_tsdf_pallas(d, w, slots, bidx, jnp.asarray(depth),
                                     jnp.asarray(T), camera=jcam,
                                     voxel_size_m=VOXEL, params=params,
                                     interpret=True)
    n = r["n"]
    bidx = np.asarray(st.block_index_of_slot)
    assert np.array_equal(bidx[:n], np.asarray(
        r["jm"].state.block_index_of_slot)[:n])
    d, w = np.asarray(d), np.asarray(w)
    site, inside, sq = _reference_esdf(d, w, bidx, n, *r["region"])
    return (_scores(r["gt"], d[:n], w[:n], sq[:n], inside[:n]), site[:n])


def test_bench_scene_accuracy_matches_reference():
    r = run()
    t = r["tm"].state_arrays()
    assert r["n"] == r["tm"].block_count() > 1500
    want = dict(block_index_of_slot=np.asarray(
        r["jm"].state.block_index_of_slot), alloc_count=np.asarray(
        r["jm"].state.alloc_count), tsdf_distance=r["d_j"],
        tsdf_weight=r["w_j"])
    for k in ("block_index_of_slot", "alloc_count"):
        np.testing.assert_array_equal(t[k], want[k], err_msg=k)
    assert_tsdf_matches(t, want, r["poses"], tc.Camera(**ARGS))
    # The port's ESDF equals the numpy reference on the reference's sites.
    np.testing.assert_array_equal(r["sq_t"], r["ref_sq"])
    (tsdf_ref, esdf_ref), (tsdf_port, esdf_port) = r["ref"], r["port"]
    assert abs(tsdf_port - tsdf_ref) < 1e-4
    assert esdf_port == esdf_ref
    assert tsdf_ref <= TSDF_MAE_LIMIT_M and esdf_ref <= ESDF_MAE_LIMIT_M


MESH_WORLD = dict(dims=(64, 64, 32), capacity=16384,
                  origin_block=(-32, -32, -8))


def mesh_frames(camera, render):
    """The benchmark's mesh-accuracy trajectory (bench.py:608-616): 12
    views orbiting the centre of each of the two rooms. Returns (poses,
    depths) as numpy arrays; `render(pose)` renders one depth image."""
    poses = []
    for room_cx in (-3.0, 3.0):
        for k in range(12):
            a = 2 * np.pi * k / 12
            eye = (room_cx + 1.6 * np.cos(a), 1.4 * np.sin(a), 1.3)
            poses.append(js.look_at_pose(eye, (room_cx, 0.0, 1.2)))
    return poses, [np.asarray(render(T)) for T in poses]


def mesh_reference():
    """The reference package's own CPU run of the benchmark's mesh-accuracy
    configuration (bench.py:582-619): the cluttered two-room scene, 24 VGA
    frames, tsdf-distance-penalty weighting, 7 m integration, mesh
    min_weight 0.02, 4096 blocks per frame; full-map marching cubes scored
    by utils/metrics.py::mesh_accuracy. chip_smoke.py's mesh limits derive
    from these figures."""
    import dataclasses
    from isaac_ros_nvblox_tpu.ops.tsdf import WeightingFunctionType as JW
    from isaac_ros_nvblox_tpu.utils.metrics import mesh_accuracy
    jcam = jc.Camera(**ARGS)
    scene = js.cluttered_multi_room_scene()
    params = JParams(projective=JTsdf(
        max_integration_distance_m=7.0,
        weighting_mode=JW.INVERSE_SQUARE_TSDF_DISTANCE_PENALTY))
    params = dataclasses.replace(
        params, mesh=dataclasses.replace(params.mesh, min_weight=0.02))
    m = JMapper(VOXEL, params=params, world=jwg.WorldGridConfig(**MESH_WORLD),
                enable_color=False, enable_esdf=False,
                max_blocks_per_frame=4096)
    poses, depths = mesh_frames(
        jcam, lambda T: js.render_depth(scene, jcam, jnp.asarray(T)))
    m.replay_frames(jnp.asarray(np.stack(depths)),
                    jnp.asarray(np.stack(poses)), jcam)
    acc = mesh_accuracy(m, scene)
    return {k: acc[k] for k in ("mesh_surface_err_m", "mesh_precision",
                                "mesh_completeness", "mesh_fscore",
                                "mesh_vertices", "gt_surface_samples",
                                "tau_m")} | {
        "allocated_blocks": m.block_count(),
        "overflow_count": int(m.state.overflow_count)}


def _bucket(worst):
    """bench.py:118-130's batch rule (chip_smoke.py's `bucket_of`)."""
    for b in (512, 1024, 2048, 4096, 8192):
        if worst <= b - 64:
            return b
    return 16384


def _live_region(state):
    """(origin, dims) of the live blocks' AABB."""
    bidx = np.asarray(state.block_index_of_slot)
    n = int(state.alloc_count)
    live = bidx[:n, 0] < jwg.FREED_BLOCK_SENTINEL
    lo, hi = bidx[:n][live].min(0), bidx[:n][live].max(0)
    return lo, tuple(int(d) for d in hi - lo + 1)


def occupancy_reference():
    """The reference's CPU run of chip_smoke.py's occupancy path: the
    bench scene's 16-frame VGA orbit replayed 4x into an occupancy mapper
    (default occupancy params: 7 m, half width 0.1 m), decay every 8th
    frame, the ESDF from occupied sites after the last frame (the numpy
    EDT, equal to the reference's kernels), scored as chip_smoke.py
    scores the port."""
    from isaac_ros_nvblox_tpu.mapper.params import ProjectiveLayerType
    jcam = jc.Camera(**ARGS)
    poses, depths = _frames(jcam)
    mb = _bucket(max(int(np.asarray(jv.touched_block_grid(
        jnp.asarray(d), jnp.asarray(T), camera=jcam, voxel_size_m=VOXEL,
        max_distance_m=7.0, truncation_m=0.1)[0]).sum())
        for d, T in zip(depths, poses)))
    m = JMapper(VOXEL, params=JParams(), world=jwg.WorldGridConfig(**WORLD),
                enable_color=False, enable_esdf=False,
                projective_layer=ProjectiveLayerType.OCCUPANCY,
                max_blocks_per_frame=mb)
    for k in range(64):
        m.integrate_depth(depths[k % 16], poses[k % 16], jcam)
        if (k + 1) % 8 == 0:
            m.decay()
    n = int(m.state.alloc_count)
    bidx = np.asarray(m.state.block_index_of_slot)
    lo = np.asarray(m.channels["occupancy_log_odds"])
    obs = np.asarray(m.channels["occupancy_observed"]) > 0
    site = np.asarray(jesdf.esdf_sites_from_occupancy(
        jnp.asarray(lo), jnp.asarray(obs), occupied_log_odds_threshold=0.0)[0])
    origin, dims = _live_region(m.state)
    sq = jed.esdf_from_sites_reference(site, bidx - origin, n, dims,
                                       BAND)[:n]
    live = (bidx[:n, 0] < jwg.FREED_BLOCK_SENTINEL)[:, None]
    centers = np.asarray(voxel_centers_for_blocks(
        jnp.asarray(np.where(live, bidx[:n], 0)), VOXEL))
    gt = np.asarray(SCENE.sdf(centers))
    est = np.minimum(np.sqrt(np.minimum(sq, 1e12)) * VOXEL, 2.0)
    est = np.where(site[:n], -est, est)
    emask = live & (gt > 3 * VOXEL) & (gt < 1.0) & (sq < 1e11)
    occupied = live & obs[:n] & (lo[:n] > 0)
    near = np.abs(gt) <= 0.1 + VOXEL * np.sqrt(3.0) / 2
    return {"max_blocks_per_frame": mb, "allocated_blocks": m.block_count(),
            "alloc_high_water": n,
            "blocks_freed_by_decay": int(m.removed_count),
            "overflow_count": int(m.state.overflow_count),
            "esdf_mae_m": float(np.mean(np.abs(est - gt)[emask])),
            "esdf_voxels_scored": int(emask.sum()),
            "occupied_voxels": int(occupied.sum()),
            "occupied_near_surface_share":
                float((occupied & near).sum() / max(occupied.sum(), 1))}


def lidar_orbit_poses(n_per_room=32):
    """chip_smoke.py's lidar poses: a level sensor at 1.3 m on the
    benchmark's accuracy ellipses, heading along the ellipse."""
    poses = []
    for cx in (-3.0, 3.0):
        for k in range(n_per_room):
            a = 2 * np.pi * k / n_per_room
            yaw = np.arctan2(1.4 * np.cos(a), -1.6 * np.sin(a))
            T = np.eye(4, dtype=np.float32)
            c, s_ = np.cos(yaw), np.sin(yaw)
            T[:3, :3] = [[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]]
            T[:3, 3] = (cx + 1.6 * np.cos(a), 1.4 * np.sin(a), 1.3)
            poses.append(T)
    return poses


def lidar_rays(lidar, row_offset=0.25):
    """chip_smoke.py's `lidar_rays`: the beams `f32[rows * cols, 3]` at
    `unproject`'s column centres, each row lowered by a quarter row, off
    the range image's row boundaries (where the last bit of atan2 would
    pick a return's row)."""
    A, E = lidar.num_azimuth_divisions, lidar.num_elevation_divisions
    az = (np.arange(A) + 0.5) / A * (2 * np.pi) - np.pi
    rads_per_row = lidar.elevation_range_rad / max(E - 1, 1)
    el = (lidar.max_angle_above_zero_elevation_rad
          - (np.arange(E) + row_offset) * rads_per_row)
    el, az = np.meshgrid(el, az, indexing="ij")
    return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.sin(el)], -1).reshape(-1, 3).astype(np.float32)


def _jax_lidar_scan(scene, lidar, T, num_steps=96):
    """chip_smoke.py's `lidar_scan` in the reference's own terms."""
    T = jnp.asarray(T)
    dirs_S = jnp.asarray(lidar_rays(lidar))
    dirs_L = dirs_S @ T[:3, :3].T
    t = jnp.full((dirs_S.shape[0],), 1e-3, jnp.float32)
    for _ in range(num_steps):
        d = scene.sdf(dirs_L * t[:, None] + T[:3, 3])
        t = jnp.minimum(t + jnp.where(d > 1e-4, d, 0.0),
                        2.0 * lidar.max_valid_range_m)
    hit = ((scene.sdf(dirs_L * t[:, None] + T[:3, 3]) < 1e-3)
           & (t < lidar.max_valid_range_m))
    return np.asarray(jnp.where(hit[:, None], dirs_S * t[:, None], 0.0))


def lidar_reference():
    """The reference's CPU run of chip_smoke.py's lidar path: the node's
    lidar (1800 x 16, 30 deg, 0.1 m), 64 scans of the cluttered two-room
    scene (32 per room), 7 m integration; the TSDF scored before the
    clearing, then the same clearing."""
    from isaac_ros_nvblox_tpu.models.lidar import (Lidar,
                                                   pointcloud_to_range_image)
    lidar = Lidar.equal_vertical_fov(1800, 16, float(np.radians(30.0)),
                                     min_range_m=0.1)
    scene = js.cluttered_multi_room_scene()
    poses = lidar_orbit_poses()
    scans = [_jax_lidar_scan(scene, lidar, T) for T in poses]
    mb = _bucket(max(int(np.asarray(jv.touched_block_grid_lidar(
        pointcloud_to_range_image(jnp.asarray(p), lidar), jnp.asarray(T),
        lidar=lidar, voxel_size_m=VOXEL, max_distance_m=7.0,
        truncation_m=0.2)[0]).sum()) for p, T in zip(scans, poses)))
    m = JMapper(VOXEL, params=JParams(projective=JTsdf(
        max_integration_distance_m=7.0)), world=jwg.WorldGridConfig(**WORLD),
        enable_color=False, enable_esdf=False, max_blocks_per_frame=mb)
    for p, T in zip(scans, poses):
        m.integrate_pointcloud(p, T, lidar)
    n = int(m.state.alloc_count)
    bidx = np.asarray(m.state.block_index_of_slot)[:n]
    gt = np.asarray(scene.sdf(voxel_centers_for_blocks(jnp.asarray(bidx),
                                                       VOXEL)))
    d = np.asarray(m.channels["tsdf_distance"])[:n]
    w = np.asarray(m.channels["tsdf_weight"])[:n]
    near = (np.abs(gt) < 0.1) & (w > 0.5)
    out = {"max_blocks_per_frame": mb, "allocated_blocks": m.block_count(),
           "overflow_count": int(m.state.overflow_count),
           "ray_hit_share": float(np.mean(np.abs(np.stack(scans)).sum(-1)
                                          > 0)),
           "tsdf_mae_m": float(np.mean(np.abs(d[near] - gt[near]))),
           "tsdf_voxels_scored": int(near.sum())}
    m.clear_outside_radius(poses[-1][:3, 3], 5.0)
    w_before = int((np.asarray(m.channels["tsdf_weight"]) > 0).sum())
    m.clear_tsdf_inside_shapes(spheres=[((3.8, 1.0, 0.3), 0.5)])
    out["blocks_freed_by_clear_outside_radius"] = int(m.removed_count)
    out["blocks_after_clearing"] = m.block_count()
    out["voxels_unobserved_by_sphere"] = w_before - int(
        (np.asarray(m.channels["tsdf_weight"]) > 0).sum())
    return out


# The intruder of tools/dynamics_quality.py:80-91: a 0.25 m sphere flying
# across the room through confident freespace, one position per frame.
def intruder_center(k):
    t = k / 7.0
    return (-1.6 + 3.2 * t, 1.4 - 2.2 * t, 1.0)


def dynamics_reference():
    """The reference's CPU run of the scored part of chip_smoke.py's
    `dynamic_frames` phase (its XLA path, `use_pallas` false): the room and
    box of tools/dynamics_quality.py without the sphere, the 16-frame VGA
    orbit 4x over at 300 ms spacing through `replay_frames_dynamic` in two
    calls (frames 0-15 without a region, then frames 16-63 over the
    allocated AABB); the 8 intruder frames detected on that map and scored
    against the geometric ground truth as the tool scores them; then the 8
    frames through the eager `integrate_depth`, and the dynamic map's
    occupied voxels."""
    import dataclasses
    from isaac_ros_nvblox_tpu.mapper.multi_mapper import (
        MultiMapper, _detect_dynamic_fused)
    from isaac_ros_nvblox_tpu.mapper.params import (MappingType,
                                                    MultiMapperParams)
    jcam = jc.Camera(**ARGS)
    prims = SCENE.primitives[:1] + SCENE.primitives[2:]
    room = js.Scene(primitives=prims)
    poses = [js.orbit_pose(2 * np.pi * k / 16, radius=1.5) for k in range(16)]
    depths = [np.asarray(js.render_depth(room, jcam, jnp.asarray(T)))
              for T in poses]
    mm = MultiMapper(
        MultiMapperParams(mapping_type=MappingType.DYNAMIC,
                          block_capacity=16384,
                          static_mapper=dataclasses.replace(
                              JParams(projective=JTsdf(
                                  max_integration_distance_m=5.0)),
                              remove_small_connected_components=False)),
        world=jwg.WorldGridConfig(**WORLD))
    sm = mm.static_mapper
    sm.use_pallas_integrate = False
    mm.dynamic_mapper.use_pallas_integrate = False
    depths_r = jnp.asarray(np.stack(depths * 4))
    poses_r = jnp.asarray(np.stack(poses * 4))
    times = jnp.asarray(300.0 * np.arange(64), jnp.float32)
    mm.replay_frames_dynamic(depths_r[:16], poses_r[:16], times[:16], jcam)
    sm._refresh_region_from_device()
    region = sm.esdf_region(margin_blocks=0, mult=1)
    mm.replay_frames_dynamic(depths_r[16:], poses_r[16:], times[16:], jcam,
                             region=region)
    hc = sm.channels["freespace_high_confidence"]
    out = {"high_confidence_voxels": int(jnp.sum(hc)),
           "region_origin": [int(v) for v in region[0]],
           "region_dims_blocks": [int(v) for v in region[1]],
           "allocated_blocks": sm.block_count(),
           "overflow_count": int(sm.state.overflow_count), "frames": []}
    intr = []
    for k in range(8):
        scene = js.Scene(primitives=prims + (js.Sphere(
            center=intruder_center(k), radius=0.25),))
        T = poses[k % 16]
        d_static = np.asarray(js.render_depth(room, jcam, jnp.asarray(T)))
        d_intr = np.asarray(js.render_depth(scene, jcam, jnp.asarray(T)))
        gt = ((d_intr < d_static - 2 * VOXEL) & (d_intr > 0)
              & (d_intr <= 5.0))
        mask, _ = _detect_dynamic_fused(
            sm.state, hc, jnp.asarray(d_intr), jnp.asarray(T), camera=jcam,
            voxel_size_m=VOXEL, max_depth_m=5.0, subsample=1)
        mask = np.asarray(mask)
        out["frames"].append({
            "gt_pixels": int(gt.sum()), "detected": int(mask.sum()),
            "tpr": float((mask & gt).sum() / max(gt.sum(), 1)),
            "fpr": float((mask & ~gt).sum() / max((~gt).sum(), 1))})
        intr.append((d_intr, T))
    for k, (d_intr, T) in enumerate(intr):
        mm.integrate_depth(d_intr, T, jcam, time_ms=300.0 * (64 + k))
    lo = np.asarray(mm.dynamic_mapper.channels["occupancy_log_odds"])
    out["mean_tpr"] = float(np.mean([f["tpr"] for f in out["frames"]]))
    out["dynamic_occupied_voxels"] = int((lo > 0).sum())
    out["dynamic_overflow_count"] = int(
        mm.dynamic_mapper.state.overflow_count)
    return out


# chip_smoke.py's node_ticks run: a tick every 10 ms for 1.6 s, the
# orbit's depth and color at 40 Hz, an 1800 x 16 scan every 100 ms while
# the lidar moves (`node_lidar_pose`), poses at 100 Hz, lookups snapped to
# a pose only within 1 ms.
NODE_TICKS, NODE_TICK_MS, NODE_FRAME_MS, NODE_SCAN_MS = 161, 10, 25, 100


def node_lidar_pose(t_s):
    """chip_smoke.py's `node_lidar_pose`."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (-0.4 + 0.5 * t_s, -1.5, 2.2)
    return T


def _jax_node_scan(scene, lidar, stamp_s, num_steps=96):
    """chip_smoke.py's `node_scan` in the reference's own terms."""
    dirs = jnp.asarray(lidar_rays(lidar))
    A = lidar.num_azimuth_divisions
    rel = np.tile(np.arange(A) * (NODE_SCAN_MS / 1e3 / A),
                  lidar.num_elevation_divisions)
    origins = jnp.asarray(np.tile(np.stack(
        [node_lidar_pose(stamp_s + r)[:3, 3] for r in rel[:A]]),
        (lidar.num_elevation_divisions, 1)))
    t = jnp.full((dirs.shape[0],), 1e-3, jnp.float32)
    for _ in range(num_steps):
        d = scene.sdf(dirs * t[:, None] + origins)
        t = jnp.minimum(t + jnp.where(d > 1e-4, d, 0.0),
                        2.0 * lidar.max_valid_range_m)
    hit = ((scene.sdf(dirs * t[:, None] + origins) < 1e-3)
           & (t < lidar.max_valid_range_m))
    return np.asarray(jnp.where(hit[:, None], dirs * t[:, None], 0.0)), rel


def node_reference():
    """The reference's CPU run of chip_smoke.py's node_ticks phase: its
    `NvbloxNode` with the node's and the mapper's defaults on the bench
    world, the same frames (rendered by the reference), scans, poses and
    clock. Only the 2-D slice is subscribed: the mesh and layer publishes
    change no map."""
    from isaac_ros_nvblox_tpu.mapper.params import MultiMapperParams
    from isaac_ros_nvblox_tpu.runtime.node import NodeParams, NvbloxNode
    from isaac_ros_nvblox_tpu.utils.timing import Timing
    jcam = jc.Camera(**ARGS)
    poses, depths = _frames(jcam)
    colors = [np.array(js.render_color(SCENE, jcam, jnp.asarray(T)))
              for T in poses]
    node = NvbloxNode(NodeParams(), MultiMapperParams(),
                      world=jwg.WorldGridConfig(**WORLD))
    node.transformer.timestamp_tolerance_s = 0.001
    clock = [0.0]
    node.clock = lambda: clock[0]
    slices = []
    node.bus.subscribe("~/static_map_slice", slices.append)
    n_scans = (NODE_TICKS - 1) * NODE_TICK_MS // NODE_SCAN_MS
    scans = [_jax_node_scan(SCENE, node.lidar, m * NODE_SCAN_MS / 1e3)
             for m in range(n_scans)]
    Timing.reset()
    next_frame = 0
    for i in range(NODE_TICKS):
        ms = i * NODE_TICK_MS
        now = ms / 1e3
        node.add_pose("cam", now, js.orbit_pose(
            2 * np.pi * (ms / NODE_FRAME_MS) / 16, radius=1.5))
        node.add_pose("lidar", now, node_lidar_pose(now))
        node.add_pose("base_link", now, node_lidar_pose(now))
        while next_frame < 64 and next_frame * NODE_FRAME_MS <= ms:
            k = next_frame
            stamp = k * NODE_FRAME_MS / 1e3
            node.add_depth_image(depths[k % 16], jcam, "cam", stamp)
            node.add_color_image(colors[k % 16], jcam, "cam", stamp)
            next_frame += 1
        if ms >= NODE_SCAN_MS and ms % NODE_SCAN_MS == 0:
            m = ms // NODE_SCAN_MS - 1
            node.add_pointcloud(scans[m][0], "lidar", m * NODE_SCAN_MS / 1e3,
                                timestamps_s=scans[m][1])
        clock[0] = now
        node.tick()
    m = node.multi_mapper.static_mapper
    n = int(m.state.alloc_count)
    bidx = np.asarray(m.state.block_index_of_slot)[:n]
    gt = np.asarray(SCENE.sdf(voxel_centers_for_blocks(jnp.asarray(bidx),
                                                       VOXEL)))
    d = np.asarray(m.channels["tsdf_distance"])[:n]
    w = np.asarray(m.channels["tsdf_weight"])[:n]
    near = (np.abs(gt) < 0.1) & (w > 0.5)
    last = slices[-1]
    return {"tsdf_mae_m": float(np.mean(np.abs(d[near] - gt[near]))),
            "tsdf_voxels_scored": int(near.sum()),
            "allocated_blocks": m.block_count(),
            "overflow_count": int(m.state.overflow_count),
            "depth_frames_integrated":
                Timing.get("node/depth/integrate").count,
            "color_frames_integrated":
                Timing.get("node/color/integrate").count,
            "scans_integrated": Timing.get("node/lidar/integrate").count,
            "slices_published": len(slices),
            "last_slice_shape": [int(last.height), int(last.width)],
            "last_slice_known_cells": int(
                (np.asarray(last.data) != last.unknown_value).sum())}


def _node_subscribers(node, topics, adapter, costmap):
    """chip_smoke.py's `subscribe_node` on a reference node, with the
    reference's mesh layer adapter and costmap layer: a counter on each
    topic and the 2-D slices kept."""
    subs = {"counts": {t: 0 for t in topics}, "slices": []}
    if "~/mesh" in topics:
        adapter(node.bus)
    subs["costmap"] = costmap(node.bus)
    node.bus.subscribe("~/static_map_slice", subs["slices"].append)
    for topic in topics:
        node.bus.subscribe(topic, lambda msg, topic=topic: subs[
            "counts"].__setitem__(topic, subs["counts"][topic] + 1))
    return subs


def _jax_node_mode_figures(node, subs, scene):
    """chip_smoke.py's `node_mode_figures` of a reference node."""
    from isaac_ros_nvblox_tpu.mapper.params import EsdfMode
    from isaac_ros_nvblox_tpu.utils.timing import Timing
    mm = node.multi_mapper
    sm, dm = mm.static_mapper, mm.dynamic_mapper
    n = int(sm.state.alloc_count)
    live = np.asarray(jwg.live_slot_mask(sm.state))[:n]
    bidx = np.where(live[:, None],
                    np.asarray(sm.state.block_index_of_slot)[:n], 0)
    gt = np.asarray(scene.sdf(voxel_centers_for_blocks(jnp.asarray(bidx),
                                                       VOXEL)))
    live = live[:, None]
    ch = {k: np.asarray(v)[:n] for k, v in sm.channels.items()}
    last = subs["slices"][-1] if subs["slices"] else None
    out = {"allocated_blocks": sm.block_count(),
           "overflow_count": int(sm.state.overflow_count),
           "depth_frames_integrated": Timing.get(
               "node/depth/integrate").count,
           "color_frames_integrated": Timing.get(
               "node/color/integrate").count,
           "scans_integrated": Timing.get("node/lidar/integrate").count,
           "slices_published": len(subs["slices"]),
           "last_slice_shape": (None if last is None
                                else [int(last.height), int(last.width)]),
           "last_slice_known_cells": (None if last is None else int(
               (np.asarray(last.data) != last.unknown_value).sum())),
           "messages": subs["counts"], "costmap": subs["costmap"].has_data}
    if "tsdf_distance" in ch:
        near = live & (np.abs(gt) < 0.1) & (ch["tsdf_weight"] > 0.5)
        out["tsdf_mae_m"] = float(np.mean(np.abs(ch["tsdf_distance"]
                                                 - gt)[near]))
    else:
        half = sm.params.occupancy.occupied_region_half_width_m
        occupied = (live & (ch["occupancy_observed"] > 0)
                    & (ch["occupancy_log_odds"] > 0))
        near = np.abs(gt) <= half + VOXEL * np.sqrt(3.0) / 2
        out["occupied_voxels"] = int(occupied.sum())
        out["occupied_near_surface_share"] = (
            int((occupied & near).sum()) / max(int(occupied.sum()), 1))
    if dm is not None:
        out["dynamic_blocks"] = dm.block_count()
        out["dynamic_overflow_count"] = int(dm.state.overflow_count)
        out["dynamic_occupied_voxels"] = int(
            (np.asarray(dm.channels["occupancy_log_odds"]) > 0).sum())
    if mm.params.esdf_mode == EsdfMode.K3D:
        sq = ch["esdf_sq_dist"]
        est = np.minimum(np.sqrt(np.minimum(sq, 1e12)) * VOXEL, 2.0)
        est = np.where(ch["esdf_is_inside"], -est, est)
        emask = live & (gt > 3 * VOXEL) & (gt < 1.0) & (sq < 1e11)
        out["esdf_mae_m"] = float(np.mean(np.abs(est - gt)[emask]))
    return out


def _numpy_dense_edt(is_site, block_index_of_slot, alloc_count, origin_b, *,
                     dims_b, band, interpret=False):
    """The reference's dense EDT through its numpy twin
    (`esdf_from_sites_reference`, which tests/test_esdf_dense.py holds
    equal to it bit for bit): on the CPU the reference runs its EDT
    kernels in interpret mode, hours for the 3-D node's regions."""
    cap = is_site.shape[0]

    def solve(site, bidx, n, origin):
        return jed.esdf_from_sites_reference(
            np.asarray(site), np.asarray(bidx) - np.asarray(origin), int(n),
            tuple(dims_b), band).astype(np.float32)

    return jax.pure_callback(
        solve, jax.ShapeDtypeStruct((cap, 512), jnp.float32), is_site,
        block_index_of_slot, alloc_count, origin_b)


def node_modes_reference():
    """The reference's CPU run of chip_smoke.py's node_modes phase, and the
    port's CPU run (`device="cpu"`) of the same inputs: for each part of
    chip_smoke.NODE_MODES the package's `NvbloxNode` built as the part
    builds it, on the bench world, over node_ticks' clock and inputs
    (chip_smoke.drive_node; the frames, scans and intruder rendered by the
    reference, host arrays for both) with the part's subscribers; then
    chip_smoke.node_mode_figures of each. The reference's dense EDT runs
    through its numpy twin (`_numpy_dense_edt`)."""
    import chip_smoke as cs
    from isaac_ros_nvblox_tpu.mapper import params as jp
    from isaac_ros_nvblox_tpu.runtime import adapters as ja
    from isaac_ros_nvblox_tpu.runtime import costmap as jcm
    from isaac_ros_nvblox_tpu.runtime import node as jn
    from isaac_ros_nvblox_tpu.utils.timing import Timing as JTiming
    from isaac_ros_nvblox_tpu_torch.mapper import params as tp
    from isaac_ros_nvblox_tpu_torch.models import scene as ts
    from isaac_ros_nvblox_tpu_torch.runtime import node as tn
    from isaac_ros_nvblox_tpu_torch.utils.timing import Rates, Timing
    jcam, tcam = jc.Camera(**ARGS), tc.Camera(**ARGS)
    poses, depths = _frames(jcam)
    colors = [np.array(js.render_color(SCENE, jcam, jnp.asarray(T)))
              for T in poses]
    base = {"depths": [depths[k % 16] for k in range(64)],
            "colors": [colors[k % 16] for k in range(64)], "n_orbit": 16}
    orbit = []
    for k in range(16):
        sc = js.Scene(primitives=SCENE.primitives + (js.Sphere(
            center=intruder_center(k % 8), radius=0.25),))
        T = jnp.asarray(poses[k])
        orbit.append((np.array(js.render_depth(sc, jcam, T)),
                      np.array(js.render_color(sc, jcam, T))))
    intr = {"depths": [orbit[k % 16][0] for k in range(64)],
            "colors": [orbit[k % 16][1] for k in range(64)], "n_orbit": 16}
    from isaac_ros_nvblox_tpu.models.lidar import Lidar
    p = jn.NodeParams()
    lidar = Lidar.equal_vertical_fov(p.lidar_width, p.lidar_height,
                                     p.lidar_vertical_fov_rad,
                                     min_range_m=p.lidar_min_valid_range_m)
    scans = [_jax_node_scan(SCENE, lidar, m * NODE_SCAN_MS / 1e3)
             for m in range((NODE_TICKS - 1) * NODE_TICK_MS // NODE_SCAN_MS)]
    tscene = ts.Scene(primitives=(
        ts.RoomBox(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
        ts.Sphere(center=(1.2, 0.8, 1.0), radius=0.5),
        ts.Box(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4))))
    jed.esdf_from_sites_dense = _numpy_dense_edt
    out = {}
    for part, (path, mode, overlay, node_kw, intruder, with_scans,
               topics) in cs.NODE_MODES.items():
        inp = dict(intr if intruder else base, scans=scans)
        row = {"path": path, "mode": mode, "overlay": overlay,
               "node_params": node_kw}
        node = jn.NvbloxNode(jn.NodeParams(**node_kw),
                             jp.make_params(mode, overlay),
                             world=jwg.WorldGridConfig(**WORLD))
        node.transformer.timestamp_tolerance_s = cs.NODE_POSE_TOLERANCE_S
        clock = [0.0]
        node.clock = lambda: clock[0]
        subs = _node_subscribers(node, topics, ja.MeshLayerAdapter,
                                 jcm.NvbloxCostmapLayer)
        JTiming.reset()
        cs.drive_node(node, clock, jcam, inp, scans=with_scans)
        row["reference"] = _jax_node_mode_figures(node, subs, SCENE)
        del node
        node = tn.NvbloxNode(tn.NodeParams(**node_kw),
                             tp.make_params(mode, overlay),
                             world=twg.WorldGridConfig(**WORLD), device="cpu")
        node.transformer.timestamp_tolerance_s = cs.NODE_POSE_TOLERANCE_S
        node.clock = lambda: clock[0]
        subs = cs.subscribe_node(node, topics)
        Timing.reset()
        Rates.reset()
        ticks = cs.drive_node(node, clock, tcam, inp, scans=with_scans)
        st = cs.node_run_figures(node, subs, ticks)
        row["port_cpu"] = dict(cs.node_mode_figures(node, st, tscene, VOXEL),
                               costmap=st["costmap"])
        out[part] = row
        print(json.dumps({part: row}), flush=True)
    return out


def fuser_reference():
    """The reference's figures for chip_smoke.py's `fuser` phase (a):
    `SyntheticDataLoader`'s 64-frame orbit (radius 2 m) of the bench room
    at Replica's default camera (1200x680, fx = fy = 600) through the
    fuser's world and defaults (7 m, 16384 slots). TSDF only (color does
    not move it) through the XLA path, then the ESDF of the final map over
    its allocated region with the numpy EDT (the fuser's incremental
    updates solve the same field); blocks, `tsdf_mae_m`, `esdf_mae_m`."""
    from isaac_ros_nvblox_tpu.datasets.synthetic import SyntheticDataLoader
    cam = jc.Camera(fx=600.0, fy=600.0, cx=599.5, cy=339.5, width=1200,
                    height=680)
    world = dict(dims=(128, 128, 32), capacity=16384,
                 origin_block=(-64, -64, -8))
    jm = JMapper(VOXEL, world=jwg.WorldGridConfig(**world),
                 enable_color=False, enable_esdf=False)
    tm = tdm.DeviceMapper(VOXEL, world=twg.WorldGridConfig(**world),
                          device="cpu")
    for frame in SyntheticDataLoader(num_frames=64, scene=SCENE, camera=cam,
                                     with_color=False):
        jm.integrate_depth(jnp.asarray(frame.depth), jnp.asarray(frame.T_L_C),
                           cam)
        tm._touch_region(np.asarray(frame.T_L_C), tc.Camera(
            fx=600.0, fy=600.0, cx=599.5, cy=339.5, width=1200, height=680))
    n = jm.block_count()
    bidx = np.asarray(jm.state.block_index_of_slot)
    d_j = np.asarray(jm.channels["tsdf_distance"])
    w_j = np.asarray(jm.channels["tsdf_weight"])
    origin, dims = tm.esdf_region(margin_blocks=0, mult=1)
    _, inside, ref_sq = _reference_esdf(d_j, w_j, bidx, n, origin, dims)
    centers = np.asarray(voxel_centers_for_blocks(jnp.asarray(bidx[:n]),
                                                  VOXEL))
    tsdf_mae, esdf_mae = _scores(np.asarray(SCENE.sdf(centers)), d_j[:n],
                                 w_j[:n], ref_sq[:n], inside[:n])
    return {"allocated_blocks": int(n), "tsdf_mae_m": tsdf_mae,
            "esdf_mae_m": esdf_mae}


def _human_frames(n_frames=64):
    """chip_smoke.py's human_frames inputs, rendered by the reference: the
    bench orbit 4x over, the person at its place in each frame; (depth,
    mask in the mask camera, pose) per frame."""
    from test_torch_human import VGA, human_frame
    jcam = jc.Camera(**VGA)
    render = lambda sc, c, T: np.asarray(js.render_depth(sc, c,
                                                         jnp.asarray(T)))
    poses = [js.orbit_pose(2 * np.pi * k / 16, radius=1.5)
             for k in range(16)]
    out = []
    for k in range(n_frames):
        T = poses[k % 16]
        depth, mask, _ = human_frame(render, js, jcam, jcam.scaled(0.5), T, k,
                                     n_frames)
        out.append((depth, mask, T))
    return jcam, out


def _person_voxels(centers, keep):
    """Voxels of the person's swept box above the floor band (z >= 2
    voxels) where `keep` holds."""
    from test_torch_human import person_swept_box
    lo, hi = person_swept_box()
    lo[2] = 2 * VOXEL
    inside = np.all((centers >= lo) & (centers <= hi), axis=-1)
    return int((inside & keep).sum())


def human_reference():
    """The reference's CPU run of chip_smoke.py's human_frames (a) and
    (b): its MultiMapper from nvblox_base.yaml + nvblox_segmentation.yaml
    (human_with_static_tsdf, the 2000 px connected-component filter; (b)
    the same with human_with_static_occupancy) on the bench world; the 64
    VGA frames through `integrate_depth(depth, T, camera, mask,
    mask_camera, T_CM_CD)` with the 320 x 240 mask camera, the dynamic
    layer's decay every 4th frame. Figures: the blocks of both mappers;
    the static TSDF's error against the room without the person; the
    static map's person voxels (in the person's swept box above the floor
    band: TSDF weight > 0.5 and distance < 1 voxel, or occupied); the
    dynamic map's occupied voxels; the masked pixels after the filter."""
    from isaac_ros_nvblox_tpu.mapper.multi_mapper import MultiMapper
    from isaac_ros_nvblox_tpu.runtime.config_loader import load_config
    from test_torch_human import ROOM, t_cm_cd
    from pathlib import Path
    jcam, frames = _human_frames()
    cfg = Path(__file__).resolve().parent.parent / "examples/config/nvblox"
    _, params = load_config([cfg / "nvblox_base.yaml",
                             cfg / "specializations/nvblox_segmentation.yaml"])
    room = js.Scene(primitives=(js.RoomBox(**ROOM[0]), js.Sphere(**ROOM[1]),
                                js.Box(**ROOM[2])))
    out = {"config": params.mapping_type.value,
           "cc_threshold_px": params.static_mapper
           .connected_mask_component_size_threshold}
    for mode in ("human_with_static_tsdf", "human_with_static_occupancy"):
        from isaac_ros_nvblox_tpu.mapper.params import apply_overlay
        mm = MultiMapper(apply_overlay(params, {"mapping_type": mode}),
                         world=jwg.WorldGridConfig(**WORLD))
        masked = []
        for k, (depth, mask, T) in enumerate(frames):
            mm.integrate_depth(depth, T, jcam, mask=mask,
                               mask_camera=jcam.scaled(0.5),
                               T_CM_CD=t_cm_cd())
            masked.append(int((np.asarray(mm.last_dynamic_mask) > 0).sum()))
            if k % 4 == 3:
                mm.decay_dynamic()
        sm, dm = mm.static_mapper, mm.dynamic_mapper
        n = int(sm.state.alloc_count)
        bidx = np.asarray(sm.state.block_index_of_slot)[:n]
        centers = np.asarray(voxel_centers_for_blocks(jnp.asarray(bidx),
                                                      VOXEL))
        row = {"static_blocks": sm.block_count(),
               "dynamic_blocks": dm.block_count(),
               "static_overflow": int(sm.state.overflow_count),
               "dynamic_overflow": int(dm.state.overflow_count),
               "masked_pixels": masked,
               "dynamic_occupied_voxels": int((np.asarray(
                   dm.channels["occupancy_log_odds"]) > 0).sum())}
        if "tsdf_distance" in sm.channels:
            d = np.asarray(sm.channels["tsdf_distance"])[:n]
            w = np.asarray(sm.channels["tsdf_weight"])[:n]
            gt = np.asarray(room.sdf(centers))
            near = (np.abs(gt) < 0.1) & (w > 0.5)
            row["tsdf_mae_m"] = float(np.mean(np.abs(d[near] - gt[near])))
            row["tsdf_voxels_scored"] = int(near.sum())
            row["static_person_voxels"] = _person_voxels(
                centers, (w > 0.5) & (d < VOXEL))
        else:
            lo = np.asarray(sm.channels["occupancy_log_odds"])[:n]
            obs = np.asarray(sm.channels["occupancy_observed"])[:n] > 0
            row["static_occupied_voxels"] = int((obs & (lo > 0)).sum())
            row["static_person_voxels"] = _person_voxels(centers,
                                                         obs & (lo > 0))
        out[mode] = row
    return out


def human_port_reference():
    """The port's CPU run (`device="cpu"`) of chip_smoke.py's human_frames
    (a) and (b) on two renders of the 64 frames: the reference's
    (`_human_frames`, the inputs of `--human`) and the port's own
    (chip_smoke.human_inputs on the CPU, the card's inputs rendered by the
    CPU). Each mode's MultiMapper as `human_reference` drives it; figures
    by chip_smoke.human_map_figures."""
    from pathlib import Path
    import chip_smoke as cs
    from isaac_ros_nvblox_tpu_torch.mapper.multi_mapper import MultiMapper
    from isaac_ros_nvblox_tpu_torch.mapper.params import apply_overlay
    from isaac_ros_nvblox_tpu_torch.runtime.config_loader import load_config
    from test_torch_human import VGA, t_cm_cd
    cfg = Path(__file__).resolve().parent.parent / "examples/config/nvblox"
    _, params = load_config([cfg / "nvblox_base.yaml",
                             cfg / "specializations/nvblox_segmentation.yaml"])
    tcam = tc.Camera(**VGA)
    _, ref_frames = _human_frames()
    static_scene, inp = cs.human_inputs("cpu", tcam, VOXEL)
    sources = {"reference_render": ref_frames,
               "port_render": [(d.numpy(), m.numpy(), T) for d, m, T in zip(
                   inp["depths"], inp["masks"], inp["poses"])]}
    out = {}
    for src, frames in sources.items():
        out[src] = {}
        for mode in ("human_with_static_tsdf", "human_with_static_occupancy"):
            mm = MultiMapper(apply_overlay(params, {"mapping_type": mode}),
                             world=twg.WorldGridConfig(**WORLD), device="cpu")
            for k, (depth, mask, T) in enumerate(frames):
                mm.integrate_depth(depth, T, tcam, mask=mask,
                                   mask_camera=tcam.scaled(0.5),
                                   T_CM_CD=t_cm_cd())
                if k % 4 == 3:
                    mm.decay_dynamic()
            out[src][mode] = cs.human_map_figures(mm, static_scene, VOXEL)
    return out


def scenes_reference():
    """The reference's CPU run of chip_smoke.py's `scenes` phase:
    bench.py:464-575's large scene (a 10 x 7.2 x 3.2 m room, its three
    primitives, 7 m, the radius-2.0 orbit) and sparse scene (a floor slab
    and an object cluster, 5 m, the radius-1.8 orbit), each 16 VGA frames
    4x over through its XLA TSDF path with bench.py's batch rule, then the
    ESDF of the final map over its allocated region (the numpy EDT, equal
    to the reference's kernels); blocks, `tsdf_mae_m`, `esdf_mae_m`
    (bench.py:628-646)."""
    jcam = jc.Camera(**ARGS)
    large = js.Scene(primitives=(
        js.RoomBox(center=(0.0, 0.0, 1.6), half_extents=(5.0, 3.6, 1.6)),
        js.Sphere(center=(1.2, 0.8, 1.0), radius=0.5),
        js.Box(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4)),
        js.Box(center=(2.8, -1.8, 0.6), half_extents=(0.5, 0.3, 0.6))))
    sparse = js.Scene(primitives=(
        js.Box(center=(0.0, 0.0, -0.1), half_extents=(3.0, 3.0, 0.1)),
        js.Box(center=(0.0, 0.0, 0.45), half_extents=(0.25, 0.25, 0.45)),
        js.Box(center=(0.0, -0.22, 1.1), half_extents=(0.25, 0.03, 0.35)),
        js.Sphere(center=(0.35, 0.3, 0.5), radius=0.18)))
    out = {}
    for name, scene, radius, max_d in (("large", large, 2.0, 7.0),
                                       ("sparse", sparse, 1.8, 5.0)):
        poses = [js.orbit_pose(2 * np.pi * k / 16, radius=radius)
                 for k in range(16)]
        depths = [np.asarray(js.render_depth(scene, jcam, jnp.asarray(T)))
                  for T in poses]
        trunc = JTsdf(max_integration_distance_m=max_d).truncation_m(VOXEL)
        worst = max(int(np.asarray(jv.touched_block_grid(
            jnp.asarray(d), jnp.asarray(T), camera=jcam, voxel_size_m=VOXEL,
            max_distance_m=max_d, truncation_m=trunc, subsample=1)[0]).sum())
            for d, T in zip(depths, poses))
        # bench.py's pick_max_blocks: buckets up to 4096.
        mb = next((b for b in (512, 1024, 2048, 4096) if worst <= b - 64),
                  4096)
        jm = JMapper(VOXEL, params=JParams(projective=JTsdf(
            max_integration_distance_m=max_d)),
            world=jwg.WorldGridConfig(**WORLD), enable_color=False,
            enable_esdf=False, max_blocks_per_frame=mb)
        for depth, T in list(zip(depths, poses)) * 4:
            jm.integrate_depth(depth, jnp.asarray(T), jcam)
        n = jm.block_count()
        bidx = np.asarray(jm.state.block_index_of_slot)
        d_j = np.asarray(jm.channels["tsdf_distance"])
        w_j = np.asarray(jm.channels["tsdf_weight"])
        origin, dims = _live_region(jm.state)
        _, inside, sq = _reference_esdf(d_j, w_j, bidx, n, origin, dims)
        centers = np.asarray(voxel_centers_for_blocks(jnp.asarray(bidx[:n]),
                                                      VOXEL))
        tsdf_mae, esdf_mae = _scores(np.asarray(scene.sdf(centers)), d_j[:n],
                                     w_j[:n], sq[:n], inside[:n])
        out[name] = {"max_blocks_per_frame": mb, "worst_frame_blocks": worst,
                     "allocated_blocks": int(n),
                     "overflow_count": int(jm.state.overflow_count),
                     "esdf_region_origin": [int(v) for v in origin],
                     "esdf_region_dims_blocks": list(dims),
                     "tsdf_mae_m": tsdf_mae, "esdf_mae_m": esdf_mae}
    return out


def main():
    import sys
    for flag, fn, config in (
            ("--dynamics", dynamics_reference,
             "chip_smoke dynamic_frames scored part: bench room + box, "
             "16-frame 640x480 orbit x4 at 300 ms, 0.05 m, 5 m, 16384 "
             "slots; 8 intruder frames (0.25 m sphere)"),
            ("--occupancy", occupancy_reference,
             "chip_smoke occupancy path: bench scene, 16-frame 640x480 orbit "
             "x4, 0.05 m, occupancy 7 m / 0.1 m, decay every 8th, band 40"),
            ("--lidar", lidar_reference,
             "chip_smoke lidar path: cluttered two-room scene, 64 scans of "
             "an 1800x16 30-degree lidar (beams a quarter row off the row "
             "boundaries), 0.05 m, 7 m"),
            ("--fuser", fuser_reference,
             "chip_smoke fuser phase (a): bench room, SyntheticDataLoader's "
             "64-frame orbit at Replica's default 1200x680 camera, fuser "
             "world 128x128x32 blocks, 16384 slots, 0.05 m, 7 m, band 40"),
            ("--human", human_reference,
             "chip_smoke human_frames (a), (b): nvblox_base.yaml + "
             "nvblox_segmentation.yaml on the bench world (64x64x32 blocks, "
             "16384 slots) and room with a 0.5x0.3x1.7 m person walking "
             "along y = -1.85 m; the 16-frame 640x480 orbit x4; the mask "
             "at 320x240 from a camera 4 cm and 2 degrees off; decay of "
             "the dynamic layer every 4th frame"),
            ("--human-port", human_port_reference,
             "chip_smoke human_frames (a), (b) through the port on the CPU, "
             "on the reference's render of the 64 frames and on the port's"),
            ("--scenes", scenes_reference,
             "chip_smoke scenes: bench.py's large (10x7.2x3.2 m room, 7 m, "
             "orbit radius 2.0) and sparse (floor slab + object cluster, "
             "5 m, radius 1.8) scenes, 16-frame 640x480 orbit x4, 0.05 m, "
             "band 40"),
            ("--node-modes", node_modes_reference,
             "chip_smoke node_modes: NvbloxNode in static_occupancy (no "
             "scans, use_lidar false), dynamic (the intruder sphere crossing "
             "the room every 8 frames) and static tsdf with esdf 3d, on "
             "node_ticks' world, clock, frames, scans and subscribers"),
            ("--node", node_reference,
             "chip_smoke node_ticks: NvbloxNode defaults (static tsdf, "
             "esdf 2d, 16384 slots) on the bench world and room; 161 ticks "
             "10 ms apart; 64 640x480 depth + color frames at 40 Hz, 16 "
             "moving 1800x16 scans at 10 Hz, poses at 100 Hz")):
        if flag in sys.argv:
            print(json.dumps({"config": config,
                              "backend": jax.default_backend(),
                              "reference": fn()}))
            return
    if "--mesh" in sys.argv:
        print(json.dumps({
            "config": "bench mesh accuracy: cluttered two-room scene, 24 "
                      "640x480 frames, penalty weighting, min_weight 0.02",
            "backend": jax.default_backend(),
            "reference": mesh_reference()}))
        return
    r = run()
    (tsdf_ref, esdf_ref), (tsdf_port, esdf_port) = r["ref"], r["port"]
    (tsdf_pal, esdf_pal), site_pal = pallas_scores(r)
    floor = r["centers"][..., 2] < 0.1
    print(json.dumps({
        "config": "bench scene, 16-frame 640x480 orbit x4, 0.05 m, 5 m, band 40",
        "backend": jax.default_backend(), "allocated_blocks": r["n"],
        "esdf_region_origin": [int(v) for v in r["region"][0]],
        "esdf_region_dims_blocks": list(r["region"][1]),
        "reference_tsdf_mae_m": tsdf_ref, "reference_esdf_mae_m": esdf_ref,
        "port_tsdf_mae_m": tsdf_port, "port_esdf_mae_m": esdf_port,
        "reference_esdf_mae_m_below_1m": r["by_height"][0],
        "reference_esdf_mae_m_above_1m": r["by_height"][1],
        "reference_pallas_tsdf_mae_m": tsdf_pal,
        "reference_pallas_esdf_mae_m": esdf_pal,
        "sites_below_0.1m_xla_path": int((r["site"][:r["n"]] & floor).sum()),
        "sites_below_0.1m_pallas_path": int((site_pal & floor).sum())}))


if __name__ == "__main__":
    main()
