"""The port's ShardedDeviceMapper, continued: the feature cases of the
reference's tests/test_sharded_mapper.py (view flags, occupancy and decay,
freespace, lidar, the 2-D slice, the dynamic tick, routed frames), rerun
on an 8-shard mesh on the CPU against the port's single-device
DeviceMapper where the reference compares with its own."""

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.mapper.params import (MapperParams,
                                                      ProjectiveLayerType)
from isaac_ros_nvblox_tpu_torch.models.lidar import (Lidar,
                                                     pointcloud_to_range_image)
from isaac_ros_nvblox_tpu_torch.models.scene import (Scene, Sphere,
                                                     orbit_pose, render_depth)
from isaac_ros_nvblox_tpu_torch.ops.decay import TsdfDecayParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.runtime.costmap import (CostmapLayerParams,
                                                        distance_to_cost)
from test_torch_sharded_mapper import (BAND_1M, CAM, CFG, VOXEL, frames,
                                       owned_rows, sharded, single,
                                       single_row)

torch.set_num_threads(2)
SPHERE = Scene(primitives=(Sphere(center=(0.0, 0.0, 1.0), radius=0.6),))


def test_sharded_view_skip_flags():
    """Shards whose tile cannot meet the frustum ball skip the whole
    integrate step: their pools stay empty."""
    scene = Scene(primitives=(Sphere(center=(2.2, 0.0, 1.0), radius=0.4),))
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=2.0))
    sh = sharded(params=params)
    T = orbit_pose(0.0, radius=1.0, height=1.0, target=(2.2, 0, 1.0))
    T[:3, 3] += np.asarray([2.2, 0, 0])
    flags = sh._view_flags(T)
    assert 1 <= flags.sum() < 8
    sh.integrate_depth(render_depth(scene, CAM, T, device="cpu"), T)
    counts = np.array([int(st.alloc_count) for st in sh.state])
    assert (counts[flags == 0] == 0).all()
    assert counts.sum() > 0


def test_sharded_occupancy_and_decay():
    """Occupancy integration and TSDF / occupancy decay with slot
    recycling on the shards. The owned blocks' log-odds and observed
    flags equal a single-device occupancy mapper's (zero on the blocks
    only the TSDF step allocated)."""
    params = MapperParams(tsdf_decay=TsdfDecayParams(
        decay_factor=0.1, decayed_weight_threshold=1e-3))
    sh = sharded(params=params, enable_occupancy=True)
    one = single(projective_layer=ProjectiveLayerType.OCCUPANCY)
    depth, T = frames(SPHERE, n=1)[0]
    sh.integrate_depth(depth, T)
    sh.integrate_depth_occupancy(depth, T)
    one.integrate_depth(depth, T, CAM)
    lo = torch.stack(sh.channels["occupancy_log_odds"])
    ob = torch.stack(sh.channels["occupancy_observed"])
    assert int((lo > 0).sum()) > 100      # occupied evidence at the surface
    assert int(ob.sum()) > 1000
    names = ("occupancy_log_odds", "occupancy_observed")
    rows = owned_rows(sh, names)
    origin = np.asarray(one.world_config.origin_block)
    matched = 0
    for key, (lo_k, ob_k) in rows.items():
        c = np.asarray(key) - origin
        if int(one.state.slot_grid[c[0], c[1], c[2]]) < 0:
            assert not lo_k.any() and not ob_k.any(), key
            continue
        np.testing.assert_array_equal(
            lo_k, single_row(one, key, names[0]), err_msg=str(key))
        np.testing.assert_array_equal(
            ob_k, single_row(one, key, names[1]), err_msg=str(key))
        matched += 1
    assert matched == one.block_count() > 50
    assert sum(int(st.alloc_count) for st in sh.state) > 0
    for _ in range(4):                    # aggressive decay kills the weights
        sh.decay()
    assert float(torch.stack(sh.channels["tsdf_weight"]).max()) < 0.1
    freed = sum(int(st.free_count) for st in sh.state)
    assert freed > 0                      # decayed blocks were recycled
    # Freed rows start clean: no weight, no occupancy, INF distance.
    for i, st in enumerate(sh.state):
        rows = st.free_stack[:int(st.free_count)].long()
        assert not sh.channels["tsdf_weight"][i][rows].any()
        assert not sh.channels["occupancy_log_odds"][i][rows].any()


def test_sharded_freespace_matches_single_device():
    """Per-tile freespace (its neighbourhood check reading the ghost ring)
    equals the single device's freespace channel on owned blocks."""
    sh = sharded(enable_freespace=True)
    one = single(enable_freespace=True)
    for k, (depth, T) in enumerate(frames(SPHERE, n=3)):
        sh.integrate_depth(depth, T)
        one.integrate_depth(depth, T, CAM)
        t_ms = 400.0 * (k + 1)
        sh.update_freespace(T, t_ms)
        one.update_freespace(t_ms, T, CAM)
    assert int(one.channels["freespace_high_confidence"].sum()) > 100
    rows = owned_rows(sh, ("freespace_high_confidence",))
    assert len(rows) > 50
    for key, (hc,) in rows.items():
        np.testing.assert_array_equal(
            hc, single_row(one, key, "freespace_high_confidence"),
            err_msg=str(key))


def test_sharded_lidar_matches_single_device():
    """Sharded spherical lidar integration equals the single device's
    pointcloud path on owned blocks (TSDF within 1e-5)."""
    lidar = Lidar.equal_vertical_fov(64, 16, np.deg2rad(30.0),
                                     min_range_m=0.2, max_range_m=8.0)
    az = np.linspace(-np.pi, np.pi, 256, endpoint=False)
    el = np.linspace(-0.12, 0.12, 12)
    azg, elg = np.meshgrid(az, el)
    r = 1.2 / np.cos(elg)                 # a cylindrical wall at 1.2 m
    points = np.stack([r * np.cos(elg) * np.cos(azg),
                       r * np.cos(elg) * np.sin(azg),
                       r * np.sin(elg)], -1).reshape(-1, 3).astype(np.float32)
    sh, one = sharded(), single()
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 1.0
    sh.integrate_lidar(pointcloud_to_range_image(torch.as_tensor(points),
                                                 lidar), T, lidar)
    one.integrate_pointcloud(points, T, lidar)
    assert sh.total_owned_blocks() == one.block_count()
    rows = owned_rows(sh, ("tsdf_distance",))
    assert len(rows) > 10
    for key, (d,) in rows.items():
        np.testing.assert_allclose(d, single_row(one, key, "tsdf_distance"),
                                   rtol=0, atol=1e-5)


def test_sharded_2d_slice_and_costmap():
    """The global 2-D ESDF slice assembled from the shard tiles feeds the
    costmap."""
    sh = sharded(params=BAND_1M)
    for depth, T in frames(SPHERE):
        sh.integrate_depth(depth, T)
    sh.update_esdf()
    grid = sh.slice_esdf_2d(height_m=1.0)
    assert grid.shape == (64 * 8, 32 * 8)
    known = grid < 1000.0
    assert known.sum() > 500
    assert grid[known].min() < 0.1
    assert grid[known].max() > 0.5
    costs = distance_to_cost(grid, unknown_value=1000.0,
                             params=CostmapLayerParams())
    assert (costs == 255).any()
    assert (costs[known] != 255).all()
    assert costs[known].max() > 0


def test_sharded_dynamic_tick():
    """The sharded dynamic step: freespace-driven detection through the
    psum-OR'd per-shard masks, the masked split into background TSDF and
    foreground occupancy."""
    sh = sharded(enable_occupancy=True, enable_freespace=True)
    fr = frames(SPHERE, n=2)
    for k, (depth, T) in enumerate(fr):
        sh.integrate_depth(depth, T)
        sh.update_freespace(T, 400.0 * (k + 1))
    hc = torch.stack(sh.channels["freespace_high_confidence"])
    assert int(hc.sum()) > 100
    intruder = Scene(primitives=(
        Sphere(center=(0.0, 0.0, 1.0), radius=0.6),
        Sphere(center=(0.6, 0.3, 1.0), radius=0.18)))
    T2 = fr[-1][1]
    d_intr = render_depth(intruder, CAM, T2, device="cpu")
    mask = sh.dynamic_tick(d_intr, T2, 1200.0)
    assert mask.shape == (CAM.height, CAM.width) and mask.dtype == torch.bool
    assert int(mask.sum()) > 10           # intruder pixels detected
    lo = torch.stack(sh.channels["occupancy_log_odds"])
    assert int((lo > 0).sum()) > 10       # foreground occupancy integrated


def test_routed_frames_match_broadcast():
    """Ring-routed ingestion (one frame uploaded per shard, n - 1 ppermute
    hops) gives the map of broadcasting every frame: equal allocation
    sets per shard, TSDF and weights within 1e-5 (the ring fuses a shard's
    frames in another order)."""
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=2.5))
    routed, bcast = sharded(params=params), sharded(params=params)
    bs = VOXEL * 8
    cxs = [(-32 + (s + 0.5) * 8) * bs for s in range(8)]
    scene = Scene(primitives=tuple(Sphere(center=(cx, 0.0, 1.0), radius=0.5)
                                   for cx in cxs))
    poses, depths = [], []
    for cx in cxs:
        T = orbit_pose(np.pi / 3, radius=1.5, height=1.0,
                       target=(cx, 0, 1.0))
        T[:3, 3] += np.asarray([cx, 0.0, 0.0])
        poses.append(T)
        depths.append(render_depth(scene, CAM, T, device="cpu").numpy())
    depths, poses = np.stack(depths), np.stack(poses)
    routed.integrate_frames_routed(depths, poses)
    for f in range(8):
        bcast.integrate_depth(depths[f], poses[f])
    assert routed.total_owned_blocks() == bcast.total_owned_blocks()
    checked = 0
    for s in range(CFG.n_shards):
        n_r = int(routed.state[s].alloc_count)
        assert n_r == int(bcast.state[s].alloc_count), s
        key_r = {tuple(b): i for i, b in enumerate(
            routed.state[s].block_index_of_slot[:n_r].tolist())}
        key_b = {tuple(b): i for i, b in enumerate(
            bcast.state[s].block_index_of_slot[:n_r].tolist())}
        assert set(key_r) == set(key_b), s
        for key, i in key_r.items():
            j = key_b[key]
            for name in ("tsdf_distance", "tsdf_weight"):
                np.testing.assert_allclose(
                    routed.channels[name][s][i].numpy(),
                    bcast.channels[name][s][j].numpy(), rtol=0, atol=1e-5)
            checked += 1
    assert checked > 100
