"""The port's online node (`device="cpu"`) against the reference's (CPU).

Every case of tests/test_node_pipeline.py and tests/test_node_params.py
runs on the port's node, with the frames rendered by the port's scene
module at the same 120x90 camera. One test holds the slice as a whole,
in each of the node's documented configurations (static TSDF, static
occupancy, dynamic, the 3-D ESDF): the reference's node and the port's
take the same frames, poses, lidar scan and simulated clock; their maps
agree within the TSDF tolerance (>= 99.9% of voxels within 1e-5); then
the port's maps go into the reference's mappers and one tick of ESDF,
mesh and layer publishing on both gives bit-equal messages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_io as jdio
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.runtime import node as jnode
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper.params import make_params
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
from isaac_ros_nvblox_tpu_torch.models.scene import (RoomBox, Scene, Sphere,
                                                     orbit_pose, render_color,
                                                     render_depth)
from isaac_ros_nvblox_tpu_torch.runtime.adapters import MeshLayerAdapter
from isaac_ros_nvblox_tpu_torch.runtime.costmap import NvbloxCostmapLayer
from isaac_ros_nvblox_tpu_torch.runtime.node import NodeParams, NvbloxNode
from isaac_ros_nvblox_tpu_torch.utils.timing import Timing
from test_torch_human import exact_jax_mask_filter  # noqa: F401

torch.set_num_threads(2)

CAM = Camera(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
SCENE = Scene(primitives=(Sphere(center=(0.0, 0.0, 1.0), radius=0.5),))


def _depth(T, scene=SCENE, cam=CAM):
    return render_depth(scene, cam, T, device="cpu").numpy()


def _color(T, scene=SCENE, cam=CAM):
    return render_color(scene, cam, T, device="cpu").numpy()


def _make_node(**params):
    node = NvbloxNode(NodeParams(**params),
                      make_params(overlay={"block_capacity": 8192}),
                      device="cpu")
    t = [0.0]
    node.clock = lambda: t[0]
    return node, t


def _feed_depth(node, t, stamp=0.0, frame="cam"):
    T = orbit_pose(0.0)
    node.add_pose(frame, stamp, T)
    node.add_depth_image(_depth(T), CAM, frame, stamp)
    t[0] = stamp + 0.01
    node.tick()


def _ring_scan(n=512, radius=2.0):
    az = np.linspace(-np.pi, np.pi, n, endpoint=False)
    return np.stack([radius * np.cos(az), radius * np.sin(az),
                     np.zeros_like(az)], 1).astype(np.float32)


# ------------------------------------------------ tests/test_node_pipeline.py
def test_full_pipeline_publishes_everything(tmp_path):
    node, t = _make_node()
    got = {"mesh": 0, "slice": 0, "tsdf_layer": 0}
    for key, topic in (("mesh", "~/mesh"), ("slice", "~/static_map_slice"),
                       ("tsdf_layer", "~/tsdf_layer")):
        node.bus.subscribe(topic, lambda m, key=key: got.__setitem__(
            key, got[key] + 1))
    adapter_out = []
    MeshLayerAdapter(node.bus)
    node.bus.subscribe("~/mesh_serialized", adapter_out.append)
    costmap = NvbloxCostmapLayer(node.bus)
    for k in range(3):
        stamp = k * 0.2
        T = orbit_pose(2 * np.pi * k / 12)
        node.add_pose("cam", stamp, T)
        node.add_depth_image(_depth(T), CAM, "cam", stamp)
        node.add_color_image(_color(T), CAM, "cam", stamp)
        t[0] = stamp + 0.01
        node.tick()
        t[0] = stamp + 0.11
        node.tick()
    assert got["mesh"] >= 1
    assert got["slice"] >= 1
    assert got["tsdf_layer"] >= 1
    # Adapter flattened the incremental mesh.
    assert adapter_out and adapter_out[-1].triangles.shape[0] > 100
    # Costmap layer consumed the slice (numpy, not a tensor) and answers.
    assert costmap.has_data
    assert isinstance(costmap._slice.data, np.ndarray)
    assert set(node.last_host_bytes) == {"slice", "mesh", "layers"}
    assert all(v > 0 for v in node.last_host_bytes.values())
    node.shutdown(tmp_path)
    assert (tmp_path / "map.png").exists()
    assert (tmp_path / "map.yaml").exists()


def test_rate_gates_limit_processing():
    node, t = _make_node()
    node.params.integrate_depth_rate_hz = 1.0  # only 1 Hz allowed
    T = orbit_pose(0.0)
    depth = _depth(T)
    processed_blocks = []
    for k in range(5):
        stamp = k * 0.01  # 100 Hz input
        node.add_pose("cam", stamp, T)
        node.add_depth_image(depth, CAM, "cam", stamp)
        t[0] = stamp
        node.tick()
        processed_blocks.append(
            node.multi_mapper.static_mapper.block_count())
    # Only the first frame within the 1 Hz window integrates.
    assert processed_blocks[-1] == processed_blocks[0] > 0


def test_multi_camera_and_lidar_inputs():
    """Two cameras with different intrinsics plus a lidar scan feed one
    map."""
    node, t = _make_node()
    node.params.num_cameras = 2
    cam2 = Camera(fx=90.0, fy=90.0, cx=44.5, cy=34.5, width=90, height=70)
    T, T2 = orbit_pose(0.0), orbit_pose(np.pi / 2)
    node.add_pose("cam_a", 0.0, T)
    node.add_pose("cam_b", 0.0, T2)
    node.add_depth_image(_depth(T), CAM, "cam_a", 0.0)
    node.add_depth_image(_depth(T2, cam=cam2), cam2, "cam_b", 0.0)
    t[0] = 0.01
    node.tick()
    n_after_cams = node.multi_mapper.static_mapper.block_count()
    assert n_after_cams > 0
    T_l = np.eye(4, dtype=np.float32)
    T_l[2, 3] = 1.0
    node.add_pose("lidar", 0.05, T_l)
    node.add_pointcloud(_ring_scan(), "lidar", 0.05)
    t[0] = 0.06
    node.tick()
    assert node.multi_mapper.static_mapper.block_count() > n_after_cams


def test_mesh_streaming_respects_budget():
    """With a tiny bandwidth limit, mesh messages carry few blocks per
    publish and the backlog drains over successive publishes."""
    node, t = _make_node()
    node.params.layer_streamer_bandwidth_limit_mbps = 1.0
    msgs = []
    node.bus.subscribe("~/mesh", msgs.append)
    _feed_depth(node, t)
    t[0] = 0.3
    node.tick()  # first mesh publish (budget-limited)
    assert msgs
    first_blocks = len(msgs[-1].blocks)
    total_mesh_blocks = len(
        node.multi_mapper.static_mapper.mesh_layer.blocks)
    assert 0 < first_blocks < total_mesh_blocks
    # Publishes 0.5 s apart (the budget grows with the gap) until the
    # backlog has drained.
    published = set()
    for k in range(30):
        for m in msgs:
            published |= {(b.index.x, b.index.y, b.index.z)
                          for b in m.blocks}
        if len(published) == total_mesh_blocks:
            break
        t[0] = 0.3 + 0.5 * (k + 1)
        node.tick()
    assert len(published) == total_mesh_blocks
    assert len(msgs) > 2


def test_late_subscriber_gets_full_mesh_resend():
    """A late subscriber catches up on the whole mesh under the bandwidth
    budget while the existing one keeps getting the incremental set."""
    node, t = _make_node()
    msgs_a = []
    node.bus.subscribe("~/mesh", msgs_a.append)
    _feed_depth(node, t)
    for k in range(10):
        t[0] = 0.3 + 0.2 * k
        node.tick()
    layer = node.multi_mapper.static_mapper.mesh_layer
    total = set(layer.blocks.keys())
    assert total
    seen_a = set()
    for m in msgs_a:
        seen_a |= {(b.index.x, b.index.y, b.index.z) for b in m.blocks}
    assert seen_a == total
    # Welded, indexed wire format.
    big = [b for m in msgs_a for b in m.blocks if b.triangles.shape[0] > 8]
    assert big
    for b in big:
        assert b.vertices.shape[0] < 3 * b.triangles.shape[0]
        assert b.triangles.max() < b.vertices.shape[0]
    node.params.layer_streamer_bandwidth_limit_mbps = 8.0
    msgs_b = []
    node.bus.subscribe("~/mesh", msgs_b.append)
    n_a = len(msgs_a)
    t[0] = 10.0
    node.tick()
    assert msgs_b, "late subscriber got no mesh"
    first_b = {(b.index.x, b.index.y, b.index.z) for b in msgs_b[0].blocks}
    assert first_b and first_b < total, "first resend must be budgeted"
    seen_b = set(first_b)
    for k in range(12):
        t[0] = 10.2 + 0.2 * k
        node.tick()
        for m in msgs_b:
            seen_b |= {(b.index.x, b.index.y, b.index.z) for b in m.blocks}
        if seen_b == total:
            break
    assert seen_b == total
    assert len(msgs_a) > n_a
    assert len(msgs_a[-1].blocks) < len(total)


def test_voxel_layer_publishes_removals_after_clearing():
    """Blocks freed by radius clearing surface as removed_blocks on the
    voxel-layer topic."""
    node, t = _make_node()
    msgs = []
    node.bus.subscribe("~/tsdf_layer", msgs.append)
    node.bus.subscribe("~/mesh", lambda m: None)  # drives re-mesh tracking
    T = orbit_pose(0.0)
    _feed_depth(node, t)
    for k in range(5):
        t[0] = 0.3 + 0.2 * k
        node.tick()
    assert msgs and any(m.blocks for m in msgs)
    n_before = node.multi_mapper.static_mapper.block_count()
    node.multi_mapper.static_mapper.clear_outside_radius(
        np.asarray(T, np.float32)[:3, 3], 0.5)
    assert node.multi_mapper.static_mapper.block_count() < n_before
    n_msgs = len(msgs)
    for k in range(3):
        t[0] = 2.0 + 0.2 * k
        node.tick()
    removed = set()
    for m in msgs[n_msgs:]:
        removed |= {(i.x, i.y, i.z) for i in m.removed_blocks}
    assert removed, "no removed_blocks emitted after clearing"


def test_voxel_layer_publishes_without_mesh_subscriber():
    """With no mesh subscriber, updated blocks derive from the device
    dirty flags."""
    node, t = _make_node()
    msgs = []
    node.bus.subscribe("~/tsdf_layer", msgs.append)
    _feed_depth(node, t)
    for k in range(3):
        t[0] = 0.3 + 0.2 * k
        node.tick()
    assert msgs and any(m.blocks for m in msgs)
    blk = next(b for m in msgs for b in m.blocks)
    assert blk.centers.dtype == np.float32 and blk.centers.shape[1] == 3
    assert blk.values.shape == (blk.centers.shape[0],)


def test_per_camera_rate_gates_interleaved():
    """Two cameras at 100 Hz with a 20 Hz depth gate: each camera
    integrates independently at the gated rate."""
    node, t = _make_node()
    node.params.num_cameras = 2
    node.params.integrate_depth_rate_hz = 20.0
    cam2 = Camera(fx=90.0, fy=90.0, cx=44.5, cy=34.5, width=90, height=70)
    d1 = _depth(orbit_pose(0.0))
    d2 = _depth(orbit_pose(np.pi / 2), cam=cam2)
    Timing.reset()
    for k in range(20):
        stamp = k * 0.01
        t[0] = stamp
        node.add_pose("cam_a", stamp, orbit_pose(0.0))
        node.add_depth_image(d1, CAM, "cam_a", stamp)
        node.add_pose("cam_b", stamp, orbit_pose(np.pi / 2))
        node.add_depth_image(d2, cam2, "cam_b", stamp)
        node.tick()
    n_integrated = Timing.get("node/depth/integrate").count
    assert 6 <= n_integrated <= 12, n_integrated
    assert node.multi_mapper.static_mapper.block_count() > 0


# -------------------------------------------------- tests/test_node_params.py
def test_use_depth_false_skips_depth_integration():
    node, t = _make_node(use_depth=False)
    _feed_depth(node, t)
    assert node.multi_mapper.static_mapper.block_count() == 0
    node.params.use_depth = True
    _feed_depth(node, t, stamp=0.2)
    assert node.multi_mapper.static_mapper.block_count() > 0


def test_num_cameras_limits_camera_streams():
    node, t = _make_node(num_cameras=1)
    _feed_depth(node, t, stamp=0.0, frame="cam_a")
    n1 = node.multi_mapper.static_mapper.block_count()
    T2 = orbit_pose(np.pi)
    node.add_pose("cam_b", 0.2, T2)
    node.add_depth_image(_depth(T2), CAM, "cam_b", 0.2)
    t[0] = 0.21
    node.tick()
    assert node.multi_mapper.static_mapper.block_count() == n1
    assert node._camera_frames == ["cam_a"]


def test_pessimistic_distance_map_output():
    node, t = _make_node(output_pessimistic_distance_map=True)
    opt_msgs, pess_msgs = [], []
    node.bus.subscribe("~/static_map_slice", opt_msgs.append)
    node.bus.subscribe("~/pessimistic_static_map_slice", pess_msgs.append)
    _feed_depth(node, t)
    t[0] = 0.5
    node.tick()
    assert opt_msgs and pess_msgs
    opt, pess = opt_msgs[-1], pess_msgs[-1]
    p = node.params
    assert pess.unknown_value == p.distance_map_unknown_value_pessimistic
    unknown = opt.data == np.float32(p.distance_map_unknown_value_optimistic)
    assert unknown.any()
    assert np.all(pess.data[unknown]
                  == np.float32(p.distance_map_unknown_value_pessimistic))
    assert np.array_equal(pess.data[~unknown], opt.data[~unknown])


def test_use_segmentation_gates_mask_split():
    # With use_segmentation=False a mask is ignored: the whole frame
    # integrates into the static map.
    node, t = _make_node(use_segmentation=False)
    T = orbit_pose(0.0)
    depth = _depth(T)
    node.add_pose("cam", 0.0, T)
    node.add_depth_image(depth, CAM, "cam", 0.0,
                         mask=np.ones(depth.shape, np.uint8))
    t[0] = 0.01
    node.tick()
    assert node.multi_mapper.static_mapper.block_count() > 0


def test_back_projection_publish_and_distance_cap():
    def points_with_cap(cap):
        node, t = _make_node(max_back_projection_distance=cap)
        got = []
        node.bus.subscribe("~/back_projected_depth", got.append)
        _feed_depth(node, t)
        assert got
        _, pts = got[-1]
        assert isinstance(pts, np.ndarray)
        return pts

    far = points_with_cap(5.0)
    near = points_with_cap(1.6)
    assert far.shape[0] > near.shape[0] > 0
    cam_pos = np.asarray(orbit_pose(0.0))[:3, 3]
    d = np.linalg.norm(near - cam_pos[None], axis=1)
    assert np.all(d <= 1.6 * 1.6)


def test_back_projection_subsampling():
    node, t = _make_node(back_projection_subsampling=2)
    got = []
    node.bus.subscribe("~/back_projected_depth", got.append)
    for k in range(4):
        _feed_depth(node, t, stamp=k * 0.2)
    assert len(got) == 2  # every 2nd depth frame


def test_print_statistics_to_console(capsys):
    node, t = _make_node(print_timings_to_console=True,
                         print_rates_to_console=True,
                         print_queue_drops_to_console=True,
                         print_statistics_on_console_period_ms=0)
    _feed_depth(node, t)
    out = capsys.readouterr().out
    assert "node/tick" in out and "dropped=" in out


def test_debug_vis_markers_published():
    node, t = _make_node(use_ground_plane_estimator=True)
    slice_markers = []
    node.bus.subscribe("~/esdf_slice_bounds", slice_markers.append)
    node.add_pose("base_link", 0.0, np.eye(4, dtype=np.float32))
    _feed_depth(node, t)
    t[0] = 1.0
    node.add_pose("base_link", 1.0, np.eye(4, dtype=np.float32))
    node.tick()
    assert slice_markers
    assert slice_markers[-1].ns == "esdf_slice_bounds"


def test_lidar_node_params_build_model():
    node, _ = _make_node(lidar_width=900, lidar_height=32,
                         use_non_equal_vertical_fov_lidar_params=True,
                         min_angle_below_zero_elevation_rad=0.3,
                         max_angle_above_zero_elevation_rad=0.2)
    lid = node.lidar
    assert lid.num_azimuth_divisions == 900
    assert lid.num_elevation_divisions == 32
    assert abs(lid.elevation_range_rad - 0.5) < 1e-6


def test_use_lidar_false_skips_pointclouds():
    node, t = _make_node(use_lidar=False)
    node.add_pose("lidar", 0.0, np.eye(4, dtype=np.float32))
    node.add_pointcloud(_ring_scan(256), "lidar", 0.0)
    t[0] = 0.01
    node.tick()
    assert node.multi_mapper.static_mapper.block_count() == 0


def test_decay_rate_alias_applies():
    node, _ = _make_node(decay_rate_hz=2.5)
    assert node.params.decay_tsdf_rate_hz == 2.5
    assert node.params.decay_dynamic_occupancy_rate_hz == 2.5


# ------------------------------------------------------------ port features
def test_fused_2d_tick_runs_and_leaves_nothing_to_solve():
    """On an ESDF-cadence tick the host pose takes the fused branch
    (integration + 2-D solve in one call), and the tick's update_esdf
    then finds nothing left to solve."""
    node, t = _make_node()
    node.bus.subscribe("~/static_map_slice", lambda m: None)
    mm, sm = node.multi_mapper, node.multi_mapper.static_mapper
    fused, solves = [], []
    fuse, solve = mm.integrate_depth_with_esdf2d, sm._solve_esdf_2d
    mm.integrate_depth_with_esdf2d = lambda *a: fused.append(fuse(*a)) \
        or fused[-1]
    sm._solve_esdf_2d = lambda f: solves.append(f) or solve(f)
    for k in range(4):
        stamp = 0.1 * k
        T = orbit_pose(2 * np.pi * k / 12)
        node.add_pose("cam", stamp, T)
        node.add_depth_image(_depth(T), CAM, "cam", stamp)
        t[0] = stamp
        node.tick()
    assert fused == [True] * 4
    assert len(solves) == 4 and sm.esdf_2d is not None


@pytest.mark.parametrize("relative", [True, False])
def test_lidar_motion_compensation_stamps(relative):
    """Per-point timestamps relative to the scan start, or absolute with
    `pointcloud2_timestamps_are_relative=False`, compensate the scan the
    same way: both maps equal the mapper fed the relative stamps and the
    interpolated end pose."""
    node, t = _make_node(pointcloud2_timestamps_are_relative=relative)
    T0 = np.eye(4, dtype=np.float32)
    T0[2, 3] = 1.0
    T1 = T0.copy()
    T1[0, 3] = 0.2
    for stamp, T in ((1.0, T0), (1.2, T1)):
        node.add_pose("lidar", stamp, T)
    pts = _ring_scan()
    rel = np.linspace(0.0, 0.1, pts.shape[0], dtype=np.float64)
    node.add_pointcloud(pts, "lidar", 1.0,
                        timestamps_s=rel if relative else rel + 1.0)
    t[0] = 1.21
    node.tick()
    ref, _ = _make_node()
    T_end = node.transformer.lookup_transform_to_global_frame("lidar", 1.1)
    np.testing.assert_allclose(T_end[0, 3], 0.1, atol=1e-6)
    ref.multi_mapper.integrate_pointcloud(pts, T0, lidar=ref.lidar,
                                          timestamps_s=rel, T_L_S_end=T_end)
    a = node.multi_mapper.static_mapper.state_arrays()
    b = ref.multi_mapper.static_mapper.state_arrays()
    assert a["alloc_count"] > 0
    for k in ("alloc_count", "block_index_of_slot", "tsdf_distance",
              "tsdf_weight"):
        np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------------- the slice as a whole
STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")
ROOM = Scene(primitives=(
    RoomBox(center=(0, 0, 1.5), half_extents=(2.0, 1.8, 1.5)),
    Sphere(center=(0.6, 0.4, 1.0), radius=0.4)))
TOPICS = ("~/static_map_slice", "~/pessimistic_static_map_slice",
          "~/combined_map_slice", "~/map_slice_occupancy_grid", "~/mesh",
          "~/tsdf_layer", "~/color_layer", "~/occupancy_layer",
          "~/esdf_layer", "~/freespace_layer")
# The node's documented configurations (MODE_OVERLAYS and EsdfMode), each
# built as a user builds it: the mode, the user overlay, the NodeParams
# changes, the world (None: the node's default 128 x 128 x 32 blocks) and
# the topics its publishing tick must send. Lidar cannot integrate into an
# occupancy layer (both packages raise), so the occupancy node runs with
# `use_lidar=False` and is fed no scan. The 3-D node's world bounds the
# region each ESDF tick solves to the room (6.4 x 6.4 x 4 m): over the
# default world the 7 m frustum's box holds ~16 M voxels, minutes for the
# reference's EDT in interpret mode.
LAYERS = ("~/static_map_slice", "~/pessimistic_static_map_slice",
          "~/map_slice_occupancy_grid", "~/esdf_layer")
NODE_MODES = {
    "static_tsdf": ("static", {}, {}, None,
                    LAYERS + ("~/mesh", "~/tsdf_layer", "~/color_layer")),
    "static_occupancy": ("static_occupancy", {}, {"use_lidar": False}, None,
                         LAYERS + ("~/occupancy_layer",)),
    "dynamic": ("dynamic", {}, {}, None,
                LAYERS + ("~/combined_map_slice", "~/mesh", "~/tsdf_layer",
                          "~/color_layer", "~/freespace_layer")),
    "static_tsdf_esdf_3d": ("static", {"esdf_mode": "3d"}, {},
                            dict(dims=(16, 16, 10), origin_block=(-8, -8, -2)),
                            LAYERS + ("~/mesh", "~/tsdf_layer",
                                      "~/color_layer")),
}


def _to_jax(t, j):
    """The port mapper's allocator, channels, flags, removal ring and
    host-tracked regions and ESDF state into the reference mapper `j`."""
    a = t.state_arrays()
    j.state = jwg.WorldGridState(**{f: jnp.asarray(a[f]) for f in STATE})
    assert sorted(j.channels) == sorted(t.channels)
    j.channels = {k: jnp.asarray(a[k]) for k in t.channels}
    for k in ("mesh_pending", "removed_log", "removed_count"):
        setattr(j, k, jnp.asarray(a[k]))
    j.dirty = jnp.asarray(t.dirty.numpy())
    j.esdf_dirty = jnp.asarray(t.esdf_dirty.numpy())
    for k in ("_aabb_lo", "_aabb_hi", "_dirty_lo", "_dirty_hi",
              "_dirty2d_lo", "_dirty2d_hi"):
        v = getattr(t, k)
        setattr(j, k, None if v is None else np.array(v))
    j._region_unknown = t._region_unknown
    j._removed_read = t._removed_read
    j._esdf_has_full = t._esdf_has_full
    j._freespace_last_update_ms = float(t._freespace_last_update_ms)


def _assert_same_mapper(tm, jm):
    """The same blocks in the same slots, every channel within 1e-5 on at
    least 99.9% of the live voxels, the same removal ring."""
    a = tm.state_arrays()
    b = {f: np.asarray(getattr(jm.state, f)) for f in STATE}
    b.update({k: np.asarray(v) for k, v in jm.channels.items()})
    for k in STATE:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    assert sorted(tm.channels) == sorted(jm.channels)
    n = int(a["alloc_count"])
    for k in tm.channels:
        x, y = a[k][:n].astype(np.float64), b[k][:n].astype(np.float64)
        close = np.isclose(x, y, rtol=0, atol=1e-5)
        assert close.mean() >= 0.999, (tm.name, k, close.mean())
    np.testing.assert_array_equal(a["removed_count"],
                                  np.asarray(jm.removed_count))
    np.testing.assert_array_equal(a["removed_log"],
                                  np.asarray(jm.removed_log))
    return n


def _lidar_scan(T_L_S, lidar, n_steps=64):
    """The room seen by a 1-degree, 16-row lidar at T_L_S: sensor-frame
    points `f32[16 * 360, 3]` (sphere-traced), 0 where a beam hits
    nothing."""
    A, E = 360, lidar.num_elevation_divisions
    az = (np.arange(A) + 0.5) / A * 2 * np.pi - np.pi
    # Each row a quarter row below its range-image row boundary, where the
    # last bit of atan2 would pick the row.
    el = (lidar.max_angle_above_zero_elevation_rad
          - (np.arange(E) + 0.25) * lidar.elevation_range_rad / (E - 1))
    el, az = np.meshgrid(el, az, indexing="ij")
    dirs = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.sin(el)], -1).reshape(-1, 3)
    R, o = T_L_S[:3, :3].astype(np.float64), T_L_S[:3, 3]
    dirs_L = dirs @ R.T
    s = np.full(dirs.shape[0], 1e-3)
    for _ in range(n_steps):
        d = ROOM.sdf(torch.from_numpy(dirs_L * s[:, None] + o)).numpy()
        s = s + np.where(d > 1e-4, d, 0.0)
    hit = ROOM.sdf(torch.from_numpy(dirs_L * s[:, None] + o)).numpy() < 1e-3
    return np.where(hit[:, None], dirs * s[:, None], 0.0).astype(np.float32)


def _drive(node, t, frames, scan, cam):
    """Poses at 100 Hz for cam, lidar and base_link; depth and color
    (camera `cam`, the node's package's) every 50 ms; the scan (relative
    per-point stamps over 50 ms) at 0.12 s unless `scan` is None; a tick
    every 10 ms."""
    poses_cam, poses_lidar = frames["cam"], frames["lidar"]
    for i in range(len(poses_cam)):
        now = i / 100.0
        node.add_pose("cam", now, poses_cam[i])
        node.add_pose("lidar", now, poses_lidar[i])
        node.add_pose("base_link", now, poses_lidar[i])
        if i % 5 == 0:
            k = i // 5
            node.add_depth_image(frames["depth"][k], cam, "cam", now)
            node.add_color_image(frames["color"][k], cam, "cam", now)
        if i == 12 and scan is not None:
            node.add_pointcloud(scan[0], "lidar", now, timestamps_s=scan[1])
        t[0] = now
        node.tick()


@pytest.fixture(scope="module")
def node_frames():
    n = 21
    cam = [orbit_pose(0.6 * i / 20, radius=1.2) for i in range(n)]
    lidar = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = (-0.5 + 0.002 * i, -0.8, 1.6)
        lidar.append(T)
    p = NodeParams()
    pts = _lidar_scan(lidar[12], Lidar.equal_vertical_fov(
        p.lidar_width, p.lidar_height, p.lidar_vertical_fov_rad,
        min_range_m=p.lidar_min_valid_range_m))
    rel = np.tile(np.linspace(0.0, 0.05, 360), 16)   # by azimuth column
    return {"cam": cam, "lidar": lidar,
            "depth": [_depth(cam[5 * k], ROOM) for k in range(5)],
            "color": [_color(cam[5 * k], ROOM) for k in range(5)]}, \
        (pts, rel)


def _sorted_blocks(blocks):
    return {(b.index.x, b.index.y, b.index.z): b for b in blocks}


def _assert_same_message(a, b, topic):
    if topic == "~/map_slice_occupancy_grid":
        assert dataclasses.asdict(a[0]) == dataclasses.asdict(b[0])
        assert a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1], b[1])
        return
    if topic.endswith("slice"):
        fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
        da, db = fa.pop("data"), fb.pop("data")
        fa.pop("header"), fb.pop("header")
        assert fa == fb, topic
        assert da.dtype == db.dtype
        np.testing.assert_array_equal(da, db)
        return
    assert a.block_size_m == b.block_size_m
    assert ([(i.x, i.y, i.z) for i in a.removed_blocks]
            == [(i.x, i.y, i.z) for i in b.removed_blocks])
    ba, bb = _sorted_blocks(a.blocks), _sorted_blocks(b.blocks)
    assert ba.keys() == bb.keys() and ba, topic
    fields = (("vertices", "colors", "triangles") if topic == "~/mesh"
              else ("centers", "values"))
    for key in ba:
        for f in fields:
            x, y = getattr(ba[key], f), getattr(bb[key], f)
            assert x.dtype == y.dtype, (topic, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{topic} {f}")


def _kernel_branch_mesh(monkeypatch):
    """The reference's node meshes through its kernel branch (the TPU's
    marching-cubes kernel, here in interpret mode), which the port
    mirrors; on the CPU backend it would take its XLA branch. The branch
    is chosen by update_mesh_layer's first `jax.default_backend()` call:
    that call alone answers "tpu", so the kernel still runs in interpret
    mode."""
    update, backend = jdio.update_mesh_layer, jax.default_backend

    def kernel_branch(m, max_blocks=2048):
        answers = iter(["tpu"])
        with monkeypatch.context() as mp:
            mp.setattr(jax, "default_backend",
                       lambda: next(answers, None) or backend())
            return update(m, max_blocks=max_blocks)

    monkeypatch.setattr(jdio, "update_mesh_layer", kernel_branch)


def _framed_jax_slices(monkeypatch):
    """The reference's 2-D slicer with the port's rule for a given spec:
    the mapper's field placed in the spec's frame, cropped where it
    reaches past it and unknown where it does not cover it, so that the
    dynamic mapper's field is combined with the static slice whatever
    the two fields' frames."""
    slice_2d = jdio.slice_esdf_2d_device

    def framed(m, *, max_distance_m, unknown_value=1000.0, spec=None):
        res = slice_2d(m, max_distance_m=max_distance_m,
                       unknown_value=unknown_value, spec=spec)
        if res is None or spec is None:
            return res
        img, vs = res[1], m.voxel_size_m
        dx = int(m.esdf_2d[0][0]) * 8 - int(round(spec.origin_x_m / vs))
        dy = int(m.esdf_2d[0][1]) * 8 - int(round(spec.origin_y_m / vs))
        out = np.full((spec.height, spec.width), np.float32(unknown_value))
        x0, y0 = max(dx, 0), max(dy, 0)
        x1 = min(dx + img.shape[1], spec.width)
        y1 = min(dy + img.shape[0], spec.height)
        if x1 > x0 and y1 > y0:
            out[y0:y1, x0:x1] = img[y0 - dy:y1 - dy, x0 - dx:x1 - dx]
        return spec, out

    monkeypatch.setattr(jdio, "slice_esdf_2d_device", framed)


def _mode_nodes(mode):
    """The port's node (on the CPU) and the reference's in one of
    NODE_MODES' configurations, 8192 slots."""
    name, overlay, node_kw, world, _ = NODE_MODES[mode]
    overlay = dict(overlay, block_capacity=8192)
    world = world and dict(world, capacity=8192)
    return (
        (NvbloxNode(NodeParams(**node_kw), make_params(name, overlay),
                    world=world and twg.WorldGridConfig(**world),
                    device="cpu"), CAM),
        (jnode.NvbloxNode(jnode.NodeParams(**node_kw),
                          jp.make_params(name, overlay),
                          world=world and jwg.WorldGridConfig(**world)),
         jc.Camera(**dataclasses.asdict(CAM))))


@pytest.mark.parametrize("mode", list(NODE_MODES))
def test_node_matches_reference(mode, node_frames, monkeypatch,
                                exact_jax_mask_filter):
    """Both nodes in one configuration over the same frames, poses, scan
    and clock: the same maps (every mapper, every channel); then the
    port's maps go into the reference's mappers and one publishing tick
    gives the same messages on every topic."""
    _kernel_branch_mesh(monkeypatch)
    _framed_jax_slices(monkeypatch)
    frames, scan = node_frames
    expected = NODE_MODES[mode][4]
    occupancy = mode == "static_occupancy"
    clock = [0.0]
    nodes = []
    for node, cam in _mode_nodes(mode):
        node.clock = lambda: clock[0]
        slices = []
        node.bus.subscribe("~/static_map_slice", slices.append)
        _drive(node, clock, frames, None if occupancy else scan, cam)
        nodes.append((node, slices))
    (tn, t_slices), (jn, j_slices) = nodes
    assert tn.depth_queue.dropped_count == jn.depth_queue.dropped_count == 0
    assert len(t_slices) == len(j_slices) >= 2
    for a, b in zip(t_slices, j_slices):
        _assert_same_message(a, b, "~/static_map_slice")

    # The maps: the same blocks in the same slots, every channel within
    # 1e-5 (TSDF or log-odds, freespace, ESDF).
    tmm, jmm = tn.multi_mapper, jn.multi_mapper
    pairs = [(tmm.static_mapper, jmm.static_mapper)]
    assert (tmm.dynamic_mapper is None) == (jmm.dynamic_mapper is None)
    assert (tmm.dynamic_mapper is not None) == (mode == "dynamic")
    if tmm.dynamic_mapper is not None:
        pairs.append((tmm.dynamic_mapper, jmm.dynamic_mapper))
    n = _assert_same_mapper(*pairs[0])
    assert n > 100 and int(tmm.static_mapper.state.overflow_count) == 0
    for tm, jm in pairs[1:]:
        _assert_same_mapper(tm, jm)
    assert ("occupancy_log_odds" in tmm.static_mapper.channels) == occupancy
    if not occupancy:
        # The lidar scan reached the map above the camera's view.
        assert tn.pointcloud_queue.dropped_count == 0
        assert Timing.get("node/lidar/integrate").count >= 1

    # The port's maps into the reference's mappers, then one tick of ESDF,
    # mesh and layer publishing on both (the ESDF frames forgotten on both
    # sides, so that each solves the same map in full).
    for tm, jm in pairs:
        _to_jax(tm, jm)
        tm._esdf2d_frame = jm._esdf2d_frame = None
        tm._esdf_has_full = jm._esdf_has_full = False
    got = []
    for node in (tn, jn):
        msgs = {topic: [] for topic in TOPICS}
        for topic in TOPICS:
            # An occupancy node has no mesh (test_occupancy_node_raises).
            if not (occupancy and topic == "~/mesh"):
                node.bus.subscribe(topic, msgs[topic].append)
        got.append(msgs)
    clock[0] += 1.0
    for node in (tn, jn):
        node.tick()
    sent = {topic for topic in TOPICS if got[0][topic]}
    assert sent == set(expected), sent ^ set(expected)
    for topic in TOPICS:
        assert len(got[0][topic]) == len(got[1][topic]), topic
        if got[0][topic]:
            _assert_same_message(got[0][topic][0], got[1][topic][0], topic)
    for tm, jm in pairs:
        _assert_same_mapper(tm, jm)
    assert tn.last_host_bytes["layers"] > 0


@pytest.mark.parametrize("what", ["scan", "mesh"])
def test_occupancy_node_raises(what, node_frames):
    """What an occupancy mapper cannot do raises alike in both packages, on
    the tick that tries it: a scan (static_occupancy keeps the default
    `use_lidar=True`) raises NotImplementedError; a `~/mesh` subscriber
    makes the mesh tick read the TSDF the layer lacks (KeyError)."""
    _, scan = node_frames
    for node in (NvbloxNode(NodeParams(), make_params("static_occupancy"),
                            device="cpu"),
                 jnode.NvbloxNode(jnode.NodeParams(),
                                  jp.make_params("static_occupancy"))):
        node.clock = lambda: 0.01
        if what == "scan":
            node.add_pose("lidar", 0.0, np.eye(4, dtype=np.float32))
            node.add_pointcloud(scan[0], "lidar", 0.0)
            with pytest.raises(NotImplementedError, match="TSDF"):
                node.tick()
        else:
            node.bus.subscribe("~/mesh", lambda msg: None)
            with pytest.raises(KeyError, match="tsdf_distance"):
                node.tick()
