"""The port's runtime components against the reference (CPU): transformer,
queues, timing registries, costmap, adapters, parameter overlays, layer
streaming and the sensor helpers. Every case of
tests/test_runtime_components.py and tests/test_streaming_and_sensors.py
runs on the port, and the same seeded inputs go through the reference's
module beside it: the same queue drops, streamer selections, costs,
transformer lookups (interpolated poses within 1e-6) and parameter
trees."""

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.runtime import adapters as jad
from isaac_ros_nvblox_tpu.runtime import costmap as jcm
from isaac_ros_nvblox_tpu.runtime import layer_streaming as jls
from isaac_ros_nvblox_tpu.runtime import msgs as jmsgs
from isaac_ros_nvblox_tpu.runtime import queues as jq
from isaac_ros_nvblox_tpu.runtime import sensor_helpers as jsh
from isaac_ros_nvblox_tpu.runtime import transformer as jtf
from isaac_ros_nvblox_tpu.utils import timing as jtiming
from isaac_ros_nvblox_tpu_torch.mapper.params import (MappingType,
                                                      ProjectiveLayerType,
                                                      make_params,
                                                      param_tree_string,
                                                      projective_layer_type)
from isaac_ros_nvblox_tpu_torch.ops.tsdf import WeightingFunctionType
from isaac_ros_nvblox_tpu_torch.runtime import adapters as tad
from isaac_ros_nvblox_tpu_torch.runtime import costmap as tcm
from isaac_ros_nvblox_tpu_torch.runtime import layer_streaming as tls
from isaac_ros_nvblox_tpu_torch.runtime import msgs as tmsgs
from isaac_ros_nvblox_tpu_torch.runtime import queues as tq
from isaac_ros_nvblox_tpu_torch.runtime import sensor_helpers as tsh
from isaac_ros_nvblox_tpu_torch.runtime import transformer as ttf
from isaac_ros_nvblox_tpu_torch.runtime.costmap import (
    FREE_SPACE, INSCRIBED_INFLATED_OBSTACLE, LETHAL_OBSTACLE, NO_INFORMATION,
    CostmapLayerParams, NvbloxCostmapLayer, distance_to_cost)
from isaac_ros_nvblox_tpu_torch.runtime.msgs import (DistanceMapSlice, Header,
                                                     Index3D, MeshBlockMsg,
                                                     MeshMsg, MessageBus)
from isaac_ros_nvblox_tpu_torch.runtime.queues import (DropOldestQueue,
                                                       ServiceRequestQueue)
from isaac_ros_nvblox_tpu_torch.runtime.transformer import Transformer
from isaac_ros_nvblox_tpu_torch.utils import timing as ttiming
from isaac_ros_nvblox_tpu_torch.utils.timing import (DelaysRegistry,
                                                     RatesRegistry, Timer,
                                                     TimingRegistry)


# ------------------------------------------------------------- transformer
def _pose(x):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = x
    return T


def _random_pose(rng):
    """A rigid pose from a seeded axis-angle and translation."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = rng.uniform(-np.pi, np.pi)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K
    T[:3, 3] = rng.uniform(-3, 3, 3)
    return T.astype(np.float32)


def test_transformer_nearest_and_tolerance():
    for mod in (ttf, jtf):
        tf = mod.Transformer(timestamp_tolerance_s=0.05,
                             use_interpolation=False)
        tf.add_pose("cam", 1.0, _pose(1.0))
        tf.add_pose("cam", 2.0, _pose(2.0))
        T = tf.lookup_transform_to_global_frame("cam", 1.01)
        assert T is not None and T[0, 3] == 1.0
        assert tf.lookup_transform_to_global_frame("cam", 1.5) is None
        assert not tf.can_transform("cam", 3.0)
        assert not tf.can_transform("other", 1.0)


def test_transformer_interpolation():
    tf = Transformer(timestamp_tolerance_s=0.01, use_interpolation=True)
    tf.add_pose("cam", 0.0, _pose(0.0))
    tf.add_pose("cam", 1.0, _pose(1.0))
    T = tf.lookup_transform_to_global_frame("cam", 0.5)
    assert T is not None and isinstance(T, np.ndarray)
    assert T.dtype == np.float32
    np.testing.assert_allclose(T[0, 3], 0.5, atol=1e-5)


def test_transformer_static_chain():
    for mod in (ttf, jtf):
        tf = mod.Transformer()
        tf.add_static_transform("base", "cam", _pose(0.1))
        tf.add_pose("base", 1.0, _pose(5.0))
        T = tf.lookup_transform_to_global_frame("cam", 1.0)
        np.testing.assert_allclose(T[0, 3], 5.1, atol=1e-6)


def test_transformer_lookups_match_reference():
    """Seeded poses of two frames (one behind a static extrinsic), queried
    at seeded times: the same hits and misses, nearest poses equal,
    interpolated poses within 1e-6."""
    rng = np.random.default_rng(7)
    tfs = [mod.Transformer(timestamp_tolerance_s=0.01) for mod in (ttf, jtf)]
    stamps = np.sort(rng.uniform(0.0, 2.0, 40))
    poses = [_random_pose(rng) for _ in stamps]
    ext = _random_pose(rng)
    for tf in tfs:
        tf.add_static_transform("base", "lidar", ext)
        for s, T in zip(stamps, poses):
            tf.add_pose("base", float(s), T)
    n_interp = 0
    for q in rng.uniform(-0.2, 2.2, 200):
        for frame in ("base", "lidar"):
            a, b = (tf.lookup_transform_to_global_frame(frame, float(q))
                    for tf in tfs)
            assert (a is None) == (b is None)
            if a is None:
                continue
            near = np.min(np.abs(stamps - q)) <= 0.01
            if near:
                np.testing.assert_array_equal(a, b)
            else:
                n_interp += 1
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    assert n_interp > 50


# ------------------------------------------------------------------ queues
def test_drop_oldest_queue():
    q = DropOldestQueue("test", max_length=3)
    for i in range(5):
        q.push(i)
    assert q.dropped_count == 2
    items = q.extract_ready(lambda x: x % 2 == 0)
    assert items == [2, 4]
    assert len(q) == 1  # 3 stays queued


def test_queues_match_reference():
    """A seeded stream of pushes and ready-extractions: the same items
    out, the same drops, the same backlog."""
    rng = np.random.default_rng(3)
    qs = [mod.DropOldestQueue("q", max_length=7) for mod in (tq, jq)]
    outs = ([], [])
    for i, (op, m) in enumerate(zip(rng.integers(0, 4, 300),
                                    rng.integers(2, 5, 300))):
        for q, out in zip(qs, outs):
            if op:
                q.push(i)
            else:
                out.append(q.extract_ready(lambda x: x % m == 0))
    assert outs[0] == outs[1]
    assert qs[0].dropped_count == qs[1].dropped_count > 0
    assert qs[0].extract_all() == qs[1].extract_all()


def test_service_queue_runs_on_processing_thread():
    sq = ServiceRequestQueue()
    fut = sq.submit(lambda: 42)
    assert not fut.done()
    assert sq.process_all() == 1
    assert fut.result(timeout=1) == 42
    # Exceptions propagate to the caller.
    fut2 = sq.submit(lambda: 1 / 0)
    sq.process_all()
    with pytest.raises(ZeroDivisionError):
        fut2.result(timeout=1)


# ----------------------------------------------------------------- timing
def test_timing_and_rates_registries():
    t = TimingRegistry()
    t.record("a/b", 0.01)
    t.record("a/b", 0.03)
    assert t.get("a/b").count == 2
    assert abs(t.get("a/b").mean - 0.02) < 1e-9
    assert "a/b" in t.to_string()

    r = RatesRegistry()
    fake = [0.0]
    r.set_clock(lambda: fake[0])
    for _ in range(5):
        r.tick("x")
        fake[0] += 0.1
    assert abs(r.rate_hz("x") - 10.0) < 1e-6

    d = DelaysRegistry()
    d.record("y", 0.25)
    assert d.mean_s("y") == 0.25


def test_registries_print_as_reference():
    """The same records give the same tables."""
    rng = np.random.default_rng(5)
    regs = [(m.TimingRegistry(), m.RatesRegistry(), m.DelaysRegistry())
            for m in (ttiming, jtiming)]
    clock = [0.0]
    for r in regs:
        r[1].set_clock(lambda: clock[0])
    for k in range(50):
        name = f"node/{'abc'[k % 3]}"
        dt = float(rng.uniform(0, 0.05))
        for t, r, d in regs:
            t.record(name, dt)
            r.tick(name)
            d.record(name, dt * 2)
        clock[0] += float(rng.uniform(0.01, 0.1))
    for a, b in zip(*regs):
        assert a.to_string() == b.to_string()


def test_timer_waits_only_when_blocked(monkeypatch):
    """A Timer records its span and never waits on the device: it takes
    no value to block on, and neither a synchronize nor an event wait
    runs while it opens and closes."""
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: waits.append("synchronize"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda *a, **k: waits.append("event"))
    ttiming.Timing.reset()
    with Timer("t/plain"):
        torch.zeros(3).add_(1)
    with pytest.raises(TypeError):
        Timer("t/blocked", torch.zeros(3))
    assert not hasattr(Timer, "set_block")
    assert not hasattr(ttiming, "wait_for")
    assert ttiming.Timing.get("t/plain").count == 1
    assert ttiming.Timing.get("t/plain").total > 0
    assert "t/blocked" not in ttiming.Timing._stats
    assert waits == []
    ttiming.Timing.reset()


# ----------------------------------------------------------------- costmap
def test_distance_to_cost_mapping():
    p = CostmapLayerParams(inflation_distance_m=0.5,
                           max_obstacle_distance_m=1.0, min_distance_m=0.0)
    d = np.asarray([[-0.1, 0.2, 0.7, 2.0, 1000.0]], np.float32)
    cost = distance_to_cost(d, unknown_value=1000.0, params=p)
    assert cost[0, 0] == LETHAL_OBSTACLE
    assert cost[0, 1] == INSCRIBED_INFLATED_OBSTACLE
    assert 0 < cost[0, 2] < INSCRIBED_INFLATED_OBSTACLE
    assert cost[0, 3] == FREE_SPACE
    assert cost[0, 4] == NO_INFORMATION


@pytest.mark.parametrize("to_free", [False, True])
def test_costs_match_reference(to_free):
    """Seeded distances (obstacles, falloff, free, unknown) give the same
    cost grid and the same master-grid merge."""
    rng = np.random.default_rng(11)
    d = rng.uniform(-0.5, 2.0, (40, 50)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 1000.0
    kw = dict(inflation_distance_m=0.4, max_obstacle_distance_m=1.2,
              min_distance_m=0.05, convert_unknown_to_free=to_free)
    a = tcm.distance_to_cost(d, 1000.0, tcm.CostmapLayerParams(**kw))
    b = jcm.distance_to_cost(d, 1000.0, jcm.CostmapLayerParams(**kw))
    np.testing.assert_array_equal(a, b)
    assert len(np.unique(a)) > 10
    master = rng.integers(0, 200, (60, 70)).astype(np.uint8)
    points = rng.uniform(-1.5, 2.0, (50, 2))
    merged, queried = [], []
    for m, cm in ((tmsgs, tcm), (jmsgs, jcm)):
        bus = m.MessageBus()
        layer = cm.NvbloxCostmapLayer(bus,
                                      params=cm.CostmapLayerParams(**kw))
        bus.publish("~/static_map_slice", m.DistanceMapSlice(
            header=m.Header(), origin_x_m=-1.0, origin_y_m=-0.5,
            resolution_m=0.05, width=50, height=40, unknown_value=1000.0,
            data=d))
        out = master.copy()
        layer.update_costs(out, -1.2, -0.7, 0.04)
        merged.append(out)
        queried.append([layer.cost_at(x, y) for x, y in points])
    np.testing.assert_array_equal(merged[0], merged[1])
    assert not np.array_equal(merged[0], master)
    assert queried[0] == queried[1]


def test_costmap_layer_bus_integration():
    bus = MessageBus()
    layer = NvbloxCostmapLayer(bus)
    data = np.full((10, 10), 2.0, np.float32)
    data[5, 5] = -0.1
    msg = DistanceMapSlice(header=Header(), origin_x_m=0.0, origin_y_m=0.0,
                           resolution_m=0.1, width=10, height=10,
                           unknown_value=1000.0, data=data)
    bus.publish("~/static_map_slice", msg)
    assert layer.has_data
    assert layer.cost_at(0.55, 0.55) == LETHAL_OBSTACLE
    assert layer.cost_at(0.05, 0.05) == FREE_SPACE
    assert layer.cost_at(-1.0, 0.0) == NO_INFORMATION
    master = np.zeros((20, 20), np.uint8)
    layer.update_costs(master, 0.0, 0.0, 0.05)
    assert master.max() == LETHAL_OBSTACLE


# ---------------------------------------------------------------- adapters
def test_mesh_adapter_flattens_and_removes():
    bus = MessageBus()
    out = []
    tad.MeshLayerAdapter(bus)
    bus.subscribe("~/mesh_serialized", out.append)

    def block(idx, n):
        return MeshBlockMsg(index=Index3D(*idx),
                            vertices=np.zeros((3 * n, 3), np.float32),
                            colors=np.zeros((3 * n, 3), np.uint8),
                            triangles=np.arange(3 * n).reshape(n, 3))

    bus.publish("~/mesh", MeshMsg(header=Header(), block_size_m=0.4,
                                  blocks=[block((0, 0, 0), 2),
                                          block((1, 0, 0), 3)],
                                  removed_blocks=[]))
    assert out[-1].triangles.shape[0] == 5
    # Triangle indices must be re-indexed into the flat vertex buffer.
    assert out[-1].triangles.max() == out[-1].vertices.shape[0] - 1
    bus.publish("~/mesh", MeshMsg(header=Header(), block_size_m=0.4,
                                  blocks=[],
                                  removed_blocks=[Index3D(0, 0, 0)]))
    assert out[-1].triangles.shape[0] == 3


def test_adapters_match_reference():
    """Seeded incremental mesh and voxel-layer messages (updates, empty
    blocks, removals) flatten to the same arrays."""
    outs = []
    for m, ad in ((tmsgs, tad), (jmsgs, jad)):
        rng_k = np.random.default_rng(13)
        bus = m.MessageBus()
        mesh_out, vox_out = [], []
        ad.MeshLayerAdapter(bus)
        ad.VoxelLayerAdapter(bus, "~/tsdf_layer", "~/tsdf_serialized")
        bus.subscribe("~/mesh_serialized", mesh_out.append)
        bus.subscribe("~/tsdf_serialized", vox_out.append)
        for _ in range(12):
            keys = [tuple(int(v) for v in rng_k.integers(-2, 3, 3))
                    for _ in range(4)]
            blocks, vblocks = [], []
            for k in keys:
                n = int(rng_k.integers(0, 4))
                blocks.append(m.MeshBlockMsg(
                    index=m.Index3D(*k),
                    vertices=rng_k.random((3 * n, 3)).astype(np.float32),
                    colors=rng_k.integers(0, 255, (3 * n, 3)).astype(
                        np.uint8),
                    triangles=np.arange(3 * n).reshape(n, 3)))
                vblocks.append(m.VoxelBlockMsg(
                    index=m.Index3D(*k),
                    centers=rng_k.random((n, 3)).astype(np.float32),
                    values=rng_k.random(n).astype(np.float32)))
            removed = [m.Index3D(*(int(v) for v in rng_k.integers(-2, 3, 3)))]
            bus.publish("~/mesh", m.MeshMsg(
                header=m.Header(), block_size_m=0.4, blocks=blocks,
                removed_blocks=removed))
            bus.publish("~/tsdf_layer", m.VoxelBlockLayerMsg(
                header=m.Header(), layer_name="tsdf_distance",
                block_size_m=0.4, voxel_size_m=0.05, blocks=vblocks,
                removed_blocks=removed))
        outs.append((mesh_out, vox_out))
    (ma, va), (mb, vb) = outs
    assert len(ma) == len(mb) == 12 and len(va) == len(vb) == 12
    for x, y in zip(ma, mb):
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for x, y in zip(va, vb):
        for f in ("centers", "values"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    assert ma[-1].triangles.shape[0] > 0


# ------------------------------------------------------------------ params
def test_params_overlay_and_enum_parsing():
    p = make_params(mode="dynamic", overlay={
        "voxel_size_m": 0.1,
        "static_mapper.projective.max_weight": 20.0,
        "static_mapper": {"projective": {"weighting_mode": "constant"}},
    })
    assert p.mapping_type == MappingType.DYNAMIC
    assert p.voxel_size_m == 0.1
    assert p.static_mapper.projective.max_weight == 20.0
    assert p.static_mapper.projective.weighting_mode == \
        WeightingFunctionType.CONSTANT


def test_params_unknown_keys_warn_not_raise():
    p = make_params(overlay={"definitely_not_a_param": 1})
    assert p.voxel_size_m == 0.05  # defaults intact


def test_params_bad_enum_warns_and_defaults():
    p = make_params(overlay={"esdf_mode": "4d"})
    assert p.esdf_mode.value == "2d"


def test_projective_layer_type_mapping():
    assert projective_layer_type(MappingType.STATIC_TSDF) \
        == ProjectiveLayerType.TSDF
    assert projective_layer_type(MappingType.STATIC_OCCUPANCY) \
        == ProjectiveLayerType.OCCUPANCY


def test_param_tree_string():
    s = param_tree_string(make_params())
    assert "voxel_size_m: 0.05" in s
    assert "max_integration_distance_m" in s


OVERLAY = {"voxel_size_m": 0.1, "block_capacity": 4096,
           "esdf_mode": "3d",
           "static_mapper.projective.weighting_mode":
               "inverse_square_tsdf_distance_penalty",
           "static_mapper": {"view": {"workspace_bounds_type":
                                      "height_bounds"},
                             "esdf": {"max_esdf_distance_m": 1.5}},
           "dynamic_mapper.occupancy.free_region_occupancy_probability":
               0.3,
           "not_a_field": 3}


@pytest.mark.parametrize("mode", sorted(jp.MODE_OVERLAYS) + [None, "nope"])
@pytest.mark.parametrize("overlay", [None, OVERLAY], ids=["plain", "user"])
def test_param_trees_match_reference(mode, overlay):
    """Every mode, with and without a user overlay (dotted and nested
    keys, enum strings, an unknown key), prints the reference's tree."""
    assert param_tree_string(make_params(mode, overlay)) == \
        jp.param_tree_string(jp.make_params(mode, overlay))


# --------------------------------------------------------------- streaming
def test_streamer_respects_bandwidth_budget():
    t = [0.0]
    streamer = tls.LayerStreamer(
        block_size_m=0.4,
        params=tls.StreamingParams(bandwidth_mbps=8.0,
                                   bytes_per_block=100_000),
        clock=lambda: t[0])
    streamer.mark_dirty([(i, 0, 0) for i in range(100)])
    t[0] = 0.1
    first = streamer.select_blocks()
    assert len(first) == 1
    assert streamer.num_pending == 99
    # A long gap accrues a bigger budget.
    t[0] = 2.0
    more = streamer.select_blocks()
    assert len(more) > 10


def test_streamer_prioritizes_near_and_excludes_far():
    t = [0.0]
    streamer = tls.LayerStreamer(
        block_size_m=1.0,
        params=tls.StreamingParams(bandwidth_mbps=1000.0),
        exclusion=tls.BlockExclusionParams(exclusion_center_m=(0.0, 0.0),
                                           exclusion_radius_m=5.0,
                                           exclusion_height_m=2.0),
        clock=lambda: t[0])
    streamer.mark_dirty([(0, 0, 0), (3, 0, 0), (10, 0, 0), (0, 0, 5)])
    t[0] = 1.0
    out = streamer.select_blocks()
    # Far (10,0,0) and high (0,0,5) are excluded; near-first ordering.
    assert out == [(0, 0, 0), (3, 0, 0)]
    assert streamer.num_pending == 0


def test_streamer_selections_match_reference():
    """Seeded dirty sets over a seeded clock, with exclusion: the same
    selections in the same order."""
    rng = np.random.default_rng(17)
    clock = [0.0]
    streamers = [mod.LayerStreamer(
        block_size_m=0.4,
        params=mod.StreamingParams(bandwidth_mbps=4.0),
        exclusion=mod.BlockExclusionParams(exclusion_center_m=(0.5, -0.3),
                                           exclusion_radius_m=4.0,
                                           exclusion_height_m=2.5),
        clock=lambda: clock[0]) for mod in (tls, jls)]
    sels = ([], [])
    for _ in range(40):
        keys = [tuple(int(v) for v in k)
                for k in rng.integers(-12, 12, (int(rng.integers(0, 60)), 3))]
        clock[0] += float(rng.uniform(0.01, 0.3))
        for s, out in zip(streamers, sels):
            s.mark_dirty(keys)
            out.append(s.select_blocks(
                max_blocks=None if len(out) % 3 else 5))
    assert sels[0] == sels[1]
    assert sum(map(len, sels[0])) > 100
    assert streamers[0].num_pending == streamers[1].num_pending


# ----------------------------------------------------------- sensor helpers
def test_frame_splitter_requires_alternation():
    bus = MessageBus()
    got = {"on": 0, "off": 0}
    bus.subscribe("~/splitter/emitter_on/frame",
                  lambda f: got.__setitem__("on", got["on"] + 1))
    bus.subscribe("~/splitter/emitter_off/frame",
                  lambda f: got.__setitem__("off", got["off"] + 1))
    sp = tsh.FrameSplitter(bus)
    # Constant mode: nothing forwarded.
    for i in range(3):
        sp.callback(tsh.FrameMeta(data=i, stamp_s=i * 0.03, emitter_on=True))
    assert got == {"on": 0, "off": 0}
    # Alternation starts -> frames flow to their branches.
    sp.callback(tsh.FrameMeta(data=3, stamp_s=0.09, emitter_on=False))
    sp.callback(tsh.FrameMeta(data=4, stamp_s=0.12, emitter_on=True))
    sp.callback(tsh.FrameMeta(data=5, stamp_s=0.15, emitter_on=False))
    assert got["on"] == 1 and got["off"] == 2


def test_emitter_synchronizer_separates_phases():
    params = tsh.EmitterSyncParams(frame_period_s=0.1, correction_gain=1.0)
    sync = tsh.EmitterPhaseSynchronizer(["cam0", "cam1"], params)
    # Both cameras currently fire at phase 0 -> cam1 must shift by half a
    # period (its target phase is 0.05).
    sync.observe_frame("cam0", 10.0, emitter_on=True)
    sync.observe_frame("cam1", 10.0, emitter_on=True)
    corr = sync.update()
    assert abs(corr["cam0"]) < 1e-9
    assert abs(abs(corr["cam1"]) - 0.05) < 1e-9
    # After applying, cam1 at phase 0.05 -> no further correction.
    sync.observe_frame("cam1", 10.25, emitter_on=True)  # phase 0.05
    corr2 = sync.update()
    assert abs(corr2["cam1"]) < 1e-9


def test_sensor_helpers_match_reference():
    """Seeded emitter streams: the same forwarded frames and the same
    phase corrections."""
    rng = np.random.default_rng(19)
    stream = [(float(k * 0.033 + rng.uniform(0, 0.01)), bool(b),
               f"cam{int(c)}")
              for k, (b, c) in enumerate(zip(rng.integers(0, 2, 60),
                                             rng.integers(0, 3, 60)))]
    out = []
    for m, sh in ((tmsgs, tsh), (jmsgs, jsh)):
        bus = m.MessageBus()
        got = []
        for branch in ("on", "off"):
            bus.subscribe(f"~/splitter/emitter_{branch}/frame",
                          lambda f, b=branch: got.append((b, f.data)))
        sp = sh.FrameSplitter(bus)
        sync = sh.EmitterPhaseSynchronizer(
            ["cam0", "cam1", "cam2"],
            sh.EmitterSyncParams(frame_period_s=0.05, correction_gain=0.5))
        corrs = []
        for i, (stamp, on, cam) in enumerate(stream):
            sp.callback(sh.FrameMeta(data=i, stamp_s=stamp, emitter_on=on,
                                     camera_name=cam))
            sync.observe_frame(cam, stamp, on)
            if i % 5 == 4:
                corrs.append(sync.update())
        out.append((got, corrs))
    assert out[0] == out[1]
    assert out[0][0] and out[0][1][-1]
