"""The port's span log and counters (`utils/timing.py`): the sub-spans of
the node's and the fuser's depth and mesh steps, their parents and
times, and the host-read and deferred-block counters, on the CPU at the
tests' size."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.datasets.fuser import Fuser, FuserConfig
from isaac_ros_nvblox_tpu_torch.datasets.synthetic import SyntheticDataLoader
from isaac_ros_nvblox_tpu_torch.mapper import device_io
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
from isaac_ros_nvblox_tpu_torch.mapper.params import make_params
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.scene import (default_test_scene,
                                                     orbit_pose,
                                                     render_color,
                                                     render_depth)
from isaac_ros_nvblox_tpu_torch.runtime.adapters import MeshLayerAdapter
from isaac_ros_nvblox_tpu_torch.runtime.node import NodeParams, NvbloxNode
from isaac_ros_nvblox_tpu_torch.utils.timing import Timer, Timing

torch.set_num_threads(2)

CAM = Camera(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
SCENE = default_test_scene()
WORLD = wg.WorldGridConfig(dims=(64, 64, 32), capacity=4096,
                           origin_block=(-32, -32, -8))
TICKS = 25            # 0.25 s at 10 ms: depth at 40 Hz, mesh at 5 Hz
DEPTH_ROOTS = {"node/depth/integrate": "node/tick",
               "fuser/depth": "fuser/frame"}
MESH_SPANS = ("node/mesh/update", "fuser/mesh")


def _ring_scan(n=512, radius=2.0):
    az = np.linspace(-np.pi, np.pi, n, endpoint=False)
    return np.stack([radius * np.cos(az), radius * np.sin(az),
                     np.zeros_like(az)], 1).astype(np.float32)


def _run_node():
    """A node as a viewer runs it, from one pose: the mesh and the slice
    subscribed, depth and color every tick, a lidar scan every tenth.
    Returns the frames it integrated."""
    node = NvbloxNode(NodeParams(), make_params(overlay={
        "block_capacity": WORLD.capacity}), world=WORLD, device="cpu")
    clock = [0.0]
    node.clock = lambda: clock[0]
    MeshLayerAdapter(node.bus)
    node.bus.subscribe("~/static_map_slice", lambda msg: None)
    T = orbit_pose(0.0)
    depth = render_depth(SCENE, CAM, T, device="cpu").numpy()
    color = render_color(SCENE, CAM, T, device="cpu").numpy()
    scan = _ring_scan()
    for k in range(TICKS):
        now = k * 0.01
        for frame in ("cam", "lidar", "base_link"):
            node.add_pose(frame, now, T)
        node.add_depth_image(depth, CAM, "cam", now)
        node.add_color_image(color, CAM, "cam", now)
        if k % 10 == 0:
            node.add_pointcloud(scan, "lidar", now)
        clock[0] = now
        node.tick()
    return Timing.get("node/depth/integrate").count


def _run_fuser(frames=4):
    """The fuser over `frames` frames, the mesh every second and the ESDF
    on the first only."""
    fuser = Fuser(SyntheticDataLoader(num_frames=frames, camera=CAM,
                                      device="cpu"),
                  FuserConfig(capacity=WORLD.capacity,
                              mesh_frame_subsampling=2,
                              esdf_frame_subsampling=frames),
                  world=WORLD, device="cpu")
    for frame in fuser.loader:
        fuser.integrate_frame(frame)
    return fuser.frame_count


RUNS = {"node": _run_node, "fuser": _run_fuser}


@pytest.fixture(scope="module", params=sorted(RUNS))
def traced(request):
    """One run under a CPU profile: (kind, log, perf_counter before and
    after, frames integrated)."""
    Timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        frames = RUNS[request.param]()
        t1 = time.perf_counter()
    log = Timing.span_log()
    Timing.reset()
    return request.param, log, t0, t1, frames


def _children(log):
    out = {}
    for r in log:
        out.setdefault(r.parent, []).append(r)
    return out


def _descendants(rec, children):
    stack, out = [rec], []
    while stack:
        for c in children.get(stack.pop().id, []):
            out.append(c)
            stack.append(c)
    return out


def _total(recs, counter):
    return sum(r.counters.get(counter, (0, 0))[0] for r in recs)


def test_no_profile_keeps_no_log(traced):
    """Without a profile nothing is logged, and the spans count as they
    do under one: one depth span (the frames integrated) and one of each
    depth sub-span per frame."""
    kind, _, _, _, frames = traced
    Timing.reset()
    assert RUNS[kind]() == frames > 0
    assert Timing.span_log() == []
    depth = "node/depth/integrate" if kind == "node" else "fuser/depth"
    for name in (depth, "mapper/depth/upload", "mapper/depth/blocks",
                 "mapper/depth/fuse"):
        assert Timing.get(name).count == frames, name
    assert Timing.counter("host/reads").count > 0
    Timing.reset()


def test_depth_steps_have_their_sub_spans(traced):
    kind, log, _, _, frames = traced
    children = _children(log)
    depth = [r for r in log if r.name in DEPTH_ROOTS]
    assert len(depth) == frames > 0
    fused = 0
    for rec in depth:
        names = [c.name for c in _descendants(rec, children)]
        for sub in ("upload", "blocks", "fuse"):
            assert names.count(f"mapper/depth/{sub}") == 1, (sub, names)
        fused += "mapper/esdf2d/solve" in names
    # The node's ESDF ticks fuse the 2-D solve into the depth span.
    assert (fused > 0) == (kind == "node")


def test_mesh_updates_have_their_sub_spans(traced):
    _, log, _, _, _ = traced
    children = _children(log)
    mesh = [r for r in log if r.name in MESH_SPANS]
    assert mesh
    for rec in mesh:
        names = [c.name for c in children.get(rec.id, [])]
        assert names == ["mapper/mesh/march", "mapper/mesh/readback",
                         "mapper/mesh/layer"], names
        assert _total(_descendants(rec, children), "host/reads") >= 3
        sub = children[rec.id][1].counters
        assert sub["mapper/mesh/deferred_blocks"][1] == 1


def test_spans_nest_and_chain_to_a_root(traced):
    kind, log, t0, t1, _ = traced
    by_id = {r.id: r for r in log}
    root = "node/tick" if kind == "node" else "fuser/frame"
    assert len({r.id for r in log}) == len(log)
    for r in log:
        assert t0 <= r.start <= r.end <= t1, r.name
        top = r
        while top.parent is not None:
            parent = by_id[top.parent]
            assert parent.start <= top.start <= top.end <= parent.end
            top = parent
        assert top.name == root, (r.name, top.name)
    if kind == "node":
        assert any(r.name == "node/mesh/publish" for r in log)
        assert any(r.name == "mapper/lidar/blocks" for r in log)


def test_depth_and_lidar_steps_read_nothing(traced):
    _, log, _, _, _ = traced
    children = _children(log)
    steps = [r for r in log if r.name in DEPTH_ROOTS
             or r.name in ("node/lidar/integrate", "node/color/integrate")]
    assert steps
    for rec in steps:
        inside = [rec] + _descendants(rec, children)
        assert _total(inside, "host/reads") == 0, rec.name
    # Every read of the window was logged inside some span.
    assert _total(log, "host/reads") > 0


def _mapper_with_frames(n=2):
    m = DeviceMapper(0.05, world=WORLD, device="cpu")
    for k in range(n):
        T = orbit_pose(0.5 * k)
        m.integrate_depth(render_depth(SCENE, CAM, T, device="cpu").numpy(),
                          T, CAM)
    return m


@pytest.mark.parametrize("max_blocks", [8, 64])
def test_deferred_blocks_count_what_the_budget_leaves(max_blocks):
    m = _mapper_with_frames()
    Timing.reset()
    device_io.update_mesh_layer(m, max_blocks=max_blocks)
    c = Timing.counter("mapper/mesh/deferred_blocks")
    left = int((m.dirty | m.mesh_pending).sum())
    assert c.count == 1 and c.total == left > 0
    assert Timing.counter("host/reads").count >= 4
    Timing.reset()


def test_reset_clears_log_and_counters():
    with profile(activities=[ProfilerActivity.CPU]):
        with Timer("t/outer"):
            with Timer("t/inner"):
                Timing.add("t/count", 3)
    log = Timing.span_log()
    assert [r.name for r in log] == ["t/inner", "t/outer"]
    assert log[0].parent == log[1].id and log[1].parent is None
    assert log[0].counters == {"t/count": [3.0, 1]}
    assert "t/count" in Timing.to_string()
    Timing.reset()
    assert Timing.span_log() == [] and not Timing._counters
    assert Timing.get("t/outer").count == 0
    assert "counter" not in Timing.to_string()
