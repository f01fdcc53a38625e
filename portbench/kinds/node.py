"""The online node: `NvbloxNode` driven as a robot drives it, and what its
run is compared by.

`Program` builds the node from the configuration's parameters, gives it a
simulated clock and the traffic's subscribers, and runs one tick per
`step()`, handing over before each tick the poses, frames and scans that
`schedule.NodeSchedule` makes due, under the sensor frame names the
configuration gives (`camera.frame`, `lidar.frame`; "cam" and "lidar"
where it names none). The reference replays the same schedule from the
inputs alone (reference/node.py); the compared numbers are the TSDF,
color, the last published slice and, where a viewer subscribes, the
node's mesh layer.

A mode of the node with other outputs is a kind of its own
(`kinds/<kind>.py`) that reuses what it can of this module.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from portbench import programs
from portbench.schedule import NodeSchedule


def voxel_size(config: Dict) -> float:
    return float(config["params"]["mapper"]["voxel_size_m"])


def frame_names(config: Dict):
    return (config["camera"].get("frame", "cam"),
            (config.get("lidar") or {}).get("frame", "lidar"))


def warm_up_steps(config: Dict) -> int:
    """Ticks until the mesh and ESDF gates have both run twice: one common
    period of the two, plus one."""
    n = config["params"]["node"]
    tick = float(n["tick_period_ms"])
    period = np.lcm(int(round(1000 / n["update_mesh_rate_hz"] / tick)),
                    int(round(1000 / n["update_esdf_rate_hz"] / tick)))
    return int(period) + 1


def schedule(config: Dict, lap) -> NodeSchedule:
    return NodeSchedule(config, lap.depths.shape[0],
                        0 if lap.scans is None else lap.scans.shape[0])


class Program:
    def __init__(self, config: Dict, traffic: Dict, lap, device):
        from isaac_ros_nvblox_tpu_torch.runtime.adapters import \
            MeshLayerAdapter
        from isaac_ros_nvblox_tpu_torch.runtime.config_loader import \
            config_from_dict
        from isaac_ros_nvblox_tpu_torch.runtime.costmap import \
            NvbloxCostmapLayer
        from isaac_ros_nvblox_tpu_torch.runtime.node import NvbloxNode
        node_params, mapper_params = config_from_dict(config["params"])
        self.node = NvbloxNode(node_params, mapper_params,
                               world=programs.world(config), device=device)
        self._now = 0.0
        self.node.clock = lambda: self._now
        self.config = config
        self.camera = programs.camera(config)
        self.cam_frame, self.lidar_frame = frame_names(config)
        self.lap = lap
        self.sched = schedule(config, lap)
        self.i = 0
        self.counting = False
        self.host_bytes = 0
        self.last_slice = None
        self.viewer = None
        subs = traffic["subscribers"]
        bus = self.node.bus
        if subs.get("costmap"):
            self.costmap = NvbloxCostmapLayer(bus)
        if subs.get("static_map_slice"):
            bus.subscribe("~/static_map_slice", self._on_slice)
        if subs.get("mesh"):
            self.viewer = MeshLayerAdapter(bus)
            bus.subscribe("~/mesh_serialized", self._on_mesh)

    def _on_slice(self, msg) -> None:
        self.last_slice = msg
        if self.counting:
            self.host_bytes += self.node.last_host_bytes.get("slice", 0)

    def _on_mesh(self, msg) -> None:
        if self.counting:
            self.host_bytes += self.node.last_host_bytes.get("mesh", 0)

    def step(self) -> Optional[float]:
        """One tick; returns the host time its depth frame was handed over
        (None on a tick with no new depth frame)."""
        i, s, lap, node = self.i, self.sched, self.lap, self.node
        now = s.now(i)
        if s.pose_due(i):
            node.add_pose(self.cam_frame, now, lap.orbit.camera_pose(now))
            T_l = lap.orbit.lidar_pose(now)
            node.add_pose(self.lidar_frame, now, T_l)
            node.add_pose("base_link", now, T_l)
        handoff = None
        n = lap.depths.shape[0]
        for k in s.frames_at(i):
            stamp = s.frame_stamp(k)
            handoff = time.perf_counter()
            node.add_depth_image(lap.depths[k % n], self.camera,
                                 self.cam_frame, stamp)
            node.add_color_image(lap.colors[k % n], self.camera,
                                 self.cam_frame, stamp)
        for m in s.scans_at(i):
            node.add_pointcloud(lap.scans[m % lap.scans.shape[0]],
                                self.lidar_frame, s.scan_stamp(m),
                                timestamps_s=lap.scan_rel)
        self._now = now
        node.tick()
        self.i += 1
        return handoff

    def steps_done(self) -> int:
        return self.i

    def at_cadence_end(self) -> bool:
        """The last tick ran the mesh and ESDF gates' common period: a
        tick whose time is a multiple of both periods."""
        p = self.node.params
        period_ms = int(round(1000.0 / p.update_mesh_rate_hz))
        esdf_ms = int(round(1000.0 / p.update_esdf_rate_hz))
        t_ms = (self.i - 1) * self.sched.tick_ms
        return t_ms % period_ms == 0 and t_ms % esdf_ms == 0

    def frames_integrated(self) -> int:
        from isaac_ros_nvblox_tpu_torch.utils.timing import Timing
        return Timing.get("node/depth/integrate").count

    def settle(self) -> None:
        """After the window: the node's mesh update run until the work
        its budget deferred is done (where a viewer subscribes)."""
        if self.viewer is not None:
            mm = self.node.multi_mapper
            programs.settle_mesh(mm.update_mesh, mm.static_mapper)

    def outputs(self) -> Dict:
        """The static mapper's live TSDF and color rows, the last slice
        published on `~/static_map_slice` and, where a viewer subscribes,
        the mesh layer the node publishes from (the viewer receives it
        under the layer streamer's bandwidth budget), copied to the
        host."""
        m = self.node.multi_mapper.static_mapper
        out = {"tsdf": programs.live_rows(
            m, ["tsdf_distance", "tsdf_weight"] + programs.COLOR)}
        sl = self.last_slice
        out["slice"] = None if sl is None else {
            "origin_x_m": float(sl.origin_x_m),
            "origin_y_m": float(sl.origin_y_m), "width": int(sl.width),
            "height": int(sl.height), "data": np.asarray(sl.data)}
        if self.viewer is not None:
            out["mesh"] = programs.mesh_of(m.mesh_layer.blocks,
                                           voxel_size(self.config))
        return out


def reference(cell, lap, n_steps: int, warm: int, device,
              dtype=torch.float32) -> Dict:
    """The plain reference's replay of the run's ticks."""
    from portbench.reference import node as node_ref
    return node_ref.replay(cell.config, schedule(cell.config, lap), lap,
                           n_steps, device=device, dtype=dtype,
                           window_from=warm, mesh=cell.meshes)


def numbers(cell, outputs: Dict, ref: Dict) -> Dict:
    """`tsdf_off_share`, `color_off_share`, `slice_off_share` and, where a
    viewer subscribes, `mesh_off_share`."""
    from portbench import compare
    nums = programs.map_numbers(outputs, ref)
    unknown = float(cell.config["params"]["node"]
                    ["distance_map_unknown_value_optimistic"])
    nums["slice_off_share"] = compare.share(compare.slice_off(
        outputs["slice"], ref["slice"], unknown, voxel_size(cell.config)))
    return nums


def stand_in(cell, ref: Dict) -> Dict:
    """A reference run's outputs in the form a program's take (the
    control's stand-in for the program)."""
    dmap = ref["map"]
    out = {"tsdf": programs.dense_rows(ref, programs.map_grids(dmap)),
           "slice": ref["slice"]}
    if cell.meshes:
        out["mesh"] = ref["mesh"]
    return out
