"""The offline fuser: `Fuser` handed a dataset's frames one by one, as the
port's dataset loaders hand them (host numpy depth, color and pose), and
what its run is compared by: the TSDF, color, the 3-D ESDF and, where the
traffic meshes, the mapper's whole mesh layer, against the plain
reference's replay of the same frames (reference/fuser.py).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import programs


def voxel_size(config: Dict) -> float:
    return float(config["fuser"]["voxel_size_m"])


def warm_up_steps(config: Dict) -> int:
    """Frames until the mesh and ESDF cadences have both run twice: one
    common period of the two, plus one."""
    f = config["fuser"]
    return int(np.lcm(int(f["mesh_frame_subsampling"]),
                      int(f["esdf_frame_subsampling"]))) + 1


class Program:
    def __init__(self, config: Dict, traffic: Dict, lap, device):
        from isaac_ros_nvblox_tpu_torch.datasets.fuser import (Fuser,
                                                               FuserConfig)
        from isaac_ros_nvblox_tpu_torch.mapper.params import (MapperParams,
                                                              apply_overlay)
        self.config = config
        params = apply_overlay(MapperParams(), config["mapper"])
        self.fuser = Fuser(None, FuserConfig(**config["fuser"]),
                           mapper_params=params,
                           world=programs.world(config), device=device)
        self.camera = programs.camera(config)
        self.lap = lap
        self.rate = float(config["frame_rate_hz"])
        self.meshes = bool(traffic.get("subscribers", {"mesh": True})
                           .get("mesh", False))
        self.i = 0
        self.counting = False
        self.host_bytes = 0
        self.period = warm_up_steps(config) - 1

    def step(self) -> float:
        """One frame through `Fuser.integrate_frame`; returns the host time
        it was handed over."""
        from isaac_ros_nvblox_tpu_torch.datasets.base import Frame
        n = self.lap.depths.shape[0]
        j = self.i % n
        frame = Frame(depth=self.lap.depths[j], T_L_C=self.lap.poses[j],
                      camera=self.camera, color=self.lap.colors[j],
                      timestamp_s=self.i / self.rate)
        meshes = (self.fuser.frame_count
                  % self.fuser.config.mesh_frame_subsampling == 0)
        handoff = time.perf_counter()
        self.fuser.integrate_frame(frame)
        if meshes and self.counting:
            self.host_bytes += self.fuser.mapper.last_mesh_host_bytes
        self.i += 1
        return handoff

    def steps_done(self) -> int:
        return self.i

    def at_cadence_end(self) -> bool:
        """The last frame ran both the mesh and the ESDF update."""
        return (self.i - 1) % self.period == 0

    def frames_integrated(self) -> int:
        from isaac_ros_nvblox_tpu_torch.utils.timing import Timing
        return Timing.get("fuser/depth").count

    def settle(self) -> None:
        """After the window: the fuser's mesh update run until the work
        its budget deferred is done (where the traffic meshes)."""
        if self.meshes:
            from isaac_ros_nvblox_tpu_torch.mapper import device_io
            m = self.fuser.mapper
            programs.settle_mesh(lambda: device_io.update_mesh_layer(m), m)

    def outputs(self) -> Dict:
        """The mapper's live TSDF, color and 3-D ESDF rows and its whole
        mesh layer, copied to the host."""
        m = self.fuser.mapper
        out = {"tsdf": programs.live_rows(
            m, ["tsdf_distance", "tsdf_weight"] + programs.COLOR
            + ["esdf_sq_dist", "esdf_is_inside", "esdf_observed"])}
        if self.meshes:
            out["mesh"] = programs.mesh_of(m.mesh_layer.blocks,
                                           voxel_size(self.config))
        return out


def reference(cell, lap, n_steps: int, warm: int, device,
              dtype=torch.float32) -> Dict:
    """The plain reference's replay of the run's frames."""
    from portbench.reference import fuser as fuser_ref
    return fuser_ref.replay(cell.config, lap, n_steps, device=device,
                            dtype=dtype, window_from=warm, mesh=cell.meshes)


def numbers(cell, outputs: Dict, ref: Dict) -> Dict:
    """`tsdf_off_share`, `color_off_share`, `esdf_off_share` and, where
    the traffic meshes, `mesh_off_share`."""
    from portbench import compare
    nums = programs.map_numbers(outputs, ref)
    t = outputs["tsdf"]
    sq, ins, obs = ref["esdf"]
    nums["esdf_off_share"] = compare.share(compare.esdf_off(
        t["blocks"], t["esdf_sq_dist"], t["esdf_is_inside"],
        t["esdf_observed"], sq, ins, obs, ref["map"].origin))
    return nums


def stand_in(cell, ref: Dict) -> Dict:
    """A reference run's outputs in the form a program's take (the
    control's stand-in for the program)."""
    dmap = ref["map"]
    sq, ins, obs = ref["esdf"]
    out = {"tsdf": programs.dense_rows(ref, {
        **programs.map_grids(dmap), "esdf_sq_dist": sq,
        "esdf_is_inside": ins, "esdf_observed": obs})}
    if cell.meshes:
        out["mesh"] = ref["mesh"]
    return out
