"""Fuser: the offline dataset-replay driver (port of
isaac_ros_nvblox_tpu/datasets/fuser.py).

Reference: nvblox `Fuser`/`CameraFuser` (nvblox/executables/fuser.h;
call-sites fuser_node.cpp:216 `fuser_->integrateFrame(n)`): load a frame,
integrate depth and color, update the ESDF and the mesh at their cadences,
and finish with a full update of both.

`backend="device"` (the default) runs the DeviceMapper: the kernels
tsdf_fuse and color_fuse every frame, the EDT passes and marching_cubes at
their cadences, the mesh into the host `MeshLayer` through
`device_io.update_mesh_layer`. `backend="host"` runs the host-table
`Mapper`, the debug backend, on the same device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from isaac_ros_nvblox_tpu_torch.datasets.base import DataLoader, Frame
from isaac_ros_nvblox_tpu_torch.mapper.params import (MapperParams,
                                                      ProjectiveLayerType)
from isaac_ros_nvblox_tpu_torch.utils.timing import Rates, Timer


@dataclasses.dataclass
class FuserConfig:
    voxel_size_m: float = 0.05
    # Update cadences in frames: depth and color every frame, mesh and
    # ESDF every 4th (nvblox_base.yaml-like relative rates).
    color_frame_subsampling: int = 1
    mesh_frame_subsampling: int = 4
    esdf_frame_subsampling: int = 4
    capacity: int = 16384


class Fuser:
    """Dataset replay driver on `device` (`cuda` unless the caller asks
    for another)."""

    def __init__(self, loader: DataLoader,
                 config: Optional[FuserConfig] = None,
                 mapper_params: Optional[MapperParams] = None,
                 backend: str = "device", world=None, device=None):
        self.loader = loader
        self.config = config or FuserConfig()
        self.backend = backend
        if backend == "device":
            from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
            from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import (
                DeviceMapper)
            world = world or wg.WorldGridConfig(
                dims=(128, 128, 32), capacity=self.config.capacity,
                origin_block=(-64, -64, -8))
            self.mapper = DeviceMapper(
                voxel_size_m=self.config.voxel_size_m, params=mapper_params,
                world=world, enable_color=True, device=device)
        elif backend == "host":
            from isaac_ros_nvblox_tpu_torch.mapper.mapper import Mapper
            self.mapper = Mapper(
                voxel_size_m=self.config.voxel_size_m,
                params=mapper_params,
                projective_layer=ProjectiveLayerType.TSDF,
                capacity=self.config.capacity,
                enable_color=True, enable_esdf=True, device=device)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.frame_count = 0

    def _update_mesh(self) -> None:
        if self.backend == "device":
            from isaac_ros_nvblox_tpu_torch.mapper import device_io
            device_io.update_mesh_layer(self.mapper)
        else:
            self.mapper.update_mesh()

    def integrate_frame(self, frame: Frame) -> None:
        with Timer("fuser/depth"):
            self.mapper.integrate_depth(frame.depth, frame.T_L_C, frame.camera)
        Rates.tick("fuser/depth")
        if (frame.color is not None
                and self.frame_count % self.config.color_frame_subsampling == 0):
            with Timer("fuser/color"):
                self.mapper.integrate_color(frame.color, frame.T_L_C,
                                            frame.camera, depth=frame.depth)
            Rates.tick("fuser/color")
        if self.frame_count % self.config.esdf_frame_subsampling == 0:
            with Timer("fuser/esdf"):
                self.mapper.update_esdf()
            Rates.tick("fuser/esdf")
        if self.frame_count % self.config.mesh_frame_subsampling == 0:
            with Timer("fuser/mesh"):
                self._update_mesh()
            Rates.tick("fuser/mesh")
        self.frame_count += 1

    def run(self, max_frames: Optional[int] = None) -> int:
        """Fuse the whole dataset; returns #frames integrated."""
        n = 0
        for frame in self.loader:
            self.integrate_frame(frame)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
        # Final full updates so outputs are complete.
        self.mapper.update_esdf()
        self._update_mesh()
        return n

    def output_mesh_ply(self, path) -> None:
        from isaac_ros_nvblox_tpu_torch.io.ply import write_mesh_ply
        v, c, t = self.mapper.mesh_layer.as_arrays()
        write_mesh_ply(path, v, t, c)
