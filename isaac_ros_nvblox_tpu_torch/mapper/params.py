"""Mapper parameters (port of isaac_ros_nvblox_tpu/mapper/params.py).

Holds the groups the depth -> TSDF -> ESDF and colored-mesh paths read,
with the reference's field names and defaults. Later slices add the decay,
freespace and occupancy groups.
"""

from __future__ import annotations

import dataclasses

from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.mesh import MeshIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                 WeightingFunctionType)
from isaac_ros_nvblox_tpu_torch.ops.view import ViewCalculatorParams


@dataclasses.dataclass
class MapperParams:
    """Per-mapper parameters of the TSDF + color + mesh + ESDF mapper."""
    projective: TsdfIntegratorParams = dataclasses.field(
        default_factory=TsdfIntegratorParams)
    view: ViewCalculatorParams = dataclasses.field(
        default_factory=ViewCalculatorParams)
    esdf: EsdfIntegratorParams = dataclasses.field(
        default_factory=EsdfIntegratorParams)
    mesh: MeshIntegratorParams = dataclasses.field(
        default_factory=MeshIntegratorParams)


def mesh_accuracy_params(max_integration_distance_m: float = 7.0
                         ) -> MapperParams:
    """The benchmark's mesh-accuracy overlay (bench.py:594-602):
    tsdf-distance-penalty weighting and mesh min_weight 0.02, which keep
    low-weight silhouette crossings out of the mesh."""
    return MapperParams(
        projective=TsdfIntegratorParams(
            max_integration_distance_m=max_integration_distance_m,
            weighting_mode=(WeightingFunctionType
                            .INVERSE_SQUARE_TSDF_DISTANCE_PENALTY)),
        mesh=MeshIntegratorParams(min_weight=0.02))
