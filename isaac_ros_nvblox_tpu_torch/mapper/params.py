"""Mapper parameters (port of isaac_ros_nvblox_tpu/mapper/params.py).

Holds the groups the TSDF, occupancy, colored-mesh, ESDF and decay paths
read, with the reference's field names and defaults, and the mapping-type
enums. The freespace group, the overlays and `make_params` come with the
runtime slice.
"""

from __future__ import annotations

import dataclasses
import enum

from isaac_ros_nvblox_tpu_torch.ops.decay import (OccupancyDecayParams,
                                                  TsdfDecayParams)
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.mesh import MeshIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.occupancy import OccupancyIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                 WeightingFunctionType)
from isaac_ros_nvblox_tpu_torch.ops.view import ViewCalculatorParams


class MappingType(enum.Enum):
    """nvblox's MappingType names."""
    STATIC_TSDF = "static_tsdf"
    STATIC_OCCUPANCY = "static_occupancy"
    DYNAMIC = "dynamic"
    HUMAN_WITH_STATIC_TSDF = "human_with_static_tsdf"
    HUMAN_WITH_STATIC_OCCUPANCY = "human_with_static_occupancy"


class ProjectiveLayerType(enum.Enum):
    TSDF = "tsdf"
    OCCUPANCY = "occupancy"


@dataclasses.dataclass
class MapperParams:
    """Per-mapper parameters of the TSDF / occupancy + color + mesh + ESDF
    mapper."""
    projective: TsdfIntegratorParams = dataclasses.field(
        default_factory=TsdfIntegratorParams)
    occupancy: OccupancyIntegratorParams = dataclasses.field(
        default_factory=OccupancyIntegratorParams)
    view: ViewCalculatorParams = dataclasses.field(
        default_factory=ViewCalculatorParams)
    esdf: EsdfIntegratorParams = dataclasses.field(
        default_factory=EsdfIntegratorParams)
    mesh: MeshIntegratorParams = dataclasses.field(
        default_factory=MeshIntegratorParams)
    tsdf_decay: TsdfDecayParams = dataclasses.field(
        default_factory=TsdfDecayParams)
    occupancy_decay: OccupancyDecayParams = dataclasses.field(
        default_factory=OccupancyDecayParams)


def projective_layer_type(mapping_type: MappingType) -> ProjectiveLayerType:
    """Which projective layer the static mapper keeps: occupancy in the
    two occupancy mapping types, a TSDF otherwise."""
    if mapping_type in (MappingType.STATIC_OCCUPANCY,
                        MappingType.HUMAN_WITH_STATIC_OCCUPANCY):
        return ProjectiveLayerType.OCCUPANCY
    return ProjectiveLayerType.TSDF


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
