"""Mapper parameters (port of isaac_ros_nvblox_tpu/mapper/params.py).

Holds the groups the TSDF, occupancy, colored-mesh, ESDF, decay and
freespace paths read, the depth and mask preprocessing switches, the
MultiMapper's top-level parameters and the mapping-type enums, with the
reference's field names and defaults.

The tree is built in three tiers, as nvblox's launch files build it:
defaults in code (the dataclass defaults), a mode overlay
(`MODE_OVERLAYS`: static / dynamic / people segmentation) and a user
overlay, applied last (`make_params`). `apply_overlay` takes nested or
dotted keys, later wins; unknown keys warn and are ignored, enum strings
parse with warn-and-default.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Dict, Mapping, Optional

from isaac_ros_nvblox_tpu_torch.ops.decay import (OccupancyDecayParams,
                                                  TsdfDecayParams)
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.freespace import FreespaceIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.mesh import MeshIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.occupancy import OccupancyIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                 WeightingFunctionType)
from isaac_ros_nvblox_tpu_torch.ops.view import (ViewCalculatorParams,
                                                 WorkspaceBoundsType)

log = logging.getLogger(__name__)


class MappingType(enum.Enum):
    """nvblox's MappingType names."""
    STATIC_TSDF = "static_tsdf"
    STATIC_OCCUPANCY = "static_occupancy"
    DYNAMIC = "dynamic"
    HUMAN_WITH_STATIC_TSDF = "human_with_static_tsdf"
    HUMAN_WITH_STATIC_OCCUPANCY = "human_with_static_occupancy"


class EsdfMode(enum.Enum):
    """nvblox's EsdfMode: a 2-D slice or the full 3-D field."""
    K2D = "2d"
    K3D = "3d"


class ProjectiveLayerType(enum.Enum):
    TSDF = "tsdf"
    OCCUPANCY = "occupancy"


@dataclasses.dataclass
class EsdfSliceParams:
    """Slice heights (nvblox's esdf_slice_* parameters)."""
    esdf_slice_min_height: float = 0.1
    esdf_slice_max_height: float = 0.3
    esdf_slice_height: float = 0.3
    slice_height_above_plane_m: float = 0.1
    slice_height_thickness_m: float = 0.2


@dataclasses.dataclass
class MapperParams:
    """Per-mapper parameters (the static_mapper / dynamic_mapper groups)."""
    projective: TsdfIntegratorParams = dataclasses.field(
        default_factory=TsdfIntegratorParams)
    occupancy: OccupancyIntegratorParams = dataclasses.field(
        default_factory=OccupancyIntegratorParams)
    view: ViewCalculatorParams = dataclasses.field(
        default_factory=ViewCalculatorParams)
    esdf: EsdfIntegratorParams = dataclasses.field(
        default_factory=EsdfIntegratorParams)
    esdf_slice: EsdfSliceParams = dataclasses.field(
        default_factory=EsdfSliceParams)
    mesh: MeshIntegratorParams = dataclasses.field(
        default_factory=MeshIntegratorParams)
    tsdf_decay: TsdfDecayParams = dataclasses.field(
        default_factory=TsdfDecayParams)
    occupancy_decay: OccupancyDecayParams = dataclasses.field(
        default_factory=OccupancyDecayParams)
    freespace: FreespaceIntegratorParams = dataclasses.field(
        default_factory=FreespaceIntegratorParams)
    # Depth preprocessing: grow invalid regions by this many dilations.
    do_depth_preprocessing: bool = False
    depth_preprocessing_num_dilations: int = 3
    # Mask preprocessing: drop mask components below the size threshold.
    remove_small_connected_components: bool = True
    connected_mask_component_size_threshold: int = 2000


@dataclasses.dataclass
class MultiMapperParams:
    """Top-level mapping configuration (the multi_mapper group)."""
    voxel_size_m: float = 0.05
    mapping_type: MappingType = MappingType.STATIC_TSDF
    esdf_mode: EsdfMode = EsdfMode.K2D
    block_capacity: int = 16384
    static_mapper: MapperParams = dataclasses.field(
        default_factory=MapperParams)
    # Dynamic-detection pixel stride: s > 1 evaluates every s-th pixel of
    # every s-th row and repeats the result over s x s tiles.
    dynamic_detection_subsample: int = 1
    dynamic_mapper: MapperParams = dataclasses.field(
        default_factory=lambda: MapperParams(
            projective=TsdfIntegratorParams(max_integration_distance_m=4.0)))
    # Per-frame block budget of the foreground occupancy mapper (dynamic
    # objects cover a small masked footprint).
    dynamic_max_blocks_per_frame: int = 512
    # Per-frame view-batch budget of the background (static) mapper.
    max_blocks_per_frame: int = 2048


# ---------------------------------------------------------------- overlays
MODE_OVERLAYS: Dict[str, Dict[str, Any]] = {
    # Parity with config/nvblox/specializations: dynamics + segmentation.
    "static": {"mapping_type": "static_tsdf"},
    "static_occupancy": {"mapping_type": "static_occupancy"},
    "dynamic": {"mapping_type": "dynamic"},
    "people_segmentation": {"mapping_type": "human_with_static_tsdf"},
}

_ENUM_FIELDS = {
    "mapping_type": MappingType,
    "esdf_mode": EsdfMode,
    "weighting_mode": WeightingFunctionType,
    "workspace_bounds_type": WorkspaceBoundsType,
}


def _parse_enum(cls, value, default):
    if isinstance(value, cls):
        return value
    try:
        return cls(value)
    except ValueError:
        log.warning("Unknown %s value %r; using default %r",
                    cls.__name__, value, default)
        return default


def apply_overlay(params: Any, overlay: Mapping[str, Any]) -> Any:
    """Apply a nested/dotted dict overlay to a (possibly frozen) dataclass
    tree, returning a new tree. Unknown keys warn and are ignored."""
    updates: Dict[str, Any] = {}
    for key, value in overlay.items():
        head, _, rest = key.partition(".")
        if not hasattr(params, head):
            log.warning("Unknown parameter %r (on %s); ignored",
                        key, type(params).__name__)
            continue
        # Merge successive overlays touching the same subtree (dotted and
        # nested forms may both address one field).
        current = updates.get(head, getattr(params, head))
        if rest:
            updates[head] = apply_overlay(current, {rest: value})
        elif dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[head] = apply_overlay(current, value)
        elif head in _ENUM_FIELDS:
            updates[head] = _parse_enum(_ENUM_FIELDS[head], value, current)
        else:
            updates[head] = value
    return dataclasses.replace(params, **updates)


def make_params(mode: Optional[str] = None,
                overlay: Optional[Mapping[str, Any]] = None
                ) -> MultiMapperParams:
    """Build the parameter tree: defaults + mode overlay + user overlay."""
    params = MultiMapperParams()
    if mode is not None:
        mode_overlay = MODE_OVERLAYS.get(mode)
        if mode_overlay is None:
            log.warning("Unknown mode %r; using defaults", mode)
        else:
            params = apply_overlay(params, mode_overlay)
    if overlay:
        params = apply_overlay(params, overlay)
    return params


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


def param_tree_string(params: Any, indent: int = 0) -> str:
    """Pretty-print the parameter tree (parity:
    parameters::parameterTreeToString, nvblox_node.cpp:119-124)."""
    lines = []
    pad = "  " * indent
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            lines.append(f"{pad}{f.name}:")
            lines.append(param_tree_string(v, indent + 1))
        else:
            v_str = v.value if isinstance(v, enum.Enum) else v
            lines.append(f"{pad}{f.name}: {v_str}")
    return "\n".join(lines)
