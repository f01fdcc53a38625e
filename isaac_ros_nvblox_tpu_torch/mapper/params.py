"""Mapper parameters (port of isaac_ros_nvblox_tpu/mapper/params.py).

Holds the groups the depth -> TSDF -> ESDF path reads, with the reference's
field names and defaults. Later slices add the decay, freespace, mesh and
occupancy groups.
"""

from __future__ import annotations

import dataclasses

from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.view import ViewCalculatorParams


@dataclasses.dataclass
class MapperParams:
    """Per-mapper parameters of the TSDF + ESDF mapper."""
    projective: TsdfIntegratorParams = dataclasses.field(
        default_factory=TsdfIntegratorParams)
    view: ViewCalculatorParams = dataclasses.field(
        default_factory=ViewCalculatorParams)
    esdf: EsdfIntegratorParams = dataclasses.field(
        default_factory=EsdfIntegratorParams)
