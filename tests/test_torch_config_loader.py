"""The port's layered YAML configuration against the reference (CPU): the
cases of tests/test_config_loader.py on the port, and `load_config` of the
same YAML layers giving the reference's node parameters and parameter
tree."""

import dataclasses
from pathlib import Path

import pytest

from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.runtime import config_loader as jcl
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.runtime import config_loader as tcl
from isaac_ros_nvblox_tpu_torch.runtime.config_loader import load_config

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "examples" / "config" / "nvblox"
SPEC = CFG / "specializations"


def test_base_config_loads():
    node, mapper = load_config([CFG / "nvblox_base.yaml"])
    assert node.tick_period_ms == 10.0
    assert node.update_esdf_rate_hz == 10.0
    assert mapper.voxel_size_m == 0.05
    assert mapper.mapping_type == tp.MappingType.STATIC_TSDF
    assert mapper.static_mapper.projective.max_integration_distance_m == 7.0


def test_specialization_overrides_base():
    node, mapper = load_config([CFG / "nvblox_base.yaml",
                                SPEC / "nvblox_dynamics.yaml"])
    assert mapper.mapping_type == tp.MappingType.DYNAMIC
    # Base values survive where not overridden.
    assert mapper.static_mapper.projective.max_integration_distance_m == 7.0
    assert mapper.dynamic_mapper.projective.max_integration_distance_m == 4.0


def test_segmentation_specialization():
    _, mapper = load_config([CFG / "nvblox_base.yaml",
                             SPEC / "nvblox_segmentation.yaml"])
    assert mapper.mapping_type == tp.MappingType.HUMAN_WITH_STATIC_TSDF
    assert mapper.static_mapper.connected_mask_component_size_threshold == 2000


# Layers written by the tests: node and mapper sections, later wins,
# dotted and nested keys, enum strings (one unknown), unknown keys.
USER_LAYERS = (
    """
node:
  global_frame: map
  integrate_depth_rate_hz: 30.0
  use_lidar: false
  layer_streamer_bandwidth_limit_mbps: 12.5
  not_a_node_param: 1
mapper:
  voxel_size_m: 0.04
  esdf_mode: 3d
  static_mapper:
    projective:
      weighting_mode: constant
      max_weight: 50.0
    view:
      workspace_bounds_type: height_bounds
""",
    """
node:
  integrate_depth_rate_hz: 15.0
  esdf_2d_max_height: 0.5
mapper:
  static_mapper.projective.max_weight: 80.0
  mapping_type: dynamic
  esdf_mode: 5d
  dynamic_mapper:
    occupancy:
      free_region_occupancy_probability: 0.35
  no_such_group:
    x: 1
""",
)


def _user_layers(tmp_path):
    paths = []
    for i, text in enumerate(USER_LAYERS):
        p = tmp_path / f"layer{i}.yaml"
        p.write_text(text)
        paths.append(p)
    return paths


@pytest.mark.parametrize("layers", [
    ["nvblox_base.yaml"],
    ["nvblox_base.yaml", "specializations/nvblox_dynamics.yaml"],
    ["nvblox_base.yaml", "specializations/nvblox_segmentation.yaml"],
    ["fuser.yaml"],
    ["user"],
    ["nvblox_base.yaml", "specializations/nvblox_dynamics.yaml", "user"],
])
def test_load_config_matches_reference(layers, tmp_path):
    """The same YAML layers give the reference's node parameters and
    parameter tree."""
    paths = []
    for name in layers:
        paths += _user_layers(tmp_path) if name == "user" else [CFG / name]
    t_node, t_mapper = tcl.load_config(paths)
    j_node, j_mapper = jcl.load_config(paths)
    assert tcl.load_yaml_layers(paths) == jcl.load_yaml_layers(paths)
    assert dataclasses.asdict(t_node) == dataclasses.asdict(j_node)
    assert tp.param_tree_string(t_mapper) == \
        jp.param_tree_string(j_mapper)


def test_user_layers_later_wins(tmp_path):
    node, mapper = load_config(_user_layers(tmp_path))
    assert node.global_frame == "map"
    assert node.integrate_depth_rate_hz == 15.0
    assert node.use_lidar is False
    assert node.esdf_2d_max_height == 0.5
    assert mapper.voxel_size_m == 0.04
    assert mapper.mapping_type == tp.MappingType.DYNAMIC
    # The merged "5d" replaced "3d" and is unknown: the default stands.
    assert mapper.esdf_mode == tp.EsdfMode.K2D
    assert mapper.static_mapper.projective.max_weight == 80.0
    assert mapper.static_mapper.projective.weighting_mode.value == "constant"
