"""Layered YAML configuration loading.

Reference: the bringup launch files merge nvblox_base.yaml + a mode
specialization + a camera specialization, later-wins
(nvblox_examples_bringup/launch/perception/nvblox.launch.py:113-179).

Here (port of isaac_ros_nvblox_tpu/runtime/config_loader.py):
`load_config([paths...])` deep-merges the YAML layers in order and returns
(NodeParams, MultiMapperParams) built through the same tolerant overlay
machinery as mapper/params.py (unknown keys warn, enum strings parse with
warn-and-default).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Mapping, Tuple

from isaac_ros_nvblox_tpu_torch.mapper.params import (MultiMapperParams,
                                                      apply_overlay,
                                                      make_params)
from isaac_ros_nvblox_tpu_torch.runtime.node import NodeParams


def _deep_merge(base: dict, overlay: Mapping) -> dict:
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml_layers(paths: Iterable) -> dict:
    """Merge YAML files in order (later wins)."""
    import yaml
    merged: dict = {}
    for p in paths:
        data = yaml.safe_load(Path(p).read_text()) or {}
        merged = _deep_merge(merged, data)
    return merged


def config_from_dict(cfg: Mapping) -> Tuple[NodeParams, MultiMapperParams]:
    """Build parameter objects from a merged config dict.

    Recognized top-level keys: `node` (NodeParams fields), `mapper`
    (MultiMapperParams overlay). Unknown keys inside each section warn and
    are ignored (parity with the reference's tolerant param parsing).
    """
    node_params = NodeParams()
    if "node" in cfg:
        node_params = apply_overlay(node_params, cfg["node"])
    mapper_params = make_params(overlay=cfg.get("mapper"))
    return node_params, mapper_params


def load_config(paths: Iterable) -> Tuple[NodeParams, MultiMapperParams]:
    return config_from_dict(load_yaml_layers(paths))
