"""Map (layer-cake) serialization of the host-table Mapper (port of
isaac_ros_nvblox_tpu/io/serialization.py).

Reference: `Mapper::saveLayerCake` / `loadMap` writing the `.nvblx` format
(call-sites nvblox_node.cpp:1668,1703 in the save_map/load_map services).

Format (`.nvblx.npz`, format 1, the reference's): a compressed npz with the
allocated blocks' indices, every voxel channel compacted to
`[n_allocated, ...]` (`channel__<name>`) and a JSON header (`meta_json`:
format version, voxel size, projective layer, channel specs with numpy
dtype names). A map saved by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

FORMAT_VERSION = 1


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def save_map(mapper, path) -> None:
    """Serialize a Mapper's layers (all channels + block table) to npz, at
    exactly `path`."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    table = mapper.table
    slots = table.allocated_slots()
    s = torch.as_tensor(slots.astype(np.int64), device=mapper.pool.device)
    payload = {"block_indices": table.block_indices[slots]}
    specs = {}
    for name, arr in mapper.pool.channels.items():
        payload[f"channel__{name}"] = arr[s].cpu().numpy()
        trailing, dtype = mapper.pool.channel_specs[name]
        specs[name] = {"trailing": list(trailing),
                       "dtype": _dtype_name(dtype)}
    meta = {
        "format_version": FORMAT_VERSION,
        "voxel_size_m": mapper.voxel_size_m,
        "projective_layer": mapper.projective_layer.value,
        "channel_specs": specs,
    }
    payload["meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    # A file handle: np.savez_compressed(path) appends ".npz" to other
    # suffixes, which would break .nvblx round trips.
    with open(path, "wb") as f:
        np.savez_compressed(f, **payload)


def load_map(mapper, path) -> int:
    """Load a saved map into an existing (compatible) Mapper, replacing its
    contents. Returns the number of blocks loaded. Raises ValueError on a
    voxel-size or channel mismatch."""
    path = Path(path)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta_json"].tobytes()).decode("utf-8"))
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported map format {meta['format_version']}")
        if abs(meta["voxel_size_m"] - mapper.voxel_size_m) > 1e-9:
            raise ValueError(
                f"voxel size mismatch: map {meta['voxel_size_m']} vs mapper "
                f"{mapper.voxel_size_m}")
        missing = set(meta["channel_specs"]) - set(mapper.pool.channels)
        if missing:
            raise ValueError(f"mapper lacks channels {sorted(missing)}")
        block_indices = data["block_indices"]
        channels = {name: data[f"channel__{name}"]
                    for name in meta["channel_specs"]}

    # Clear the current map.
    old = mapper.table.allocated_block_indices()
    if old.size:
        slots_old = mapper.table.allocated_slots()
        mapper.table.free([tuple(k) for k in old.tolist()])
        mapper.pool.reset_slots(slots_old)
    mapper.mesh_layer.blocks.clear()
    mapper._mesh_dirty.clear()

    mapper.pool.ensure_capacity(needed_free=len(block_indices))
    slots, _ = mapper.table.allocate(block_indices)
    s = torch.as_tensor(slots.astype(np.int64), device=mapper.pool.device)
    for name, values in channels.items():
        ch = mapper.pool[name]
        ch[s] = torch.as_tensor(values, dtype=ch.dtype, device=ch.device)
    mapper._mark_mesh_dirty(slots)
    return int(len(block_indices))
