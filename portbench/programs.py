"""Pieces that every program driver (`kinds/<kind>.py`) shares: the port's
world grid and camera from a configuration, and the program's outputs in
the form the comparison reads (live pool rows, block meshes in the
reference's form), and the numbers every kind compares.

The port is imported inside the functions; nothing of the JAX package is.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

COLOR = ["color_r", "color_g", "color_b", "color_weight"]


def world(config: Dict):
    from isaac_ros_nvblox_tpu_torch.core.world_grid import WorldGridConfig
    w = config["world"]
    return WorldGridConfig(dims=tuple(w["dims"]), capacity=int(w["capacity"]),
                           origin_block=tuple(w["origin_block"]))


def camera(config: Dict):
    from isaac_ros_nvblox_tpu_torch.models.camera import Camera
    c = config["camera"]
    return Camera(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                  float(c["cy"]), int(c["width"]), int(c["height"]))


def live_rows(mapper, channels: List[str]) -> Dict[str, np.ndarray]:
    """Block indices and the named channels' rows of the live slots."""
    from isaac_ros_nvblox_tpu_torch.core.world_grid import live_slot_mask
    slots = torch.nonzero(live_slot_mask(mapper.state)).squeeze(1)
    out = {"blocks": mapper.state.block_index_of_slot[slots].cpu().numpy()
           .astype(np.int64),
           "overflow": int(mapper.state.overflow_count)}
    for name in channels:
        out[name] = mapper.channels[name][slots].cpu().numpy()
    return out


def mesh_of(blocks: Dict, voxel_size_m: float) -> Dict:
    """A program's block meshes ({block: an object with `vertices` in
    metres, `colors` and `triangles`}) in the reference's form
    (reference/mesh.py): {block: ({vertex key: color}, {triangle})}."""
    from portbench.reference.mesh import program_block_mesh
    out = {}
    for key, b in blocks.items():
        out[tuple(int(x) for x in key)] = (
            ({}, set()) if b is None else program_block_mesh(
                b.vertices, b.colors, b.triangles, voxel_size_m))
    return out


def map_numbers(outputs: Dict, ref: Dict) -> Dict:
    """`tsdf_off_share`, `color_off_share` and, where the outputs hold a
    mesh, `mesh_off_share`: the program's whole mesh layer against the
    reference's meshes of every block with a cube to mesh."""
    from portbench import compare
    from portbench.reference import mesh as mesh_ref
    t, dmap = outputs["tsdf"], ref["map"]
    nums = {
        "tsdf_off_share": compare.share(compare.tsdf_off(
            t["blocks"], t["tsdf_distance"], t["tsdf_weight"], dmap)),
        "color_off_share": compare.share(compare.color_off(
            t["blocks"], np.stack([t[k] for k in COLOR], -1), dmap))}
    if "mesh" in outputs:
        nums["mesh_off_share"] = compare.share(
            mesh_ref.mesh_off(outputs["mesh"], ref["mesh"]))
    return nums


def dense_rows(ref: Dict, grids) -> Dict[str, np.ndarray]:
    """A reference map's observed blocks and the rows of the named dense
    grids there, in the form a program's `live_rows` take (the control's
    stand-in for a program)."""
    from portbench.compare import ref_rows
    dmap = ref["map"]
    X, Y, Z = dmap.dims
    per = (dmap.w > 0).view(X // 8, 8, Y // 8, 8, Z // 8, 8).any(5).any(3) \
        .any(1)
    blocks = torch.nonzero(per).cpu().numpy() + dmap.origin // 8
    out = {"blocks": blocks}
    for k, g in grids.items():
        r = ref_rows(g, dmap.origin, blocks)
        out[k] = (r if r.dtype == torch.bool else r.float()).cpu().numpy()
    return out


def map_grids(dmap) -> Dict:
    return {"tsdf_distance": dmap.d, "tsdf_weight": dmap.w,
            **{k: g for k, g in zip(COLOR, dmap.color)}}


def settle_mesh(update, mapper, limit: int = 256) -> int:
    """Runs the program's own mesh update (`update()`) until one re-meshes
    and clears nothing, so that work its budget deferred is done; returns
    the updates run. Nothing is integrated meanwhile."""
    for n in range(1, limit + 1):
        update()
        if not mapper.last_meshed_keys:
            return n
    return limit
