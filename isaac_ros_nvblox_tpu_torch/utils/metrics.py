"""Reconstruction accuracy against an analytic scene SDF (port of
isaac_ros_nvblox_tpu/utils/metrics.py::mesh_accuracy).

Every synthetic scene (models/scene.py) has an exact signed distance
function, so the mesh can be scored against ground truth. The work stays
on the mapper's device: the full-map mesh is consumed chunk by chunk as
tensors and only a few scalars are read back.

  * mesh_surface_err_m: mean |scene.sdf(v)| over mesh vertices.
  * mesh_precision: fraction of vertices within `tau` of the surface.
  * mesh_completeness: fraction of true-surface samples (observed voxel
    centers with |sdf| < voxel / 2) with a mesh vertex in their voxel or a
    face neighbour's (the vertex-occupancy grid dilated by one voxel along
    each axis in turn).
  * mesh_fscore: harmonic mean of precision and completeness.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks


@torch.no_grad()
def mesh_accuracy(mapper, scene, tau_m: Optional[float] = None
                  ) -> Dict[str, float]:
    """Mesh accuracy of a DeviceMapper's map against the scene's SDF.

    Runs full-map marching cubes (the cold path), evaluates the scene SDF
    at every valid vertex and builds a voxel-resolution vertex-occupancy
    grid for the completeness test. The mapper's dirty and pending
    bookkeeping is restored afterwards (this is a diagnostic)."""
    vox = float(mapper.voxel_size_m)
    tau = float(tau_m) if tau_m is not None else 2.0 * vox
    dev = mapper.device
    dirty_save = mapper.dirty.clone()
    pending_save = mapper.mesh_pending.clone()

    origin, dims = mapper.esdf_region(margin_blocks=0, mult=1)
    origin_vox = torch.as_tensor([int(o) * 8 for o in origin],
                                 dtype=torch.int32, device=dev)
    dims_vox = [int(d) * 8 for d in dims]
    dims_t = torch.as_tensor(dims_vox, dtype=torch.int32, device=dev)

    def cells_in_grid(points):
        cell = torch.floor(points / vox).to(torch.int32) - origin_vox
        return cell, torch.all((cell >= 0) & (cell < dims_t), dim=-1)

    cover = torch.zeros(dims_vox, dtype=torch.bool, device=dev)
    err_sum = torch.zeros((), dtype=torch.float64, device=dev)
    n_verts = torch.zeros((), dtype=torch.int64, device=dev)
    n_prec = torch.zeros((), dtype=torch.int64, device=dev)
    for verts, _, valid, _ in mapper.update_mesh_device(chunk=1024):
        ok = valid.reshape(-1).repeat_interleave(3)
        vv = verts.reshape(-1, 3)[ok]                  # valid corners (m)
        d = torch.abs(scene.sdf(vv))
        err_sum += d.sum(dtype=torch.float64)
        n_verts += d.numel()
        n_prec += (d < tau).sum()
        cell, in_g = cells_in_grid(vv)
        cell = cell[in_g].long()
        cover[cell[:, 0], cell[:, 1], cell[:, 2]] = True
        del verts, valid

    # Dilate by one voxel per axis (proximity ~ tau).
    dil = cover
    for axis in range(3):
        dil = dil | torch.roll(dil, 1, axis) | torch.roll(dil, -1, axis)
    w = mapper.channels["tsdf_weight"]
    live = wg.live_slot_mask(mapper.state)
    centers = voxel_centers_for_blocks(mapper.state.block_index_of_slot, vox)
    gt = scene.sdf(centers.reshape(-1, 3)).reshape(w.shape)
    gt_surface = ((torch.abs(gt) < 0.5 * vox) & (w > 1e-6)
                  & live[:, None]).reshape(-1)
    cell, in_g = cells_in_grid(centers.reshape(-1, 3))
    safe = torch.minimum(torch.clamp_min(cell, 0), dims_t - 1).long()
    covered = dil[safe[:, 0], safe[:, 1], safe[:, 2]] & in_g
    n_surface = int(gt_surface.sum())
    n_covered = int((gt_surface & covered).sum())
    n_verts_i, n_prec_i = int(n_verts), int(n_prec)
    err = float(err_sum)

    mapper.dirty, mapper.mesh_pending = dirty_save, pending_save
    precision = n_prec_i / n_verts_i if n_verts_i else 0.0
    completeness = n_covered / n_surface if n_surface else 0.0
    fscore = (2 * precision * completeness / (precision + completeness)
              if precision + completeness > 0 else 0.0)
    return {
        "mesh_surface_err_m": err / n_verts_i if n_verts_i else float("nan"),
        "mesh_precision": precision,
        "mesh_completeness": completeness,
        "mesh_fscore": fscore,
        "mesh_vertices": n_verts_i,
        "gt_surface_samples": n_surface,
        "tau_m": tau,
    }
