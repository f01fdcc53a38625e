"""Multi-process set-up for the sharded mapper (port of
isaac_ros_nvblox_tpu/parallel/distributed.py).

Every process calls `initialize` (torch.distributed with a `tcp://`
rendezvous); `make_global_spatial_mesh` then spans all processes' shards,
each process holding a contiguous run, so the ESDF halo exchange crosses
processes only at their boundaries. The default backend is gloo (CPU
tensors; card tensors are staged through pinned host memory,
`spatial.SpatialMesh`); NCCL moves card tensors directly
(`backend="nccl"`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.core.types import resolve_device
from isaac_ros_nvblox_tpu_torch.parallel.spatial import SpatialMesh


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None) -> None:
    """Join the process group (call once per process, before any
    collective). `coordinator_address` is host:port of process 0."""
    import torch.distributed as dist
    addr = coordinator_address
    if "://" not in addr:
        addr = "tcp://" + addr
    dist.init_process_group(backend or "gloo", init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id))


def make_global_spatial_mesh(n_shards: Optional[int] = None,
                             device=None) -> SpatialMesh:
    """A 1-D "space" mesh over every process, each holding an equal,
    contiguous run of the shards. `n_shards` defaults to one shard per
    card of every process (one per process on the CPU). On the card,
    shard k of a process goes to local card k mod (cards on the host)."""
    import torch.distributed as dist
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device)
    per_host = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_shards is None:
        n_shards = world * per_host
    if n_shards % world:
        raise ValueError(f"{n_shards} shards do not split evenly over "
                         f"{world} processes")
    k = n_shards // world
    if dev.type == "cuda":
        devs = [torch.device("cuda", j % per_host) for j in range(k)]
    else:
        devs = [dev] * k
    return SpatialMesh([(r, devs[j]) for r in range(world)
                        for j in range(k)], rank=rank)


def put_sharded(tree, mesh: SpatialMesh):
    """A host-replicated, process-consistent pytree of arrays `[n_shards,
    ...]` (dicts, lists and tuples of them) -> the same tree with each
    array replaced by its local shards' rows, each on its shard's
    device."""
    if isinstance(tree, dict):
        return {k: put_sharded(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(put_sharded(v, mesh) for v in tree)
    a = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(
        np.asarray(tree))
    return [a[s].to(mesh.device_of(s)) for s in mesh.local_shards]


def _process_allgather(a: np.ndarray) -> np.ndarray:
    """`a` from every process, stacked on a leading process axis (a CPU
    gather over gloo; one process: `a[None]`)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return np.asarray(a)[None]
    t = torch.as_tensor(np.ascontiguousarray(a))
    if dist.get_backend() != "gloo":
        t = t.cuda()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def submap_payload(collection) -> dict:
    """A collection's local submaps as stacked host arrays: anchors,
    WorldGridState fields and TSDF channels."""
    states = [m.state.to_numpy() for m in collection.mappers]
    out = {"anchors": np.stack([np.asarray(T, np.float32)
                                for T in collection.T_W_S_est])}
    for k in states[0]:
        out["state/" + k] = np.stack([st[k] for st in states])
    for k in ("tsdf_distance", "tsdf_weight"):
        out[k] = np.stack([m.channels[k].cpu().numpy()
                           for m in collection.mappers])
    return out


def assemble_submaps(collection, payloads: List[dict]):
    """A global SubmapCollection from per-process payloads (process
    order), with each process's odometry chain rebuilt from its anchors
    (the between-factors `_spawn` made locally are a function of them), so
    the result optimizes as soon as cross-process loop closures are
    added."""
    from isaac_ros_nvblox_tpu_torch.mapper.submaps import (
        SubmapCollection, _odometry)
    out = SubmapCollection(collection.make_mapper, collection.params)
    for g in payloads:
        n_local = g["anchors"].shape[0]
        base = len(out.mappers)
        for s in range(n_local):
            m = collection.make_mapper()
            m.state = wg.WorldGridState.from_numpy(
                {k: g["state/" + k][s]
                 for k in wg.WorldGridState.__dataclass_fields__}, m.device)
            for k in ("tsdf_distance", "tsdf_weight"):
                m.channels[k].copy_(torch.as_tensor(g[k][s]))
            m._region_unknown = True
            out.mappers.append(m)
            anchor = np.asarray(g["anchors"][s], np.float32)
            out.T_W_S_est.append(anchor)
            out.T_W_S_opt.append(anchor.copy())
            out._first_cam.append(anchor.copy())
        for s in range(1, n_local):
            out.graph.add_between(
                base + s - 1, base + s,
                _odometry(g["anchors"][s - 1], g["anchors"][s]),
                weight=collection.params.odometry_weight)
    return out


def allgather_submaps(collection):
    """All-gather every process's submaps -> one global collection.

    Each process contributes its local submaps (fixed-size WorldGridState,
    TSDF channels, anchor poses); the gather moves them between processes
    and every process rebuilds the full SubmapCollection, ready for
    pose-graph optimization and fusion (mapper/submaps.py). All processes
    must hold the same number of submaps with the same world config."""
    local = submap_payload(collection)
    gathered = {k: _process_allgather(v) for k, v in local.items()}
    n_proc = gathered["anchors"].shape[0]
    return assemble_submaps(collection, [
        {k: v[p] for k, v in gathered.items()} for p in range(n_proc)])
