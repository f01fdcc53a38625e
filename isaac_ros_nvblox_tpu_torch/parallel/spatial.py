"""Multi-device spatial scale-out: the shard mesh and its collectives, and
the sharded frame step (port of isaac_ros_nvblox_tpu/parallel/spatial.py).

The reference runs `shard_map` over a JAX `Mesh` from one controller. Here
a `SpatialMesh` maps each shard index of a 1-D "space" axis to a
(process rank, torch.device) pair, so that one abstraction covers

  * n shards on the CPU in one process (the tests);
  * n shards on one card in one process;
  * shards spread over processes (`parallel/distributed.py`), each
    process holding a contiguous run of them.

Per-shard state is a list with one entry per local shard, each tensor on
its shard's device, in place of the reference's stacked `[n_shards, ...]`
arrays; a shard's step is a plain function of its own tensors, as the
reference's `local(...)` bodies are. The collectives are written once:

  * `ppermute(values, pairs)`: shard src's tensor goes to shard dst
    (`Tensor.to` between local shards; `torch.distributed` isend / irecv
    between processes); a shard no pair sends to receives zeros, as in
    `lax.ppermute`;
  * `psum(values)`: the sum over all shards, replicated to each local shard
    (a local sum, then an `all_reduce` when the mesh spans processes);
  * `all_gather(values)`: every shard's tensor, in shard order.

Across processes the gloo backend moves CPU tensors; card tensors are
staged through pinned host memory for it. NCCL would move card tensors
directly (`distributed.initialize(..., backend="nccl")`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.core.types import (VOXELS_PER_SIDE,
                                                   resolve_device)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda

B = VOXELS_PER_SIDE


class SpatialMesh:
    """A 1-D "space" mesh: shard s lives on `placements[s]` = (process
    rank, device). This process (`rank`) holds `local_shards`, in order."""

    def __init__(self, placements: Sequence[Tuple[int, object]],
                 rank: int = 0, group=None):
        self.placements = [(int(r), torch.device(d)) for r, d in placements]
        self.rank = int(rank)
        self.group = group
        self.local_shards = [s for s, (r, _) in enumerate(self.placements)
                             if r == self.rank]
        self._local_pos = {s: i for i, s in enumerate(self.local_shards)}
        self.multi_process = len({r for r, _ in self.placements}) > 1

    @property
    def n_shards(self) -> int:
        return len(self.placements)

    def device_of(self, shard: int) -> torch.device:
        return self.placements[shard][1]

    def rank_of(self, shard: int) -> int:
        return self.placements[shard][0]

    def is_local(self, shard: int) -> bool:
        return shard in self._local_pos

    @property
    def local_devices(self) -> List[torch.device]:
        return [self.device_of(s) for s in self.local_shards]

    # ----------------------------------------------------------- transport
    def _dist(self):
        import torch.distributed as dist
        return dist

    def _staged(self) -> bool:
        """Whether tensors cross processes through host memory (gloo)."""
        return self._dist().get_backend(self.group) == "gloo"

    def _to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as the backend moves it: card tensors copied into pinned
        host memory for gloo (the copy is waited for before the send)."""
        t = t.contiguous()
        if not self._staged() or t.device.type == "cpu":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        return host

    def _wire_buffer(self, like: torch.Tensor, device) -> torch.Tensor:
        if self._staged():
            return torch.empty(like.shape, dtype=like.dtype,
                               pin_memory=torch.device(device).type == "cuda")
        return torch.empty(like.shape, dtype=like.dtype, device=device)

    # ---------------------------------------------------------- collectives
    def ppermute(self, values: List[torch.Tensor],
                 pairs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
        """values: one tensor per local shard (same shape and dtype on
        every shard). Returns, per local shard, the tensor the pair
        (src, this shard) sent it, or zeros where no pair does."""
        out: List[Optional[torch.Tensor]] = [None] * len(values)
        sends, recvs = [], []
        for src, dst in pairs:
            if self.is_local(src) and self.is_local(dst):
                out[self._local_pos[dst]] = values[self._local_pos[src]].to(
                    self.device_of(dst), copy=True)
            elif self.is_local(src):
                sends.append((src, dst))
            elif self.is_local(dst):
                recvs.append((src, dst))
        if sends or recvs:
            dist = self._dist()
            n = self.n_shards
            works, bufs = [], []
            for src, dst in recvs:
                buf = self._wire_buffer(values[0], self.device_of(dst))
                works.append(dist.irecv(buf, src=self.rank_of(src),
                                        group=self.group, tag=src * n + dst))
                bufs.append((dst, buf))
            sent = [self._to_wire(values[self._local_pos[src]])
                    for src, _ in sends]
            for (src, dst), t in zip(sends, sent):
                works.append(dist.isend(t, dst=self.rank_of(dst),
                                        group=self.group, tag=src * n + dst))
            for w in works:
                w.wait()
            for dst, buf in bufs:
                out[self._local_pos[dst]] = buf.to(self.device_of(dst),
                                                   non_blocking=True)
        return [o if o is not None else torch.zeros_like(v)
                for o, v in zip(out, values)]

    def psum(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over all shards of `values` (one tensor per local
        shard), replicated to each local shard's device."""
        dev0 = self.device_of(self.local_shards[0])
        total = values[0].to(dev0)
        for v in values[1:]:
            total = total + v.to(dev0)
        if self.multi_process:
            wire = self._to_wire(total).clone()
            self._dist().all_reduce(wire, group=self.group)
            total = wire.to(dev0)
        return [total.to(self.device_of(s)) for s in self.local_shards]

    def all_gather(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's tensor (one per local shard given), in shard
        order, on this process's first local device. Across processes
        every process holds the same number of shards, contiguously."""
        dev0 = self.device_of(self.local_shards[0])
        local = torch.stack([v.to(dev0) for v in values])
        if not self.multi_process:
            return list(local.unbind(0))
        dist = self._dist()
        wire = self._to_wire(local)
        parts = [torch.empty_like(wire)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, wire, group=self.group)
        return [t.to(dev0) for p in parts for t in p.unbind(0)]

    def any_host(self, flag: bool) -> bool:
        """A host flag OR'd over the processes (the same on every rank)."""
        return self.sum_host(int(bool(flag))) > 0

    def sum_host(self, x) -> int:
        """A host integer summed over the processes."""
        if not self.multi_process:
            return int(x)
        t = torch.tensor([int(x)], dtype=torch.int64)
        if not self._staged():
            t = t.to(self.device_of(self.local_shards[0]))
        self._dist().all_reduce(t, group=self.group)
        return int(t.cpu()[0])


def make_spatial_mesh(n_devices: int, device=None) -> SpatialMesh:
    """n shards in this process, all on `device` (default: the card)."""
    dev = resolve_device(device)
    return SpatialMesh([(0, dev)] * int(n_devices))


@dataclasses.dataclass(frozen=True)
class ShardedMapConfig:
    voxel_size_m: float = 0.05
    capacity_per_shard: int = 512   # slots per shard
    blocks_per_frame: int = 256     # padded per-frame block batch per shard
    tile_blocks_x: int = 4          # spatial striping width (blocks)


def make_sharded_frame_step(mesh: SpatialMesh, camera: Camera,
                            config: ShardedMapConfig,
                            params: TsdfIntegratorParams):
    """The sharded frame step.

    Signature of the returned function, lists holding one entry per local
    shard:
      (distance [f32[cap, 512]], weight [...], esdf_sq [...],
       slots [i32[K]], block_indices [i32[K, 3]], depth [f32[H, W]],
       T_L_C [f32[4, 4]]) -> (distance, weight, esdf_sq, changed_total)

    Each shard fuses its own camera frame into its own slot batch (kernel
    tsdf_fuse), seeds the ESDF from the surface band, runs one local
    6-neighbour chamfer sweep, then sends its tiles' +x face to the next
    shard of the ring (`ppermute`) and min-combines what it receives into
    its -x face. `changed_total` is the `psum` of the changed voxel counts,
    replicated per shard. The pools are updated in place.
    """
    n = mesh.n_shards
    vs = config.voxel_size_m
    band = params.truncation_m(vs) * 0.5
    ring = [(i, (i + 1) % n) for i in range(n)]

    @torch.no_grad()
    def step(distance, weight, esdf_sq, slots, bidx, depth, T_L_C):
        grids, seeds = [], []
        for i in range(len(distance)):
            integrate_tsdf_cuda(distance[i], weight[i], slots[i], bidx[i],
                                depth[i], T_L_C[i], camera=camera,
                                voxel_size_m=vs, params=params)
            # ESDF seed: squared voxel distance 0 at surface-band voxels.
            is_site = (weight[i] > 1e-6) & (distance[i].abs() <= band)
            seed = torch.where(is_site, 0.0, 1e12)
            # One block-local relaxation sweep on the [cap, 8, 8, 8] view.
            g = seed.view(-1, B, B, B)
            for axis in (1, 2, 3):
                far = torch.full_like(g.narrow(axis, 0, 1), 1e12)
                plus = torch.cat([g.narrow(axis, 1, B - 1), far], axis)
                minus = torch.cat([far, g.narrow(axis, 0, B - 1)], axis)
                g = torch.minimum(g, torch.minimum(plus, minus) + 1.0)
            grids.append(g)
            seeds.append(seed)
        # Halo exchange: each shard's +x face to the next shard of the
        # ring, min-combined into the receiver's -x face.
        faces = mesh.ppermute([g[:, -1] for g in grids], ring)
        changed = []
        for i, (g, face) in enumerate(zip(grids, faces)):
            g = g.clone()
            g[:, 0] = torch.minimum(g[:, 0], face + 1.0)
            g = g.reshape(g.shape[0], -1)
            changed.append((g < seeds[i]).sum(dtype=torch.int32))
            esdf_sq[i].copy_(g)
        return distance, weight, esdf_sq, mesh.psum(changed)

    return step


def make_example_sharded_state(mesh: SpatialMesh, camera: Camera,
                               config: ShardedMapConfig):
    """A small sharded example state (per-local-shard lists) for the frame
    step and dry runs: each shard's batch is the first K slots of its pool,
    its blocks striped along x by shard."""
    cap = config.capacity_per_shard
    K = config.blocks_per_frame
    out = [[] for _ in range(7)]
    for s in mesh.local_shards:
        dev = mesh.device_of(s)
        k = np.arange(K)
        tb = config.tile_blocks_x
        bidx = np.stack([s * tb + k % tb, (k // tb) % 4, k // 16], -1)
        for lst, t in zip(out, (
                torch.zeros((cap, B ** 3), device=dev),
                torch.zeros((cap, B ** 3), device=dev),
                torch.full((cap, B ** 3), 1e12, device=dev),
                torch.arange(K, dtype=torch.int32, device=dev),
                torch.as_tensor(bidx.astype(np.int32), device=dev),
                torch.full((camera.height, camera.width), 2.0, device=dev),
                torch.eye(4, device=dev))):
            lst.append(t)
    return tuple(out)
