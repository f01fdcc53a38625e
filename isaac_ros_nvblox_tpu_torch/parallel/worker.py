"""One process of a multi-process sharded mapping run (the counterpart of
the reference's tools/distributed_worker.py).

    python -m isaac_ros_nvblox_tpu_torch.parallel.worker COORDINATOR \\
        N_PROCESSES PROCESS_ID [--shards 8] [--device cpu|cuda] \\
        [--regions R]

COORDINATOR is host:port of process 0 (gloo over tcp). The global "space"
mesh holds `--shards` shards, each process a contiguous equal run of
them. The sharded mapper integrates two frames and runs the exact sharded
ESDF; every process prints a checksum of the whole map, the same on every
process and for any split of the same shards (`resolved=`). Then each
process maps its own region into two submaps, the submaps are all-gathered
(`distributed.allgather_submaps`), a loop closure joins the first two
processes' runs, and every process optimizes and fuses the same global map
(`fused=`). With one process, `--regions R` maps the R regions in turn and
assembles them as the gather would, so that its `fused=` equals an
R-process run's. Prints `WORKER{pid} resolved=... w=...`,
`WORKER{pid} submaps=... fused=...` and `WORKER{pid} OK`.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("coordinator")
    ap.add_argument("n_processes", type=int)
    ap.add_argument("process_id", type=int)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--regions", type=int, default=0)
    args = ap.parse_args(argv)
    pid, n_proc = args.process_id, args.n_processes
    torch.set_num_threads(1)

    from isaac_ros_nvblox_tpu_torch.core.world_grid import WorldGridConfig
    from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
    from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
    from isaac_ros_nvblox_tpu_torch.mapper.submaps import (SubmapCollection,
                                                           SubmapParams)
    from isaac_ros_nvblox_tpu_torch.models.camera import Camera
    from isaac_ros_nvblox_tpu_torch.models.scene import (Scene, Sphere,
                                                         orbit_pose,
                                                         render_depth)
    from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
    from isaac_ros_nvblox_tpu_torch.parallel import distributed as dist
    from isaac_ros_nvblox_tpu_torch.parallel.sharded_mapper import (
        ShardedDeviceMapper, ShardedMapperConfig)

    if n_proc > 1:
        dist.initialize(args.coordinator, n_proc, pid)
    mesh = dist.make_global_spatial_mesh(args.shards, device=args.device)
    dev = mesh.device_of(mesh.local_shards[0])
    cam = Camera(fx=60.0, fy=60.0, cx=29.5, cy=22.5, width=60, height=45)
    cfg = ShardedMapperConfig(
        n_shards=args.shards, global_dims=(32, 16, 8),
        origin_block=(-16, -8, -2), capacity_per_shard=256,
        voxel_size_m=0.1, max_blocks_per_frame=256)
    params = MapperParams(esdf=EsdfIntegratorParams(max_esdf_distance_m=0.8))
    mapper = ShardedDeviceMapper(mesh, cam, cfg, params)

    scene = Scene(primitives=(Sphere(center=(0.2, 0.0, 0.4), radius=0.35),))
    for k in range(2):
        T = orbit_pose(2 * np.pi * k / 8, radius=1.2, height=0.4,
                       target=(0, 0, 0.4))
        mapper.integrate_depth(render_depth(scene, cam, T, device=dev), T)
    mapper.update_esdf()

    # Whole-map checksums: every process evaluates the same numbers.
    resolved = mesh.sum_host(sum(
        int((sq < 1e11).sum()) for sq in mapper.channels["esdf_sq_dist"]))
    total_w = float(mesh.psum([w.sum() for w in
                               mapper.channels["tsdf_weight"]])[0])
    print(f"WORKER{pid} resolved={resolved} w={total_w:.3f}", flush=True)
    assert resolved > 1000, resolved
    assert total_w > 0

    # ---- cross-process pose-graph submap fusion --------------------------
    def make_mapper():
        return DeviceMapper(
            voxel_size_m=0.1,
            world=WorldGridConfig(dims=(16, 16, 8), capacity=1024,
                                  origin_block=(-8, -8, -2)),
            enable_color=False, max_blocks_per_frame=512, device=dev)

    def map_region(p):
        coll = SubmapCollection(make_mapper, SubmapParams(
            max_translation_m=1.0, max_rotation_rad=2.0))
        target = (0.6 * p, 0.0, 0.4)   # process-specific region
        local_scene = Scene(primitives=(Sphere(center=target, radius=0.35),))
        for k in (0, 1, 4, 5):         # two far-apart frame pairs: 2 submaps
            T = orbit_pose(2 * np.pi * k / 8, radius=1.2, height=0.4,
                           target=target)
            coll.integrate_depth(render_depth(local_scene, cam, T,
                                              device=dev), T, cam)
        assert coll.num_submaps == 2, coll.num_submaps
        return coll

    if n_proc > 1:
        gathered = dist.allgather_submaps(map_region(pid))
    else:
        colls = [map_region(p) for p in range(max(args.regions, 1))]
        gathered = dist.assemble_submaps(
            colls[0], [dist.submap_payload(c) for c in colls])
    n_sub = gathered.num_submaps
    assert n_sub == 2 * max(n_proc, args.regions, 1), n_sub
    # A closure joining the first two runs, a function of the gathered
    # anchors: every process adds the same factor, so the optimized graph
    # and the fused map are the same everywhere.
    j = 2 if n_sub > 2 else 1
    T_0_j = np.linalg.inv(np.asarray(gathered.T_W_S_est[0], np.float64)) \
        @ np.asarray(gathered.T_W_S_est[j], np.float64)
    gathered.add_loop_closure(0, j, T_0_j.astype(np.float32), weight=10.0)
    gathered.optimize(iters=5)
    fused = gathered.fuse()
    fn = fused.block_count()
    fw = float(fused.channels["tsdf_weight"].double().sum())
    print(f"WORKER{pid} submaps={n_sub} fused=n{fn}_w{fw:.3f}", flush=True)
    assert fn > 0 and fw > 0
    print(f"WORKER{pid} OK", flush=True)
    if n_proc > 1:
        import torch.distributed as tdist
        tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
