"""Multi-shard dry run: one step of every sharded path on tiny shapes
(the counterpart of the reference's `__graft_entry__.dryrun_multichip`).

    python -m isaac_ros_nvblox_tpu_torch.parallel.dryrun [N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.parallel.sharded_mapper import (
    ShardedDeviceMapper, ShardedMapperConfig)
from isaac_ros_nvblox_tpu_torch.parallel.spatial import make_spatial_mesh


def dryrun_multichip(n_devices: int, device=None) -> ShardedDeviceMapper:
    """Run the sharded mapping step once over an n-shard mesh on `device`
    (default: the card): sharded pools, TSDF + color integration of a
    broadcast frame, occupancy, the cross-shard exact-ESDF halo exchange
    (twice: the second update is skipped), decay, dirty-block meshing,
    the dynamic tick, lidar, routed frames and the 2-D slice."""
    mesh = make_spatial_mesh(n_devices, device=device)
    dev = mesh.device_of(0)
    camera = Camera(fx=40.0, fy=40.0, cx=19.5, cy=14.5, width=40, height=30)
    # A 2-D (x, y) tile grid when the shard count factors, else x-slabs.
    ny = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    nx = n_devices // ny
    cfg = ShardedMapperConfig(
        n_shards=n_devices, shard_grid=(nx, ny),
        global_dims=(2 * nx, 8 * ny, 8),
        origin_block=(-nx, -4 * ny, -2), capacity_per_shard=128,
        voxel_size_m=0.05, max_blocks_per_frame=64, mesh_max_blocks=64,
        enable_color=True, enable_occupancy=True, enable_freespace=True)
    params = MapperParams(esdf=EsdfIntegratorParams(max_esdf_distance_m=0.8))
    mapper = ShardedDeviceMapper(mesh, camera, cfg, params)

    depth = torch.full((camera.height, camera.width), 1.5, device=dev)
    color = torch.full((camera.height, camera.width, 3), 128.0, device=dev)
    T = torch.eye(4, device=dev)
    mapper.integrate_depth(depth, T)      # a device pose: every shard runs
    mapper.integrate_color(color, depth, T)
    mapper.integrate_depth_occupancy(depth, T)
    mapper.update_esdf()                   # two-step halo + dense EDT
    mapper.update_esdf()                   # nothing changed: skipped
    mapper.decay()                         # decay + slot recycling
    out = mapper.update_mesh_dirty()
    # The dynamic tick: freespace -> psum-OR'd detection -> masked split.
    mask = mapper.dynamic_tick(depth, np.eye(4, dtype=np.float32),
                               time_ms=500.0)
    lidar = Lidar.equal_vertical_fov(32, 8, np.deg2rad(20.0),
                                     min_range_m=0.3, max_range_m=3.0)
    rimg = torch.full((lidar.num_elevation_divisions,
                       lidar.num_azimuth_divisions), 1.2, device=dev)
    mapper.integrate_lidar(rimg, np.eye(4, dtype=np.float32), lidar)
    # Routed ingestion: one frame per shard, around the ring.
    mapper.integrate_frames_routed(
        np.full((n_devices, camera.height, camera.width), 1.4, np.float32),
        np.stack([np.eye(4, dtype=np.float32)] * n_devices))
    grid2d = mapper.slice_esdf_2d(height_m=0.5)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    assert grid2d.shape == (cfg.global_dims[0] * 8, cfg.global_dims[1] * 8)
    assert len(out) == n_devices and mask.shape == depth.shape
    assert mapper.total_owned_blocks() > 0
    return mapper


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    m = dryrun_multichip(args.n, device=args.device)
    print(f"dryrun ok: {args.n} shards, {m.total_owned_blocks()} owned "
          "blocks")
