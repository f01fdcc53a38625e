"""The port's ShardedDeviceMapper against the port's single-device
DeviceMapper: the cases of the reference's tests/test_sharded_mapper.py,
rerun on an 8-shard mesh in one process on the CPU (plain versions of the
kernels). The cross-check against the reference's sharded mapper is in
test_torch_sharded_reference.py."""

import dataclasses

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.scene import (Scene, Sphere,
                                                     orbit_pose, render_color,
                                                     render_depth)
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.parallel.sharded_mapper import (
    ShardedDeviceMapper, ShardedMapperConfig)
from isaac_ros_nvblox_tpu_torch.parallel.spatial import (SpatialMesh,
                                                     make_spatial_mesh)

torch.set_num_threads(2)

VOXEL = 0.05
CAM = Camera(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
CFG = ShardedMapperConfig(
    n_shards=8, global_dims=(64, 32, 16), origin_block=(-32, -16, -4),
    capacity_per_shard=1024, voxel_size_m=VOXEL, max_blocks_per_frame=1024)
BAND_1M = MapperParams(esdf=EsdfIntegratorParams(max_esdf_distance_m=1.0))


def sharded(cfg=CFG, params=None, **kw):
    return ShardedDeviceMapper(make_spatial_mesh(cfg.n_shards, device="cpu"),
                               CAM, dataclasses.replace(cfg, **kw), params)


def single(cfg=CFG, params=None, **kw):
    return DeviceMapper(
        voxel_size_m=VOXEL, params=params,
        world=wg.WorldGridConfig(dims=cfg.global_dims, capacity=8192,
                                 origin_block=cfg.origin_block),
        max_blocks_per_frame=4096, device="cpu", **kw)


def frames(scene, n=2):
    out = []
    for k in range(n):
        T = orbit_pose(2 * np.pi * k / 8, radius=2.0, height=1.0,
                       target=(0, 0, 1.0))
        out.append((render_depth(scene, CAM, T, device="cpu"), T))
    return out


def owned_rows(m, names, shards=None):
    """{block key: (row of each channel in `names`)} over the owned live
    blocks of every shard."""
    out = {}
    for s in range(m.config.n_shards) if shards is None else shards:
        mask = m.owned_block_mask(s)
        count = int(m.state[s].alloc_count)
        bidx = m.state[s].block_index_of_slot[:count].numpy()[mask]
        rows = [m.channels[k][s][:count].numpy()[mask] for k in names]
        for i, b in enumerate(bidx.tolist()):
            out[tuple(b)] = tuple(r[i] for r in rows)
    return out


def single_row(m, key, name):
    o = np.asarray(m.world_config.origin_block)
    c = np.asarray(key) - o
    slot = int(m.state.slot_grid[c[0], c[1], c[2]])
    assert slot >= 0, key
    return m.channels[name][slot].numpy()


def test_sharded_matches_single_device_tsdf():
    """Owned blocks of the sharded map hold the single device's TSDF and
    weights within 1e-5 (the same kernel math per voxel)."""
    scene = Scene(primitives=(Sphere(center=(0.0, 0.0, 1.0), radius=0.6),))
    sh, one = sharded(), single()
    for depth, T in frames(scene):
        sh.integrate_depth(depth, T)
        one.integrate_depth(depth, T, CAM)
    assert sh.total_owned_blocks() == one.block_count()
    rows = owned_rows(sh, ("tsdf_distance", "tsdf_weight"))
    assert len(rows) > 50
    for key, (d, w) in rows.items():
        np.testing.assert_allclose(d, single_row(one, key, "tsdf_distance"),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(w, single_row(one, key, "tsdf_weight"),
                                   rtol=0, atol=1e-5)


def test_sharded_esdf_crosses_boundaries():
    """The x-slab halo exchange: every owned block's squared ESDF equals
    the single device's bit for bit, across slab boundaries."""
    scene = Scene(primitives=(Sphere(center=(0.3, 0.0, 1.0), radius=0.5),))
    sh, one = sharded(params=BAND_1M), single(params=BAND_1M)
    for depth, T in frames(scene):
        sh.integrate_depth(depth, T)
        one.integrate_depth(depth, T, CAM)
    sh.update_esdf()
    one.update_esdf()
    rows = owned_rows(sh, ("esdf_sq_dist",))
    for key, (sq,) in rows.items():
        np.testing.assert_array_equal(sq, single_row(one, key, "esdf_sq_dist"),
                                      err_msg=str(key))
    assert len(rows) * 512 > 50000
    # The exchange crossed real boundaries: blocks beside a slab edge.
    Lx = CFG.tile_dims[0]
    assert any((k[0] - CFG.origin_block[0]) % Lx in (0, Lx - 1)
               for k in rows)


def test_sharded_mesh_and_color_match_single_device():
    """Sharded meshing over dirty owned blocks with per-vertex color gives
    the single device's mesh block for block (the same marching-cubes
    kernel: vertices within 1e-5 m, equal triangle counts)."""
    from isaac_ros_nvblox_tpu_torch.mapper import device_io
    scene = Scene(primitives=(Sphere(center=(0.1, 0.0, 1.0), radius=0.55),))
    sh = sharded(enable_color=True, mesh_max_blocks=512)
    one = single()
    for k in range(2):
        T = orbit_pose(2 * np.pi * k / 8, radius=2.0, height=1.0,
                       target=(0, 0, 1.0))
        depth = render_depth(scene, CAM, T, device="cpu")
        color = render_color(scene, CAM, T, device="cpu")
        sh.integrate_depth(depth, T)
        sh.integrate_color(color, depth, T)
        one.integrate_depth(depth, T, CAM)
        one.integrate_color(color, T, CAM, depth=depth)
    blocks = sh.export_mesh_blocks()
    assert len(blocks) > 50
    device_io.update_mesh_layer(one)

    def order(v):
        c = v.mean(axis=1)
        return np.lexsort((c[:, 2], c[:, 1], c[:, 0]))

    n_matched = 0
    for key, (v_sh, c_sh) in blocks.items():
        if v_sh.shape[0] == 0:
            continue
        mb = one.mesh_layer.blocks.get(key)
        assert mb is not None, key
        v_one = mb.vertices[mb.triangles.reshape(-1)].reshape(-1, 3, 3)
        c_one = mb.colors[mb.triangles.reshape(-1)].reshape(-1, 3, 3)
        assert v_one.shape == v_sh.shape, key
        np.testing.assert_allclose(v_sh[order(v_sh)], v_one[order(v_one)],
                                   rtol=0, atol=1e-5)
        # The layer keeps colors as u8: within one unit of the soup's.
        np.testing.assert_allclose(c_sh[order(v_sh)], c_one[order(v_one)],
                                   rtol=0, atol=1.0)
        n_matched += 1
    assert n_matched > 15
    assert max(float(c.max()) if c.size else 0.0
               for _, c in blocks.values()) > 10.0


def test_sharded_non_divisible_dims_raises():
    with pytest.raises(ValueError):
        ShardedMapperConfig(n_shards=8, global_dims=(60, 32, 16)).slab_width
    with pytest.raises(ValueError):
        ShardedMapperConfig(n_shards=8, shard_grid=(3, 2)).grid


def test_shard_overflow_counted():
    """A shard whose pool fills up counts overflow per shard instead of
    corrupting; the ESDF still runs on the truncated map."""
    scene = Scene(primitives=(Sphere(center=(0.0, 0.0, 1.0), radius=0.6),))
    sh = sharded(params=BAND_1M, capacity_per_shard=16,
                 max_blocks_per_frame=256)
    for depth, T in frames(scene):
        sh.integrate_depth(depth, T)
    alloc = np.array([int(st.alloc_count) for st in sh.state])
    overflow = np.array([int(st.overflow_count) for st in sh.state])
    assert (alloc <= 16).all()
    assert overflow.sum() > 0
    assert ((overflow > 0) == (alloc == 16)).all()
    sh.update_esdf()
    for sq in sh.channels["esdf_sq_dist"]:
        assert torch.isfinite(sq).all()


def test_sharded_2d_grid_matches_single_device():
    """The 2-D (x, y) tile grid: TSDF and cross-tile ESDF bit for bit
    equal to the single device's, across y boundaries and at the tile
    corners (the y-then-x exchange)."""
    scene = Scene(primitives=(Sphere(center=(0.3, 0.2, 1.0), radius=0.5),))
    cfg = dataclasses.replace(CFG, shard_grid=(4, 2), global_dims=(32, 32, 16),
                              origin_block=(-16, -16, -4))
    sh, one = sharded(cfg, BAND_1M), single(cfg, BAND_1M)
    for depth, T in frames(scene):
        sh.integrate_depth(depth, T)
        one.integrate_depth(depth, T, CAM)
    assert sh.total_owned_blocks() == one.block_count()
    sh.update_esdf()
    one.update_esdf()
    rows = owned_rows(sh, ("esdf_sq_dist", "tsdf_distance"))
    Lx, Ly = cfg.tile_dims
    corners = 0
    for key, (sq, d) in rows.items():
        np.testing.assert_array_equal(sq, single_row(one, key, "esdf_sq_dist"),
                                      err_msg=str(key))
        np.testing.assert_allclose(d, single_row(one, key, "tsdf_distance"),
                                   rtol=0, atol=1e-5)
        lx = (key[0] - cfg.origin_block[0]) % Lx
        ly = (key[1] - cfg.origin_block[1]) % Ly
        corners += lx in (0, Lx - 1) and ly in (0, Ly - 1)
    assert len(rows) * 512 > 20000
    assert corners > 0


def test_sharded_esdf_incremental_skip():
    """A clean map skips the sharded solve: the stored field, deliberately
    corrupted, is not recomputed until a block becomes dirty again."""
    scene = Scene(primitives=(Sphere(center=(0.0, 0.0, 1.0), radius=0.6),))
    sh = sharded(params=BAND_1M)
    depth, T = frames(scene, n=1)[0]
    sh.integrate_depth(depth, T)
    sh.update_esdf()
    for sq in sh.channels["esdf_sq_dist"]:
        sq += 123.0
    poisoned = [sq.clone() for sq in sh.channels["esdf_sq_dist"]]
    sh.update_esdf()               # nothing dirty: skipped
    for a, b in zip(sh.channels["esdf_sq_dist"], poisoned):
        assert torch.equal(a, b)
    sh.integrate_depth(depth, T)   # new integration: the next update solves
    sh.update_esdf()
    assert not all(torch.equal(a, b) for a, b in
                   zip(sh.channels["esdf_sq_dist"], poisoned))


def test_load_state_arrays_rows_by_global_shard():
    """A whole map's stacked arrays load into a process holding shards
    4..7 of a two-process mesh as those shards' rows; that process's own
    `state_arrays` (4 rows) load back by local position; any other
    leading size raises."""
    scene = Scene(primitives=(Sphere(center=(0.0, 0.0, 1.0), radius=0.6),))
    whole = sharded()
    depth, T = frames(scene, n=1)[0]
    whole.integrate_depth(depth, T)
    arrays = whole.state_arrays()
    assert int(arrays["alloc_count"][4:].sum()) > 0
    mesh = SpatialMesh([(r, "cpu") for r in (0, 1) for _ in range(4)],
                       rank=1)
    half = ShardedDeviceMapper(mesh, CAM, CFG)
    half.load_state_arrays(arrays)
    got = half.state_arrays()
    for k, v in got.items():
        np.testing.assert_array_equal(v, arrays[k][4:], err_msg=k)
    again = ShardedDeviceMapper(mesh, CAM, CFG)
    again.load_state_arrays(got)
    for k, v in again.state_arrays().items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    with pytest.raises(ValueError):
        half.load_state_arrays({k: v[:3] for k, v in arrays.items()})
