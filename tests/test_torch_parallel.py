"""The port's shard mesh and sharded frame step against the reference's
(tests/test_parallel.py's cases): the frame step on 8 shards in one
process on the CPU, the mesh's collectives, the dry run, and the fused
single-shard frame step of the reference's compile entry."""

import jax
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.models.camera import Camera as JCamera
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu.parallel import spatial as jsp
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.parallel.dryrun import dryrun_multichip
from isaac_ros_nvblox_tpu_torch.parallel.spatial import (
    ShardedMapConfig, SpatialMesh, make_example_sharded_state,
    make_sharded_frame_step, make_spatial_mesh)

torch.set_num_threads(2)
CAM_ARGS = dict(fx=80.0, fy=80.0, cx=39.5, cy=29.5, width=80, height=60)


def _port_step():
    mesh = make_spatial_mesh(8, device="cpu")
    cam = Camera(**CAM_ARGS)
    config = ShardedMapConfig(capacity_per_shard=64, blocks_per_frame=32)
    step = make_sharded_frame_step(mesh, cam, config, TsdfIntegratorParams())
    return step, make_example_sharded_state(mesh, cam, config)


@pytest.fixture(scope="module")
def jax_step_out():
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 devices")
    mesh = jsp.make_spatial_mesh(8)
    cam = JCamera(**CAM_ARGS)
    config = jsp.ShardedMapConfig(capacity_per_shard=64, blocks_per_frame=32)
    step = jsp.make_sharded_frame_step(mesh, cam, config, JTsdf())
    out = step(*jsp.make_example_sharded_state(mesh, cam, config))
    return [np.asarray(x) for x in out]


def test_sharded_frame_step_runs_and_matches_reference(jax_step_out):
    """The 2 m wall fuses into every shard; the pools equal the
    reference's within 1e-5 (TSDF, weight), the relaxed ESDF seeds
    exactly, and the psum'd change count is the same on every shard and
    equal to the reference's."""
    step, state = _port_step()
    distance, weight, esdf_sq, changed = step(*state)
    assert len(distance) == 8 and distance[0].shape == (64, 512)
    assert float(torch.stack(weight).max()) > 0.0
    ch = np.array([int(c) for c in changed])
    assert (ch == ch[0]).all()
    jd, jw, jsq, jch = jax_step_out
    np.testing.assert_allclose(torch.cat(distance).numpy(), jd, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat(weight).numpy(), jw, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(torch.cat(esdf_sq).numpy(), jsq)
    np.testing.assert_array_equal(ch, jch)


def test_sharded_step_is_deterministic():
    step, _ = _port_step()
    out1 = step(*_port_step()[1])
    out2 = step(*_port_step()[1])
    for a, b in zip(out1[0] + out1[2], out2[0] + out2[2]):
        assert torch.equal(a, b)


def test_mesh_collectives_in_one_process():
    """ppermute sends along its pairs (zeros where nothing arrives, copies,
    not aliases), psum replicates the total, all_gather keeps shard
    order."""
    mesh = SpatialMesh([(0, "cpu")] * 4)
    vals = [torch.full((2, 3), float(s)) for s in range(4)]
    got = mesh.ppermute(vals, [(0, 1), (1, 2), (2, 3)])
    for s, t in enumerate(got):
        assert torch.equal(t, torch.full((2, 3), float(s - 1 if s else 0)))
    got[1] += 100.0
    assert float(vals[0][0, 0]) == 0.0
    assert [float(t[0, 0]) for t in mesh.psum(vals)] == [6.0] * 4
    assert [float(t[0, 0]) for t in mesh.all_gather(vals)] == [0, 1, 2, 3]
    assert mesh.sum_host(3) == 3 and mesh.any_host(False) is False


def test_dryrun_multichip_entry():
    m = dryrun_multichip(8, device="cpu")
    assert m.total_owned_blocks() > 0
    assert sum(int(st.free_count) for st in m.state) >= 0


def test_entry_frame_step_matches_reference():
    """The reference's compile entry (the fused frame step: view grid ->
    allocation -> TSDF fusion) against the port's `_integrate_frame` on
    the same flat wall: equal allocation, TSDF within 1e-5."""
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jstate, jdist = out[0], np.asarray(out[1])
    cam = Camera(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160,
                 height=120)
    cfg = twg.WorldGridConfig(dims=(16, 16, 8), capacity=512,
                              origin_block=(-8, -8, -2))
    state = twg.create_world_grid(cfg, "cpu")
    dist = torch.zeros((512, 512))
    weight = torch.zeros((512, 512))
    dirty = torch.zeros((512,), dtype=torch.bool)
    state = tdm._integrate_frame(
        state, dist, weight, dirty, dirty.clone(),
        torch.full((120, 160), 2.0), torch.eye(4), camera=cam,
        voxel_size_m=0.05, params=TsdfIntegratorParams(), max_blocks=256)
    assert int(state.alloc_count) == int(jstate.alloc_count) > 0
    np.testing.assert_array_equal(state.slot_grid.numpy(),
                                  np.asarray(jstate.slot_grid))
    np.testing.assert_allclose(dist.numpy(), jdist, rtol=0, atol=1e-5)
    assert float(dist.abs().sum()) > 0.0
