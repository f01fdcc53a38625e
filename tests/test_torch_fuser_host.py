"""The offline Fuser's host backend against the reference's on the same
Replica-format files as test_torch_fuser.py (CPU): the reference's
functions on both sides, all equal; and the host backend against the
port's device backend on the same frames."""

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.datasets import fuser as jfuser
from isaac_ros_nvblox_tpu.datasets import replica as jrep
from isaac_ros_nvblox_tpu_torch.datasets import fuser as tfuser
from isaac_ros_nvblox_tpu_torch.datasets import replica as trep
from test_torch_fuser import TSDF, VOXEL, _agree, replica_root  # noqa: F401

torch.set_num_threads(2)

HOST_FRAMES = 6


@pytest.fixture(scope="module")
def host_runs(replica_root):
    cfg = dict(voxel_size_m=VOXEL, capacity=8192)
    j = jfuser.Fuser(jrep.ReplicaDataLoader(replica_root),
                     jfuser.FuserConfig(**cfg), backend="host")
    t = tfuser.Fuser(trep.ReplicaDataLoader(replica_root),
                     tfuser.FuserConfig(**cfg), backend="host", device="cpu")
    assert j.run(max_frames=HOST_FRAMES) == t.run(max_frames=HOST_FRAMES)
    return j, t


def test_host_fuser_matches_reference(host_runs):
    """Both host-table Mappers on the first 6 frames: the same table, every
    channel and the mesh layer equal."""
    j, t = host_runs
    jt, tt = j.mapper.table, t.mapper.table
    assert tt.num_allocated == jt.num_allocated > 300
    np.testing.assert_array_equal(tt.block_indices, jt.block_indices)
    np.testing.assert_array_equal(tt.neighbors, jt.neighbors)
    assert t.mapper.pool.channels.keys() == j.mapper.pool.channels.keys()
    for k, ch in j.mapper.pool.channels.items():
        got, want = t.mapper.pool[k].numpy(), np.asarray(ch)
        if k in TSDF + ("color_rgb", "color_weight"):
            assert _agree(got, want) >= 0.999, k
        else:
            np.testing.assert_array_equal(got, want, k)
    got, want = t.mapper.mesh_layer.blocks, j.mapper.mesh_layer.blocks
    assert got.keys() == want.keys() and len(got) > 100
    for k, b in want.items():
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(got[k], f),
                                          getattr(b, f), f)


def test_host_backend_allocates_the_device_backends_blocks(replica_root,
                                                           host_runs):
    """On the same frames the two backends allocate the same blocks and
    fuse the same TSDF (test_world_grid.py's device-vs-host check)."""
    _, h = host_runs
    d = tfuser.Fuser(trep.ReplicaDataLoader(replica_root, HOST_FRAMES),
                     tfuser.FuserConfig(voxel_size_m=VOXEL, capacity=8192),
                     device="cpu")
    for frame in d.loader:
        d.mapper.integrate_depth(frame.depth, frame.T_L_C, frame.camera)
    n = d.mapper.block_count()
    assert n == h.mapper.table.num_allocated
    bidx = d.mapper.state.block_index_of_slot[:n].numpy()
    slots = np.asarray([h.mapper.table.slot_of(tuple(b)) for b in bidx])
    assert (slots >= 0).all()
    for k in TSDF:
        np.testing.assert_allclose(d.mapper.channels[k][:n].numpy(),
                                   h.mapper.pool[k].numpy()[slots],
                                   atol=1e-5, err_msg=k)
