"""The offline Fuser, both backends, against the reference's Fuser on the
same Replica-format files (CPU): test_dataset_replay.py's sequence (12
frames, 160x120), written by the reference's writer.

Device backend: the port runs the plain versions of its kernels; the
reference its XLA TSDF and color paths and its EDT in interpret mode, and
on the CPU its mesh layer takes an f32 XLA branch where the port runs the
bf16 marching-cubes kernel's plain version (the reference's TPU branch).
TSDF and color are held to the rule of slices 1-4 (>= 99.9% of voxels
within 1e-5), the ESDF bit for bit, the mesh triangle for triangle within
the bf16 branch's interpolation error. Host backend: the reference's
functions on both sides, all equal."""

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.datasets import fuser as jfuser
from isaac_ros_nvblox_tpu.datasets import replica as jrep
from isaac_ros_nvblox_tpu.datasets.replica_writer import (
    write_replica_sequence)
from isaac_ros_nvblox_tpu.io.ply import write_mesh_ply as jwrite_mesh_ply
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks
from isaac_ros_nvblox_tpu_torch.datasets import fuser as tfuser
from isaac_ros_nvblox_tpu_torch.datasets import replica as trep
from isaac_ros_nvblox_tpu_torch.models import scene as ts
from isaac_ros_nvblox_tpu_torch.utils.timing import Timing

torch.set_num_threads(2)

VOXEL = 0.05
N_FRAMES = 12
HOST_FRAMES = 6
CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
TSDF = ("tsdf_distance", "tsdf_weight")


def _scene(mod):
    return mod.Scene(primitives=(
        mod.RoomBox(center=(0.0, 0.0, 1.25), half_extents=(2.2, 1.8, 1.25)),
        mod.Sphere(center=(0.9, 0.6, 0.8), radius=0.4),
        mod.Box(center=(-1.0, -0.8, 0.4), half_extents=(0.35, 0.35, 0.4))))


@pytest.fixture(scope="module")
def replica_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("replica_seq")
    write_replica_sequence(root, _scene(js), jc.Camera(**CAM_ARGS),
                           n_frames=N_FRAMES, orbit_radius=1.1,
                           orbit_height=1.0, target=(0, 0, 1.0))
    return root


@pytest.fixture(scope="module")
def device_runs(replica_root):
    j = jfuser.Fuser(jrep.ReplicaDataLoader(replica_root),
                     jfuser.FuserConfig(voxel_size_m=VOXEL, capacity=8192))
    t = tfuser.Fuser(trep.ReplicaDataLoader(replica_root),
                     tfuser.FuserConfig(voxel_size_m=VOXEL, capacity=8192),
                     device="cpu")
    Timing.reset()
    n_j, n_t = j.run(), t.run()
    assert n_j == n_t == N_FRAMES
    return j, t


@pytest.fixture(scope="module")
def host_runs(replica_root):
    cfg = dict(voxel_size_m=VOXEL, capacity=8192)
    j = jfuser.Fuser(jrep.ReplicaDataLoader(replica_root),
                     jfuser.FuserConfig(**cfg), backend="host")
    t = tfuser.Fuser(trep.ReplicaDataLoader(replica_root),
                     tfuser.FuserConfig(**cfg), backend="host", device="cpu")
    assert j.run(max_frames=HOST_FRAMES) == t.run(max_frames=HOST_FRAMES)
    return j, t


def _agree(got, want, tol=1e-5):
    """Share of voxels whose values agree within `tol`."""
    return float((np.abs(got - want) <= tol).mean())


def test_device_fuser_matches_reference(device_runs):
    j, t = device_runs
    assert t.mapper.block_count() == j.mapper.block_count() > 300
    got = t.mapper.state_arrays()
    n = t.mapper.block_count()
    np.testing.assert_array_equal(
        got["block_index_of_slot"][:n],
        np.asarray(j.mapper.state.block_index_of_slot)[:n])
    for k in TSDF + ("color_r", "color_g", "color_b", "color_weight"):
        assert _agree(got[k], np.asarray(j.mapper.channels[k])) >= 0.999, k
    for k in ("esdf_sq_dist", "esdf_is_inside", "esdf_observed"):
        np.testing.assert_array_equal(got[k],
                                      np.asarray(j.mapper.channels[k]), k)
    assert t.frame_count == N_FRAMES
    for span in ("fuser/depth", "fuser/color", "fuser/esdf", "fuser/mesh"):
        assert Timing.get(span).count > 0, span


def _soups(layer):
    return {k: b.vertices[b.triangles] for k, b in layer.blocks.items()}


def test_device_fuser_mesh_matches_reference(device_runs):
    """The same blocks and triangles; vertices within the bf16 kernel
    branch's interpolation error (1/16 voxel; 1/32 measured)."""
    j, t = device_runs
    got, want = _soups(t.mapper.mesh_layer), _soups(j.mapper.mesh_layer)
    assert got.keys() == want.keys() and len(got) > 100
    worst = 0.0
    for k, soup in want.items():
        assert got[k].shape == soup.shape, k
        worst = max(worst, float(np.abs(got[k] - soup).max()))
    assert worst <= VOXEL / 16, worst
    v, c, tri = t.mapper.mesh_layer.as_arrays()
    assert tri.shape[0] > 2000 and c.max() > 10


def test_replay_reconstruction_accuracy(device_runs):
    """test_dataset_replay.py's thresholds on the port's run: sub-voxel
    surface error, small ESDF error in observed free space."""
    _, t = device_runs
    m = t.mapper
    scene = _scene(ts)
    v, c, tri = m.mesh_layer.as_arrays()
    assert tri.shape[0] > 2000
    sdf = scene.sdf(torch.from_numpy(v)).numpy()
    assert float(np.mean(np.abs(sdf))) < VOXEL
    assert float(np.percentile(np.abs(sdf), 90)) < 2 * VOXEL
    assert c.max() > 10
    n = m.block_count()
    centers = voxel_centers_for_blocks(m.state.block_index_of_slot[:n], VOXEL)
    gt = scene.sdf(centers).numpy()
    sq = m.channels["esdf_sq_dist"][:n].numpy()
    est = np.sqrt(np.minimum(sq, 1e12)) * VOXEL
    mask = (gt > 3 * VOXEL) & (gt < 1.0) & (sq < 1e11)
    assert mask.sum() > 5000
    err = np.abs(est[mask] - gt[mask])
    assert float(np.median(err)) < VOXEL
    assert float(np.mean(err)) < 2 * VOXEL


def test_output_mesh_ply_matches_reference_writer(device_runs, tmp_path):
    _, t = device_runs
    t.output_mesh_ply(tmp_path / "port.ply")
    v, c, tri = t.mapper.mesh_layer.as_arrays()
    jwrite_mesh_ply(tmp_path / "ref.ply", v, tri, c)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "ref.ply").read_bytes()


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


def test_fuser_rejects_unknown_backend(replica_root):
    with pytest.raises(ValueError, match="backend"):
        tfuser.Fuser(trep.ReplicaDataLoader(replica_root), backend="gpu",
                     device="cpu")
