"""DeviceMapper(enable_esdf=False) against the reference's ESDF-less
DeviceMapper on the same frames (CPU, 160x120): the channels it keeps,
the TSDF (the rule of slices 1-4), update_esdf and replay_frames leaving
the state as the reference leaves it, map files crossing both ways, the
node's save_ply and the ESDF readers failing as the reference's do. Also
Scene.normal and the names MultiMapper gives its mappers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.io import ply as jply
from isaac_ros_nvblox_tpu.mapper import device_io as jdio
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper import multi_mapper as jmm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops.esdf import EsdfIntegratorParams as JEsdf
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu.runtime import node as jnode
from isaac_ros_nvblox_tpu_torch.core import types as tys
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.io import ply as tply
from isaac_ros_nvblox_tpu_torch.mapper import device_io as tdio
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper import multi_mapper as tmm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.models import scene as ts
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams as TEsdf
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams as TTsdf
from isaac_ros_nvblox_tpu_torch.runtime import node as tnode
from test_torch_device_mapper import assert_tsdf_matches

torch.set_num_threads(2)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
JCAM = jc.Camera(**CAM_ARGS)
TCAM = tc.Camera(**CAM_ARGS)
VOXEL = 0.05
WORLD = dict(dims=(48, 48, 24), capacity=4096, origin_block=(-24, -24, -6))
STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")
ESDF = ("esdf_sq_dist", "esdf_is_inside", "esdf_observed")
# state_arrays() keys beyond the allocator state and the channels.
EXTRA = ("mesh_pending", "removed_log", "removed_count",
         "freespace_last_update_ms")
CONFIGS = {
    "tsdf_color": lambda p: {},
    "tsdf": lambda p: dict(enable_color=False),
    "freespace": lambda p: dict(enable_color=False, enable_freespace=True),
    "occupancy": lambda p: dict(
        projective_layer=p.ProjectiveLayerType.OCCUPANCY),
}


def _jax_mapper(enable_esdf=False, **kw):
    params = jp.MapperParams(
        projective=JTsdf(max_integration_distance_m=3.0),
        esdf=JEsdf(max_esdf_distance_m=0.6))
    return jdm.DeviceMapper(VOXEL, params=params,
                            world=jwg.WorldGridConfig(**WORLD),
                            enable_esdf=enable_esdf,
                            max_blocks_per_frame=1024, **kw)


def _port_mapper(enable_esdf=False, **kw):
    params = tp.MapperParams(
        projective=TTsdf(max_integration_distance_m=3.0),
        esdf=TEsdf(max_esdf_distance_m=0.6))
    return tdm.DeviceMapper(VOXEL, params=params,
                            world=twg.WorldGridConfig(**WORLD),
                            enable_esdf=enable_esdf,
                            max_blocks_per_frame=1024, device="cpu", **kw)


def _jax_arrays(m):
    out = {f: np.asarray(getattr(m.state, f)) for f in STATE}
    out.update({k: np.asarray(v) for k, v in m.channels.items()})
    return out


@pytest.fixture(scope="module")
def frames():
    scene = js.default_test_scene()
    out = []
    for k in range(4):
        T = js.orbit_pose(2 * np.pi * k / 8, radius=1.8)
        out.append((np.array(js.render_depth(scene, JCAM, jnp.asarray(T))), T))
    return out


@pytest.fixture(scope="module")
def reference(frames):
    """The reference's ESDF-less mapper after 3 frames: its arrays before
    and after update_esdf(), and the mapper."""
    m = _jax_mapper()
    for depth, T in frames[:3]:
        m.integrate_depth(depth, T, JCAM)
    before = _jax_arrays(m)
    m.update_esdf()
    return before, _jax_arrays(m), m


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_channels_match_reference(config):
    j = _jax_mapper(**CONFIGS[config](jp))
    t = _port_mapper(**CONFIGS[config](tp))
    assert set(t.channels) == set(j.channels)
    assert not set(ESDF) & set(t.channels)
    arrays = t.state_arrays()
    assert set(arrays) - set(STATE) - set(EXTRA) == set(j.channels)
    for k, v in j.channels.items():
        assert arrays[k].dtype == np.asarray(v).dtype, k
    with_esdf = _port_mapper(enable_esdf=True, **CONFIGS[config](tp))
    assert set(with_esdf.channels) == set(
        _jax_mapper(enable_esdf=True, **CONFIGS[config](jp)).channels)
    assert set(with_esdf.channels) - set(t.channels) == set(ESDF)


def test_name_is_stored_as_the_reference_stores_it():
    assert _port_mapper().name == _jax_mapper().name == "device_mapper"
    assert _port_mapper(name="probe").name == _jax_mapper(
        name="probe").name == "probe"


def test_tsdf_and_update_esdf_match_reference(frames, reference):
    before, want, j = reference
    t = _port_mapper()
    for depth, T in frames[:3]:
        t.integrate_depth(depth, T, TCAM)
    got = t.state_arrays()
    t.update_esdf()
    after = t.state_arrays()
    assert after.keys() == got.keys()
    for k in got:
        np.testing.assert_array_equal(after[k], got[k], err_msg=k)
    for k in want:   # the reference's update_esdf changed nothing either
        np.testing.assert_array_equal(want[k], before[k], err_msg=k)
    for f in STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(want["alloc_count"]) > 300
    assert_tsdf_matches(got, want, [T for _, T in frames[:3]], TCAM)
    np.testing.assert_array_equal(t.esdf_dirty.numpy(),
                                  np.asarray(j.esdf_dirty))
    assert t._esdf_has_full is j._esdf_has_full is False
    np.testing.assert_array_equal(t._dirty_lo, j._dirty_lo)
    np.testing.assert_array_equal(t._dirty_hi, j._dirty_hi)


def test_replay_frames_runs_no_esdf(frames):
    depths = np.stack([d for d, _ in frames])
    poses = np.stack([T for _, T in frames])
    j, t = _jax_mapper(enable_color=False), _port_mapper(enable_color=False)
    j.replay_frames(depths, poses, JCAM, esdf_every=2)
    t.replay_frames(depths, poses, TCAM, esdf_every=2)
    got, want = t.state_arrays(), _jax_arrays(j)
    for f in STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert_tsdf_matches(got, want, list(poses), TCAM)
    # No solve ran: the ESDF-dirty bits stay set on both sides, and the
    # region is unknown as after a replay without ESDF.
    esdf_dirty = t.esdf_dirty.numpy()
    assert esdf_dirty.sum() > 300
    np.testing.assert_array_equal(esdf_dirty, np.asarray(j.esdf_dirty))
    assert t._region_unknown and j._region_unknown
    assert not t._esdf_has_full and not j._esdf_has_full


def test_map_files_cross_between_packages(frames, reference, tmp_path):
    """An ESDF-less map saved by either package loads into the other's
    ESDF-less mapper with every channel of every block; an ESDF-ful mapper
    refuses it in both packages."""
    _, want, j = reference
    t = _port_mapper()
    for depth, T in frames[:3]:
        t.integrate_depth(depth, T, TCAM)
    mine = t.state_arrays()
    tdio.save_map_device(t, tmp_path / "port.nvblx")
    jdio.save_map_device(j, tmp_path / "jax.nvblx")
    with np.load(tmp_path / "port.nvblx") as a, \
            np.load(tmp_path / "jax.nvblx") as b:
        assert sorted(a.files) == sorted(b.files)
        assert not any(k.startswith("channel__esdf") for k in a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
    n = int(want["alloc_count"])
    j2 = _jax_mapper()
    assert jdio.load_map_device(j2, tmp_path / "port.nvblx") == n
    t2 = _port_mapper()
    assert tdio.load_map_device(t2, tmp_path / "jax.nvblx") == n
    loaded = t2.state_arrays()
    for k, v in j2.channels.items():
        np.testing.assert_array_equal(np.asarray(v)[:n], mine[k][:n],
                                      err_msg=k)
        np.testing.assert_array_equal(loaded[k][:n], want[k][:n], err_msg=k)
    np.testing.assert_array_equal(loaded["block_index_of_slot"],
                                  want["block_index_of_slot"])
    for name in ("port.nvblx", "jax.nvblx"):
        with pytest.raises(ValueError, match="channel mismatch"):
            tdio.load_map_device(_port_mapper(enable_esdf=True),
                                 tmp_path / name)
        with pytest.raises(ValueError, match="channel mismatch"):
            jdio.load_map_device(_jax_mapper(enable_esdf=True),
                                 tmp_path / name)


def test_node_save_ply_writes_the_same_files(frames, tmp_path):
    """The node's save_ply with an ESDF-less static mapper: mesh.ply and
    tsdf.ply, no esdf.ply, in both packages."""
    depth, T = frames[0]
    written = []
    for pkg, node, mapper, cam in (
            ("port", tnode.NvbloxNode(
                tnode.NodeParams(),
                tp.make_params(overlay={"block_capacity": 4096}),
                device="cpu"), _port_mapper(), TCAM),
            ("jax", jnode.NvbloxNode(
                jnode.NodeParams(),
                jp.make_params(overlay={"block_capacity": 4096})),
             _jax_mapper(), JCAM)):
        node.clock = lambda: 0.0
        node.multi_mapper.static_mapper = mapper
        mapper.integrate_depth(depth, T, cam)
        out = tmp_path / pkg
        assert node.save_ply(out)
        written.append(sorted(p.name for p in out.iterdir()))
        assert all(p.stat().st_size > 0 for p in out.iterdir())
    assert written[0] == written[1] == ["mesh.ply", "tsdf.ply"]


READERS = {
    "slice": (
        lambda m: tdio.slice_esdf_device(m, slice_height_m=1.0,
                                         max_distance_m=2.0),
        lambda m: jdio.slice_esdf_device(m, slice_height_m=1.0,
                                         max_distance_m=2.0)),
    "dense_grid": (
        lambda m: tdio.esdf_and_gradients_device(m, (-1, -1, 0), (1, 1, 2)),
        lambda m: jdio.esdf_and_gradients_device(m, (-1, -1, 0), (1, 1, 2))),
}


@pytest.mark.parametrize("reader", sorted(READERS) + ["ply"])
def test_esdf_readers_fail_as_reference(frames, reference, reader, tmp_path):
    _, _, j = reference
    t = _port_mapper()
    for depth, T in frames[:3]:
        t.integrate_depth(depth, T, TCAM)
    if reader == "ply":
        port, ref = (
            lambda m: tply.write_voxel_layer_ply_device(
                tmp_path / "port.ply", m, "esdf"),
            lambda m: jply.write_voxel_layer_ply_device(
                tmp_path / "jax.ply", m, "esdf"))
    else:
        port, ref = READERS[reader]
    with pytest.raises(KeyError, match="esdf_") as want:
        ref(j)
    with pytest.raises(KeyError) as got:
        port(t)
    assert got.value.args == want.value.args


def test_norm3_and_primitive_sdfs_match_reference_bit_for_bit():
    """norm3 rounds its root correctly, as XLA does on the CPU (the CPU's
    vectorized float32 sqrt does not), so that the scene's SDF equals the
    reference's bit for bit: central differences over a 1e-3 step turn
    one ulp of the SDF into ~6e-5 of the normal."""
    rng = np.random.default_rng(7)
    p = rng.uniform(-4.0, 4.0, (200000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tys.norm3(torch.from_numpy(p)).numpy(),
        np.asarray(jnp.linalg.norm(jnp.asarray(p), axis=-1)))
    for prim_t, prim_j in zip(ts.default_test_scene().primitives,
                              js.default_test_scene().primitives):
        np.testing.assert_array_equal(
            prim_t.sdf(torch.from_numpy(p)).numpy(),
            np.asarray(prim_j.sdf(jnp.asarray(p))), type(prim_t).__name__)


@pytest.mark.parametrize("eps", [1e-3, 4e-3])
def test_scene_normal_matches_reference(eps):
    rng = np.random.default_rng(5)
    p = rng.uniform(-4.0, 4.0, (2000, 3)).astype(np.float32)
    want = np.asarray(js.default_test_scene().normal(jnp.asarray(p), eps=eps))
    got = ts.default_test_scene().normal(torch.from_numpy(p), eps=eps)
    assert got.dtype == torch.float32 and got.shape == (2000, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    unit = np.linalg.norm(got.numpy(), axis=-1)
    assert np.abs(unit - 1.0).max() < 1e-5
    # A point where every difference vanishes keeps the 1e-9 clamp: zeros.
    flat = ts.Scene(primitives=(ts.Plane(normal=(0.0, 0.0, 1.0),
                                         offset=0.0),))
    assert torch.equal(flat.normal(torch.zeros(3), eps=0.0), torch.zeros(3))


@pytest.mark.parametrize("mapping_type", ["STATIC_TSDF", "DYNAMIC"])
def test_multi_mapper_names_match_reference(mapping_type):
    world = dict(dims=(16, 16, 8), capacity=1024, origin_block=(-8, -8, -2))
    t = tmm.MultiMapper(tp.MultiMapperParams(
        mapping_type=getattr(tp.MappingType, mapping_type),
        block_capacity=1024), world=twg.WorldGridConfig(**world),
        device="cpu")
    j = jmm.MultiMapper(jp.MultiMapperParams(
        mapping_type=getattr(jp.MappingType, mapping_type),
        block_capacity=1024), world=jwg.WorldGridConfig(**world))
    assert t.static_mapper.name == j.static_mapper.name == "static_mapper"
    if mapping_type == "DYNAMIC":
        assert t.dynamic_mapper.name == j.dynamic_mapper.name \
            == "dynamic_mapper"
    else:
        assert t.dynamic_mapper is j.dynamic_mapper is None
