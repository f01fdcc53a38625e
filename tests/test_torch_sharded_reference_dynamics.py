"""The port's ShardedDeviceMapper against the reference's on the same
frames, for the steps beside depth, color and the ESDF: occupancy,
freespace, the dynamic tick (detection, the masked split), TSDF and
occupancy decay with slot recycling, and lidar into the recycled slots.
An 8-shard (4 x 2) tile grid on the CPU, the reference on its 8-device
virtual mesh. Each stage's arrays are compared shard by shard and slot by
slot: the allocator state, dirty bits, occupancy, freespace and the
dynamic mask exactly, TSDF and weights within 1e-5, and the squared ESDF
bit for bit on owned blocks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.mapper.params import MapperParams as JParams
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import lidar as jl
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops.decay import OccupancyDecayParams as JOccDecay
from isaac_ros_nvblox_tpu.ops.decay import TsdfDecayParams as JTsdfDecay
from isaac_ros_nvblox_tpu.ops.esdf import EsdfIntegratorParams as JEsdf
from isaac_ros_nvblox_tpu.parallel import sharded_mapper as jsm
from isaac_ros_nvblox_tpu.parallel.spatial import make_spatial_mesh as jmesh
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
from isaac_ros_nvblox_tpu_torch.ops.decay import (OccupancyDecayParams,
                                                  TsdfDecayParams)
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.parallel.sharded_mapper import (
    ShardedDeviceMapper, ShardedMapperConfig)
from isaac_ros_nvblox_tpu_torch.parallel.spatial import make_spatial_mesh
from test_torch_sharded_reference import CAM_ARGS, STATE, _owned

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="the reference needs 8 devices")
torch.set_num_threads(2)

CFG = dict(n_shards=8, shard_grid=(4, 2), global_dims=(32, 32, 16),
           origin_block=(-16, -16, -4), capacity_per_shard=1024,
           voxel_size_m=0.05, max_blocks_per_frame=1024, mesh_max_blocks=512,
           enable_occupancy=True, enable_freespace=True)
# Decay fast enough that two steps free the weakly observed blocks.
DECAY = dict(decay_factor=0.1, decayed_weight_threshold=1e-3)
OCC_DECAY = dict(free_region_decay_probability=0.9,
                 occupied_region_decay_probability=0.1)
# Exact: allocator state, flags, freespace times, occupancy evidence.
EXACT = STATE + ("dirty", "esdf_dirty", "occupancy_observed",
                 "freespace_consecutive_ms", "freespace_last_occupied_ms",
                 "freespace_high_confidence")
# Within 1e-5: the fused float channels (the ops' summation order).
CLOSE = ("tsdf_distance", "tsdf_weight", "occupancy_log_odds")
STAGES = ("fused", "dynamic", "decayed", "lidar")


def _jax_arrays(m):
    out = {k: np.array(getattr(m.state, k)) for k in STATE}
    out.update({k: np.array(v) for k, v in m.channels.items()})
    out["dirty"] = np.array(m.dirty)
    out["esdf_dirty"] = np.array(m.esdf_dirty)
    return out


def _lidar_scan():
    """A cylindrical wall at 1.2 m around a sensor at z = 1 m, as a range
    image (the same points for both packages)."""
    lidar = Lidar.equal_vertical_fov(64, 16, np.deg2rad(30.0),
                                     min_range_m=0.2, max_range_m=8.0)
    jlidar = jl.Lidar.equal_vertical_fov(64, 16, np.deg2rad(30.0),
                                         min_range_m=0.2, max_range_m=8.0)
    az = np.linspace(-np.pi, np.pi, 256, endpoint=False)
    el = np.linspace(-0.12, 0.12, 12)
    azg, elg = np.meshgrid(az, el)
    r = 1.2 / np.cos(elg)
    points = np.stack([r * np.cos(elg) * np.cos(azg),
                       r * np.cos(elg) * np.sin(azg),
                       r * np.sin(elg)], -1).reshape(-1, 3).astype(np.float32)
    rimg = np.asarray(jl.pointcloud_to_range_image(jnp.asarray(points),
                                                   jlidar))
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = 1.0
    return rimg, T, lidar, jlidar


@pytest.fixture(scope="module")
def runs():
    """Both mappers through three frames of depth + occupancy + freespace,
    a dynamic tick with an intruder, two decays and a lidar scan; each
    package's arrays kept after every stage, then the ESDF solved."""
    jcam = jc.Camera(**CAM_ARGS)
    j = jsm.ShardedDeviceMapper(
        jmesh(8), jcam, jsm.ShardedMapperConfig(**CFG),
        JParams(esdf=JEsdf(max_esdf_distance_m=1.0),
                tsdf_decay=JTsdfDecay(**DECAY),
                occupancy_decay=JOccDecay(**OCC_DECAY)))
    t = ShardedDeviceMapper(
        make_spatial_mesh(8, device="cpu"), Camera(**CAM_ARGS),
        ShardedMapperConfig(**CFG),
        MapperParams(esdf=EsdfIntegratorParams(max_esdf_distance_m=1.0),
                     tsdf_decay=TsdfDecayParams(**DECAY),
                     occupancy_decay=OccupancyDecayParams(**OCC_DECAY)))
    scene = js.Scene(primitives=(
        js.Sphere(center=(0.0, 0.0, 1.0), radius=0.6),))
    intruder = js.Scene(primitives=scene.primitives + (
        js.Sphere(center=(0.6, 0.3, 1.0), radius=0.18),))
    out = {"j": {}, "t": {}}
    T = None
    for k in range(3):
        T = js.orbit_pose(2 * np.pi * k / 8, radius=2.0, height=1.0,
                          target=(0, 0, 1.0))
        depth = np.asarray(js.render_depth(scene, jcam, jnp.asarray(T)))
        for m in (j, t):
            m.integrate_depth(depth, T)
            m.integrate_depth_occupancy(depth, T)
            m.update_freespace(T, 400.0 * (k + 1))
    out["j"]["fused"], out["t"]["fused"] = _jax_arrays(j), t.state_arrays()
    d_intr = np.asarray(js.render_depth(intruder, jcam, jnp.asarray(T)))
    out["j_mask"] = np.asarray(j.dynamic_tick(d_intr, T, 1600.0))
    out["t_mask"] = t.dynamic_tick(d_intr, T, 1600.0).numpy()
    out["j"]["dynamic"], out["t"]["dynamic"] = (_jax_arrays(j),
                                                t.state_arrays())
    for _ in range(2):
        j.decay()
        t.decay()
    out["j"]["decayed"], out["t"]["decayed"] = (_jax_arrays(j),
                                                t.state_arrays())
    rimg, T_S, lidar, jlidar = _lidar_scan()
    j.integrate_lidar(rimg, T_S, jlidar)
    t.integrate_lidar(rimg, T_S, lidar)
    j.update_esdf()
    t.update_esdf()
    out["j"]["lidar"], out["t"]["lidar"] = _jax_arrays(j), t.state_arrays()
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_reference(runs, stage):
    """Every shard's arrays after the stage: the allocator state (slot
    grid, slot blocks, counts, free stack), dirty bits, occupancy observed
    flags and freespace channels equal; TSDF, weights and log-odds within
    1e-5."""
    a, b = runs["t"][stage], runs["j"][stage]
    for k in EXACT:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{stage} {k}")
    for k in CLOSE:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                   err_msg=f"{stage} {k}")


def test_stages_exercise_every_step(runs):
    """The run means something: occupied and free evidence, confident
    freespace, dynamic pixels, blocks freed by decay and slots recycled by
    the lidar scan."""
    t = runs["t"]
    assert int((t["fused"]["occupancy_log_odds"] > 0).sum()) > 100
    assert int((t["fused"]["occupancy_log_odds"] < 0).sum()) > 1000
    assert int(t["fused"]["freespace_high_confidence"].sum()) > 100
    assert int(runs["t_mask"].sum()) > 10
    freed = t["decayed"]["free_count"]
    assert int(freed.sum()) > 10
    live = t["decayed"]["alloc_count"] - freed
    assert int(live.sum()) > 10           # decay freed some blocks, not all
    assert int(t["lidar"]["free_count"].sum()) < int(freed.sum())
    # Freed rows start clean: no weight, no occupancy, unset freespace.
    d = t["decayed"]
    for s in range(CFG["n_shards"]):
        rows = d["free_stack"][s][:int(d["free_count"][s])]
        for k in CLOSE + ("occupancy_observed", "freespace_consecutive_ms",
                          "freespace_last_occupied_ms",
                          "freespace_high_confidence"):
            assert not d[k][s][rows].any(), k
        assert (d["esdf_sq_dist"][s][rows] > 1e11).all()


def test_dynamic_mask_matches_reference(runs):
    np.testing.assert_array_equal(runs["t_mask"], runs["j_mask"])


def test_esdf_after_recycling_matches_reference(runs):
    """The squared ESDF over the recycled map, bit for bit on every owned
    block."""
    a = _owned(runs["t"]["lidar"], ("esdf_sq_dist",), CFG)
    b = _owned(runs["j"]["lidar"], ("esdf_sq_dist",), CFG)
    assert set(a) == set(b) and len(a) > 50
    for key in a:
        np.testing.assert_array_equal(a[key][0], b[key][0], err_msg=str(key))
