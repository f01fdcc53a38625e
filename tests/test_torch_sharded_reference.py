"""The port's ShardedDeviceMapper against the reference's on the same
frames: an 8-shard (4 x 2) tile grid on the CPU (the reference on its
8-device virtual mesh, its EDT passes in interpret mode), blocks compared
by world index. Also a reference sharded map loaded into the port
(`load_state_arrays`) and solved there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.mapper.params import MapperParams as JParams
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops.esdf import EsdfIntegratorParams as JEsdf
from isaac_ros_nvblox_tpu.parallel import sharded_mapper as jsm
from isaac_ros_nvblox_tpu.parallel.spatial import make_spatial_mesh as jmesh
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.parallel.sharded_mapper import (
    ShardedDeviceMapper, ShardedMapperConfig)
from isaac_ros_nvblox_tpu_torch.parallel.spatial import make_spatial_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="the reference needs 8 devices")
torch.set_num_threads(2)

VOXEL = 0.05
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
CFG = dict(n_shards=8, shard_grid=(4, 2), global_dims=(32, 32, 16),
           origin_block=(-16, -16, -4), capacity_per_shard=1024,
           voxel_size_m=VOXEL, max_blocks_per_frame=1024, mesh_max_blocks=512,
           enable_color=True)
STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")


def _port_mapper():
    return ShardedDeviceMapper(
        make_spatial_mesh(8, device="cpu"), Camera(**CAM_ARGS),
        ShardedMapperConfig(**CFG),
        MapperParams(esdf=EsdfIntegratorParams(max_esdf_distance_m=1.0)))


def _jax_arrays(m):
    out = {k: np.array(getattr(m.state, k)) for k in STATE}
    out.update({k: np.array(v) for k, v in m.channels.items()})
    out["dirty"] = np.array(m.dirty)
    out["esdf_dirty"] = np.array(m.esdf_dirty)
    return out


@pytest.fixture(scope="module")
def runs():
    """Both mappers over two RGB-D frames of the reference's scene; the
    reference's map is also kept as arrays before its ESDF update."""
    jcam = jc.Camera(**CAM_ARGS)
    scene = js.Scene(primitives=(
        js.Sphere(center=(0.3, 0.2, 1.0), radius=0.5),))
    j = jsm.ShardedDeviceMapper(
        jmesh(8), jcam, jsm.ShardedMapperConfig(**CFG),
        JParams(esdf=JEsdf(max_esdf_distance_m=1.0)))
    t = _port_mapper()
    for k in range(2):
        T = js.orbit_pose(2 * np.pi * k / 8, radius=2.0, height=1.0,
                          target=(0, 0, 1.0))
        depth = np.asarray(js.render_depth(scene, jcam, jnp.asarray(T)))
        color = np.asarray(js.render_color(scene, jcam, jnp.asarray(T)))
        j.integrate_depth(depth, T)
        j.integrate_color(color, depth, T)
        t.integrate_depth(depth, T)
        t.integrate_color(color, depth, T)
    before_esdf = _jax_arrays(j)
    j.update_esdf()
    t.update_esdf()
    return {"j": j, "t": t, "before_esdf": before_esdf,
            "j_arrays": _jax_arrays(j), "t_arrays": t.state_arrays(),
            "j_mesh": j.export_mesh_blocks(), "t_mesh": t.export_mesh_blocks(),
            "j_slice": j.slice_esdf_2d(height_m=1.0),
            "t_slice": t.slice_esdf_2d(height_m=1.0)}


def _owned(arrays, names, cfg=CFG):
    """{block key: rows of `names`} over the owned live blocks."""
    Lx = cfg["global_dims"][0] // cfg["shard_grid"][0]
    Ly = cfg["global_dims"][1] // cfg["shard_grid"][1]
    out = {}
    for s in range(cfg["n_shards"]):
        n = int(arrays["alloc_count"][s])
        bidx = arrays["block_index_of_slot"][s][:n]
        local = bidx - arrays["origin_block"][s]
        keep = ((local[:, 0] >= 1) & (local[:, 0] <= Lx) & (local[:, 1] >= 1)
                & (local[:, 1] <= Ly) & (bidx[:, 0] < (1 << 20)))
        for i in np.flatnonzero(keep):
            out[tuple(int(v) for v in bidx[i])] = tuple(
                arrays[k][s][i] for k in names)
    return out


def test_tsdf_and_esdf_match_reference(runs):
    """Owned blocks: the same block set, TSDF and weights within 1e-5,
    squared ESDF bit for bit."""
    names = ("tsdf_distance", "tsdf_weight", "esdf_sq_dist")
    a = _owned(runs["t_arrays"], names)
    b = _owned(runs["j_arrays"], names)
    assert set(a) == set(b) and len(a) > 50
    for key in a:
        (d, w, sq), (dj, wj, sqj) = a[key], b[key]
        np.testing.assert_allclose(d, dj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(w, wj, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(sq, sqj, err_msg=str(key))
    assert sum(int((v[2] < 1e11).sum()) for v in a.values()) > 10000


def _half_ulp_bf16(x):
    """Half a bfloat16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 8)


def test_mesh_matches_reference(runs):
    """Per owned block: equal triangle counts; each vertex the reference's
    rounded to the kernel's bfloat16 block-local output (within half a
    bf16 unit of the block-local coordinate, plus 1e-5 m), and equal to
    that rounding to 1e-5 m for all but a tie-break share of 1e-3; colors
    within half a bf16 unit (+ 1e-3)."""
    tm, jm = runs["t_mesh"], runs["j_mesh"]
    keys = [k for k, (v, _) in jm.items() if v.shape[0]]
    assert len(keys) >= 10
    assert keys and {k for k, (v, _) in tm.items() if v.shape[0]} == set(keys)
    exact = total = 0
    for key in keys:
        (vt, ct), (vj, cj) = tm[key], jm[key]
        assert vt.shape == vj.shape, key
        base = np.asarray(key, np.float64) * 8
        lt = vt / VOXEL - base
        lj = vj.astype(np.float64) / VOXEL - base
        # Match each port triangle to its nearest reference triangle.
        cost = np.abs(lt[:, None] - lj[None]).reshape(
            len(lt), len(lj), -1).max(-1)
        match = cost.argmin(1)
        assert len(set(match.tolist())) == len(lt), key
        lj, cj = lj[match], cj[match]
        np.testing.assert_array_less(np.abs(lt - lj),
                                     _half_ulp_bf16(lj) + 1e-5 / VOXEL)
        rounded = torch.as_tensor(lj.astype(np.float32)).to(
            torch.bfloat16).double().numpy()
        exact += int((np.abs(lt - rounded) <= 1e-5 / VOXEL).sum())
        total += lt.size
        np.testing.assert_array_less(np.abs(ct - cj),
                                     _half_ulp_bf16(cj) + 1e-3)
    assert exact >= 0.999 * total, (exact, total)


def test_esdf_slice_matches_reference(runs):
    np.testing.assert_array_equal(runs["t_slice"], runs["j_slice"])
    assert (runs["t_slice"] < 1000.0).sum() > 500


def test_load_reference_state_then_solve(runs):
    """The reference's sharded map before its ESDF update, loaded into the
    port and solved there: the reference's squared ESDF bit for bit on
    every owned block, its TSDF as loaded."""
    m = _port_mapper()
    m.load_state_arrays(runs["before_esdf"])
    arrays = m.state_arrays()
    for k in STATE + ("tsdf_distance", "tsdf_weight", "esdf_dirty"):
        np.testing.assert_array_equal(arrays[k], runs["before_esdf"][k],
                                      err_msg=k)
    m.update_esdf()
    a = _owned(m.state_arrays(), ("esdf_sq_dist",))
    b = _owned(runs["j_arrays"], ("esdf_sq_dist",))
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key][0], b[key][0], err_msg=str(key))
    assert not m.esdf_dirty[0].any()
