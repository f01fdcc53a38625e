"""The colored-mesh slice as a whole: the port's DeviceMapper against the
reference DeviceMapper on the same RGB-D frames (CPU). The reference runs
its XLA TSDF and color paths, its EDT and its Pallas marching-cubes kernel
in interpret mode; the port runs the plain versions of its kernels.

On the CPU the reference colors a color-cadence frame through the color
frustum's batch after the TSDF step; the port fuses it into the depth
frame's batch (what the reference does on the TPU). `_color_agreement`
measures that difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper.params import MapperParams as JParams
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops.esdf import EsdfIntegratorParams as JEsdf
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams as TParams
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams as TEsdf
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams as TTsdf
from test_torch_device_mapper import (ESDF, JCAM, STATE, TCAM, VOXEL, WORLD,
                                      assert_tsdf_matches)

torch.set_num_threads(2)

COLOR = ("color_r", "color_g", "color_b", "color_weight")
N_FRAMES = 10
CADENCE = dict(esdf_every=4, mesh_every=8, color_every=8,
               mesh_max_blocks=512, mesh_surface_blocks=32)


def _jax_mapper():
    params = JParams(projective=JTsdf(max_integration_distance_m=3.0),
                     esdf=JEsdf(max_esdf_distance_m=0.6))
    return jdm.DeviceMapper(VOXEL, params=params,
                            world=jwg.WorldGridConfig(**WORLD),
                            enable_color=True, enable_esdf=True,
                            max_blocks_per_frame=1024)


def _port_mapper():
    params = TParams(projective=TTsdf(max_integration_distance_m=3.0),
                     esdf=TEsdf(max_esdf_distance_m=0.6))
    return tdm.DeviceMapper(VOXEL, params=params,
                            world=twg.WorldGridConfig(**WORLD),
                            max_blocks_per_frame=1024, device="cpu")


@pytest.fixture(scope="module")
def rgbd():
    scene = js.default_test_scene()
    poses = np.stack([js.orbit_pose(2 * np.pi * k / 12, radius=1.8)
                      for k in range(N_FRAMES)]).astype(np.float32)
    depths = np.stack([np.asarray(js.render_depth(scene, JCAM,
                                                  jnp.asarray(T)))
                       for T in poses])
    colors = np.stack([np.asarray(js.render_color(scene, JCAM,
                                                  jnp.asarray(T)))
                       for T in poses])
    return depths, poses, colors


@pytest.fixture(scope="module")
def replayed(rgbd):
    """Both mappers after the replay at the benchmark's cadence, then one
    update_mesh_dirty_device each."""
    depths, poses, colors = rgbd
    # The ESDF region both replays solve: the frames' allocated AABB.
    probe = _port_mapper()
    probe.replay_frames(depths, poses, TCAM)
    region = probe.esdf_region(margin_blocks=0, mult=1)
    j = _jax_mapper()
    j.replay_frames(jnp.asarray(depths), jnp.asarray(poses), JCAM,
                    colors=jnp.asarray(colors), esdf_region=region,
                    **CADENCE)
    t = _port_mapper()
    t.replay_frames(depths, poses, TCAM, colors=colors, esdf_region=region,
                    **CADENCE)
    after = {}
    for name, m, arrays in (("jax", j, _jax_state), ("port", t, _port_state)):
        after[name] = arrays(m)
    mesh_j = j.update_mesh_dirty_device(max_blocks=512, use_pallas=True,
                                        return_slots=True)
    mesh_t = t.update_mesh_dirty_device(max_blocks=512, return_slots=True)
    return dict(j=j, t=t, after=after, mesh_j=mesh_j, mesh_t=mesh_t,
                region=region)


def _jax_state(m):
    out = {f: np.asarray(getattr(m.state, f)) for f in STATE}
    out.update({k: np.asarray(v) for k, v in m.channels.items()})
    out.update(dirty=np.asarray(m.dirty),
               mesh_pending=np.asarray(m.mesh_pending))
    return out


def _port_state(m):
    out = m.state_arrays()
    out["dirty"] = m.dirty.numpy()
    return out


def _color_agreement(got, want):
    """(painted by both, painted by one side only, max |color difference|
    on voxels both painted), over all pool rows (0-255 scale)."""
    pg, pw = got["color_weight"] > 0, want["color_weight"] > 0
    both = pg & pw
    diff = max(float(np.abs(got[c][both] - want[c][both]).max())
               for c in COLOR[:3])
    return int(both.sum()), int((pg ^ pw).sum()), diff


def test_replay_cadences_match_reference(rgbd, replayed):
    _, poses, _ = rgbd
    got, want = replayed["after"]["port"], replayed["after"]["jax"]
    for f in STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(want["alloc_count"]) > 500
    assert_tsdf_matches(got, want, poses, TCAM)
    for c in ESDF:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    for k in ("dirty", "mesh_pending"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert want["dirty"].any() and want["mesh_pending"].any()
    both, one_side, diff = _color_agreement(got, want)
    assert both > 5000
    assert diff <= 1e-4, diff
    # Voxels painted by one side only: at most 0.1% of the painted voxels
    # where both TSDFs agree bit for bit. Where the TSDFs differ in the last
    # bit (allowed above), a free-space voxel whose running average sits at
    # exactly the truncation distance may pass |d| <= truncation on one side
    # only; those are counted apart (PERF.md reports both counts).
    one = (got["color_weight"] > 0) ^ (want["color_weight"] > 0)
    tsdf_differs = ((got["tsdf_distance"] != want["tsdf_distance"])
                    | (got["tsdf_weight"] != want["tsdf_weight"]))
    assert (one & ~tsdf_differs).sum() <= 1e-3 * (both + one_side), \
        ((one & ~tsdf_differs).sum(), one_side, both)


def test_fused_and_standalone_color_paint_alike(rgbd):
    """The port's two color routes on one TSDF: the fused branch (depth
    frame's batch) and the standalone one (color frustum's batch) paint the
    same voxels with the same colors."""
    depths, poses, colors = rgbd
    fused, alone = _port_mapper(), _port_mapper()
    fused.replay_frames(depths[:8], poses[:8], TCAM, colors=colors[:8],
                        color_every=8)
    alone.replay_frames(depths[:7], poses[:7], TCAM)
    alone.integrate_depth(depths[7], poses[7], TCAM)
    alone.integrate_color(colors[7], poses[7], TCAM, depth=depths[7])
    a, b = fused.state_arrays(), alone.state_arrays()
    assert (a["color_weight"] > 0).sum() > 5000
    for k in ("tsdf_distance", "tsdf_weight") + COLOR:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mesh_dirty_update_matches_reference(replayed):
    j, t = replayed["j"], replayed["t"]
    vj, cj, mj, bj, sj = (np.asarray(a) for a in replayed["mesh_j"])
    vt, ct, mt, bt, st = replayed["mesh_t"]
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(t.dirty.numpy(), np.asarray(j.dirty))
    np.testing.assert_array_equal(t.mesh_pending.numpy(),
                                  np.asarray(j.mesh_pending))
    assert t.take_mesh_clear_keys() == j.take_mesh_clear_keys()
    # Bit-exact where the blocks' halo rows hold equal TSDF and colors.
    cap = t.capacity
    nbr8 = twg.neighbor_slots8_of(t.state, bt).numpy()
    rows = np.clip(nbr8, 0, cap - 1)
    a, b = replayed["after"]["port"], replayed["after"]["jax"]
    same = np.ones(len(sj), bool)
    for k in ("tsdf_distance", "tsdf_weight") + COLOR[:3]:
        same &= (a[k][rows] == b[k][rows]).all((1, 2))
    assert same.mean() > 0.9 and mt.numpy().any()
    for g, w in ((vt, vj), (ct, cj)):
        g = g.view(torch.int16).numpy()
        np.testing.assert_array_equal(g[same], w.view(np.int16)[same])
    np.testing.assert_array_equal(mt.numpy()[same], mj[same])


def test_export_mesh_matches_reference(replayed):
    j, t = replayed["j"], replayed["t"]
    vj, cj, tj = j.export_mesh()
    vt, ct, tt = t.export_mesh()
    assert tt.shape == tj.shape and vt.shape == vj.shape
    assert len(tt) > 1000
    np.testing.assert_allclose(np.sort(vt, 0), np.sort(vj, 0), atol=1e-5)
    assert not t.dirty.any() and not t.mesh_pending.any()


def test_integrate_color_unaligned_matches_reference(rgbd, replayed):
    """The standalone color entry point with an occlusion depth at half
    resolution, on the replayed maps."""
    depths, poses, colors = rgbd
    j = replayed["j"]
    t = _port_mapper()
    t.load_state_arrays(_jax_state(j))
    half = depths[3][::2, ::2].copy()
    j.use_pallas_integrate = False
    j.dirty = jnp.zeros_like(j.dirty)
    j.integrate_color(jnp.asarray(colors[3]), jnp.asarray(poses[3]), JCAM,
                      depth=jnp.asarray(half))
    t.integrate_color(colors[3], poses[3], TCAM, depth=half)
    got, want = _port_state(t), _jax_state(j)
    np.testing.assert_array_equal(got["dirty"], want["dirty"])
    assert want["dirty"].sum() > 100
    # Same map on both sides. The transform's last bit (ordered otherwise
    # by XLA in some programs) moves weights by an ulp: colors within 1e-4
    # (0-255) and weights within 1e-5 on all but 0.1% of painted voxels.
    bad = np.abs(got["color_weight"] - want["color_weight"]) > 1e-5
    for k in COLOR[:3]:
        bad |= np.abs(got[k] - want[k]) > 1e-4
    assert bad.sum() <= 1e-3 * (want["color_weight"] > 0).sum(), bad.sum()


def test_compact_dirty_matches_reference():
    """_compact_dirty_impl on a grid with blocks on every world face:
    candidates beyond the world edge drop; pending rows join unexpanded."""
    rng = np.random.RandomState(3)
    cfg = dict(dims=(6, 5, 4), capacity=160, origin_block=(-3, -2, 0))
    j = jwg.create_world_grid(jwg.WorldGridConfig(**cfg))
    grid = rng.rand(6, 5, 4) < 0.6
    j, _, _, _ = jwg.allocate_and_batch(j, jnp.asarray(grid),
                                        jnp.asarray([-3, -2, 0], np.int32),
                                        max_blocks=100)
    t = twg.WorldGridState.from_numpy(
        {f: np.asarray(getattr(j, f)) for f in STATE}, "cpu")
    n = int(j.alloc_count)
    for trial in range(3):
        dirty = np.zeros(160, bool)
        dirty[:n] = rng.rand(n) < 0.3
        extra = np.zeros(160, bool)
        extra[:n] = rng.rand(n) < 0.2
        for mb, ex in ((64, None), (16, extra), (200, extra)):
            want = jdm._compact_dirty(j, jnp.asarray(dirty), max_blocks=mb,
                                      extra=None if ex is None
                                      else jnp.asarray(ex))
            got = tdm._compact_dirty_impl(
                t, torch.from_numpy(dirty), max_blocks=mb,
                extra=None if ex is None else torch.from_numpy(ex))
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
