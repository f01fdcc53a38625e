"""The host-table debug backend against the reference (CPU): block pool,
blocks_in_view, the iterative ESDF, marching cubes over dirty blocks, the
Mapper's every method, map files, and the table-based slicer, dense grid
and voxel-layer PLY. Both packages get the same inputs; each test compares
the port with the reference and repeats the reference test's own checks.

The reference's functions here run outside any Pallas kernel, so the port
runs the same functions in plain PyTorch; its depth step goes through the
tsdf_fuse wrapper, whose plain version (`ops/tsdf.py::integrate_tsdf`) is
held to the reference's `integrate_tsdf` on the Mapper's padded batches
with the rule of slices 1-4 (>= 99.9% of voxels within 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import block_pool as jbp
from isaac_ros_nvblox_tpu.core.types import (
    voxel_centers_for_blocks as jcenters)
from isaac_ros_nvblox_tpu.io import ply as jply
from isaac_ros_nvblox_tpu.io import serialization as jser
from isaac_ros_nvblox_tpu.mapper import mapper as jmapper
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import dense_grid as jdg
from isaac_ros_nvblox_tpu.ops import esdf as jesdf
from isaac_ros_nvblox_tpu.ops import esdf_slicer as jslicer
from isaac_ros_nvblox_tpu.ops import mesh as jmesh
from isaac_ros_nvblox_tpu.ops import occupancy as jocc
from isaac_ros_nvblox_tpu.ops import tsdf as jtsdf
from isaac_ros_nvblox_tpu.ops import view as jview
from isaac_ros_nvblox_tpu_torch.core import block_pool as tbp
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.core.types import (
    voxel_centers_for_blocks as tcenters)
from isaac_ros_nvblox_tpu_torch.io import ply as tply
from isaac_ros_nvblox_tpu_torch.io import serialization as tser
from isaac_ros_nvblox_tpu_torch.mapper import mapper as tmapper
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.models import scene as ts
from isaac_ros_nvblox_tpu_torch.ops import dense_grid as tdg
from isaac_ros_nvblox_tpu_torch.ops import esdf as tesdf
from isaac_ros_nvblox_tpu_torch.ops import esdf_slicer as tslicer
from isaac_ros_nvblox_tpu_torch.ops import mesh as tmesh
from isaac_ros_nvblox_tpu_torch.ops import occupancy as tocc
from isaac_ros_nvblox_tpu_torch.ops import view as tview
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda

torch.set_num_threads(2)

VOXEL = 0.05
CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
JCAM, TCAM = jc.Camera(**CAM_ARGS), tc.Camera(**CAM_ARGS)
TSDF_AGREE = 0.999


def _agree(got, want, tol=1e-5):
    return float((np.abs(np.asarray(got, np.float64)
                         - np.asarray(want, np.float64)) <= tol).mean())


@pytest.fixture(scope="module")
def frames():
    """Three orbit frames of the default scene with colors (reference
    renderer)."""
    scene = js.default_test_scene()
    out = []
    for k in range(3):
        T = js.orbit_pose(2 * np.pi * k / 8)
        out.append((np.array(js.render_depth(scene, JCAM, jnp.asarray(T))),
                    np.array(js.render_color(scene, JCAM, jnp.asarray(T))),
                    np.asarray(T, np.float32)))
    return out


def _mapper_pair(**kw):
    """A reference Mapper and a port Mapper (CPU) with 3 m views and a
    0.6 m ESDF."""
    def params(mod):
        return mod.MapperParams(
            projective=mod.TsdfIntegratorParams(max_integration_distance_m=3.0),
            occupancy=mod.OccupancyIntegratorParams(
                max_integration_distance_m=3.0),
            esdf=mod.EsdfIntegratorParams(max_esdf_distance_m=0.6))
    jkw, tkw = dict(kw), dict(kw)
    if "projective_layer" in kw:
        name = kw["projective_layer"]
        jkw["projective_layer"] = jp.ProjectiveLayerType(name)
        tkw["projective_layer"] = tp.ProjectiveLayerType(name)
    j = jmapper.Mapper(VOXEL, params=params(_JMods), **jkw)
    t = tmapper.Mapper(VOXEL, params=params(_TMods), device="cpu", **tkw)
    return j, t


class _JMods:
    MapperParams = jp.MapperParams
    TsdfIntegratorParams = jtsdf.TsdfIntegratorParams
    OccupancyIntegratorParams = jocc.OccupancyIntegratorParams
    EsdfIntegratorParams = jesdf.EsdfIntegratorParams


class _TMods:
    MapperParams = tp.MapperParams
    TsdfIntegratorParams = tp.TsdfIntegratorParams
    OccupancyIntegratorParams = tocc.OccupancyIntegratorParams
    EsdfIntegratorParams = tesdf.EsdfIntegratorParams


def _assert_same_maps(j, t, float_rule=("tsdf_distance", "tsdf_weight",
                                        "color_rgb", "color_weight")):
    assert t.table.num_allocated == j.table.num_allocated
    np.testing.assert_array_equal(t.table.block_indices, j.table.block_indices)
    np.testing.assert_array_equal(t.table.allocated, j.table.allocated)
    np.testing.assert_array_equal(t.table.neighbors, j.table.neighbors)
    assert t.pool.channels.keys() == j.pool.channels.keys()
    for k, ch in j.pool.channels.items():
        got, want = t.pool[k].numpy(), np.asarray(ch)
        assert got.dtype == want.dtype, k
        if k in float_rule:
            assert _agree(got, want) >= TSDF_AGREE, k
        else:
            np.testing.assert_array_equal(got, want, k)


# ------------------------------------------------- block pool (5 cases)
@pytest.mark.parametrize("mod", [tbp, jbp], ids=["port", "jax"])
def test_allocate_and_lookup(mod):
    t = mod.BlockTable(64)
    idx = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 0]], np.int32)
    slots, fresh = t.allocate(idx)
    assert slots[0] == slots[2]
    assert fresh.tolist() == [True, True, False]
    assert t.num_allocated == 2
    assert t.slot_of((1, 0, 0)) == slots[1]
    assert t.slot_of((9, 9, 9)) == -1


def test_neighbor_table_wiring_matches_reference():
    rng = np.random.default_rng(0)
    tables = (tbp.BlockTable(64), jbp.BlockTable(64))
    for step in range(6):
        idx = rng.integers(-2, 3, (12, 3)).astype(np.int32)
        outs = [t.allocate(idx) for t in tables]
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        gone = [tuple(k) for k in rng.integers(-2, 3, (4, 3)).tolist()]
        np.testing.assert_array_equal(*[t.free(gone) for t in tables])
        for f in ("neighbors", "allocated", "block_indices"):
            np.testing.assert_array_equal(getattr(tables[0], f),
                                          getattr(tables[1], f))
    t = tbp.BlockTable(64)
    (s0, s1), _ = t.allocate(np.array([[0, 0, 0], [1, 0, 0]], np.int32))
    assert t.neighbors[s0, tbp.SELF_NEIGHBOR_INDEX] == s0
    px = int(np.where((tbp.NEIGHBOR_OFFSETS == [1, 0, 0]).all(1))[0][0])
    mx = int(np.where((tbp.NEIGHBOR_OFFSETS == [-1, 0, 0]).all(1))[0][0])
    assert t.neighbors[s0, px] == s1 and t.neighbors[s1, mx] == s0
    t.free([(1, 0, 0)])
    assert t.neighbors[s0, px] == -1 and t.slot_of((1, 0, 0)) == -1
    (s1b,), _ = t.allocate(np.array([[1, 0, 0]], np.int32))
    assert t.neighbors[s0, px] == s1b


def test_pool_grow_preserves_contents():
    t = tbp.BlockTable(4)
    pool = tbp.BlockPool(t, {"d": ((), torch.float32),
                             "s": ((3,), torch.float32)},
                         init_values={"d": -7.0}, device="cpu")
    slots, _ = t.allocate(np.array([[0, 0, 0]], np.int32))
    pool["d"][slots[0], 0] = 3.5
    pool.ensure_capacity(needed_free=10)
    assert t.capacity >= 8 and pool["d"].shape == (t.capacity, 512)
    assert pool["s"].shape == (t.capacity, 512, 3)
    assert float(pool["d"][slots[0], 0]) == 3.5
    assert float(pool["d"][t.capacity - 1, 0]) == -7.0
    with pytest.raises(MemoryError):
        tbp.BlockTable(1).allocate(np.array([[0, 0, 0], [1, 0, 0]]))


def test_aabb_of_allocated_blocks():
    t = tbp.BlockTable(16)
    t.allocate(np.array([[0, 0, 0], [2, -1, 1]], np.int32))
    lo, hi = t.aabb_of_allocated_blocks(voxel_size_m=0.1)  # block size 0.8
    np.testing.assert_allclose(lo, [0.0, -0.8, 0.0])
    np.testing.assert_allclose(hi, [2.4, 0.8, 1.6])


def test_pad_to_bucket():
    for n in (0, 1, 64, 65, 1000, 5000):
        assert tbp.pad_to_bucket(n) == jbp.pad_to_bucket(n)
    assert tbp.pad_to_bucket(1000) == 1024


# ------------------------------------------------------- blocks_in_view
def test_blocks_in_view_cover_surface_and_match_reference():
    cam_args = dict(fx=200.0, fy=200.0, cx=119.5, cy=89.5, width=240,
                    height=180)
    T = js.orbit_pose(0.0)
    depth = np.array(js.render_depth(js.default_test_scene(),
                                     jc.Camera(**cam_args), jnp.asarray(T)))
    kw = dict(voxel_size_m=VOXEL, max_distance_m=7.0, truncation_m=0.2)
    want = jview.blocks_in_view(jnp.asarray(depth), jnp.asarray(T),
                                camera=jc.Camera(**cam_args), **kw)
    got = tview.blocks_in_view(torch.from_numpy(depth), torch.from_numpy(T),
                               camera=tc.Camera(**cam_args), **kw)
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 50
    cam_block = np.floor(T[:3, 3] / (8 * VOXEL)).astype(np.int32)
    assert any((got == cam_block).all(axis=1))
    for kind, lo, hi in (("height_bounds", (0, 0, 0.2), (0, 0, 1.0)),
                         ("bounding_box", (-1, -1, 0), (1.5, 1.0, 2.0))):
        vj = jview.ViewCalculatorParams(
            workspace_bounds_type=jview.WorkspaceBoundsType(kind),
            workspace_bounds_min_corner_m=lo,
            workspace_bounds_max_corner_m=hi)
        vt = tview.ViewCalculatorParams(
            workspace_bounds_type=tview.WorkspaceBoundsType(kind),
            workspace_bounds_min_corner_m=lo,
            workspace_bounds_max_corner_m=hi)
        kept = tview.apply_workspace_bounds(got, VOXEL, vt)
        np.testing.assert_array_equal(
            kept, jview.apply_workspace_bounds(want, VOXEL, vj))
        assert 0 < len(kept) < len(got)


def test_tsdf_wrapper_plain_equals_reference_on_padded_batches(frames):
    """The Mapper's depth step: integrate_tsdf_cuda's plain version on the
    Mapper's padded batches (slots padded with the capacity) against the
    reference's integrate_tsdf on the same batches."""
    j, t = _mapper_pair(enable_color=False, enable_esdf=False)
    for depth, _, T in frames:
        j.integrate_depth(depth, T, JCAM)
        p = t.params.projective
        slots_d, idx_d, slots = t._allocate_view(
            torch.from_numpy(depth), torch.from_numpy(T), TCAM,
            p.max_integration_distance_m, p.truncation_m(VOXEL))
        assert (slots_d[len(slots):] == t.table.capacity).all()
        assert len(slots_d) > len(slots)
        integrate_tsdf_cuda(t.pool["tsdf_distance"], t.pool["tsdf_weight"],
                            slots_d, idx_d, torch.from_numpy(depth),
                            torch.from_numpy(T), camera=TCAM,
                            voxel_size_m=VOXEL, params=p)
    _assert_same_maps(j, t)
    assert (t.pool["tsdf_weight"] > 0).sum() > 5000


# ----------------------------------------------------- iterative ESDF (3)
def _tsdf_pools(scene_j, scene_t, lo_m, hi_m, trunc=4 * VOXEL):
    bs = 8 * VOXEL
    lo = np.floor(np.asarray(lo_m) / bs).astype(int)
    hi = np.floor(np.asarray(hi_m) / bs).astype(int)
    idx = np.array([(x, y, z) for x in range(lo[0], hi[0] + 1)
                    for y in range(lo[1], hi[1] + 1)
                    for z in range(lo[2], hi[2] + 1)], np.int32)
    out = []
    for mod, torch_side in ((jbp, False), (tbp, True)):
        table = mod.BlockTable(len(idx) + 8)
        dt = torch if torch_side else jnp
        specs = {"tsdf_distance": ((), dt.float32),
                 "tsdf_weight": ((), dt.float32),
                 "esdf_site": ((3,), dt.float32),
                 "esdf_sq_dist": ((), dt.float32),
                 "esdf_is_site": ((), dt.bool if torch_side else jnp.bool_),
                 "esdf_is_inside": ((), dt.bool if torch_side else jnp.bool_),
                 "esdf_observed": ((), dt.bool if torch_side else jnp.bool_)}
        init = {"esdf_sq_dist": float(jesdf.INF_SQ)}
        pool = (mod.BlockPool(table, specs, init, device="cpu") if torch_side
                else mod.BlockPool(table, specs, init))
        slots, _ = table.allocate(idx)
        out.append((table, pool, slots))
    # The analytic TSDF from the reference scene, into both pools.
    sdf = np.clip(np.asarray(scene_j.sdf(jcenters(jnp.asarray(idx), VOXEL))),
                  -trunc, trunc)
    (jt, jpool, jslots), (tt, tpool, tslots) = out
    jpool["tsdf_distance"] = jpool["tsdf_distance"].at[
        jnp.asarray(jslots)].set(jnp.asarray(sdf))
    jpool["tsdf_weight"] = jpool["tsdf_weight"].at[jnp.asarray(jslots)].set(1.0)
    tpool["tsdf_distance"][torch.from_numpy(tslots).long()] = \
        torch.from_numpy(sdf)
    tpool["tsdf_weight"][torch.from_numpy(tslots).long()] = 1.0
    return out, idx


@pytest.mark.parametrize("case", ["analytic", "across_blocks", "clamp"])
def test_esdf_matches_reference_and_analytic(case):
    radius, center, hi_m, max_d = {
        "analytic": (0.3, (0.8, 0.8, 0.8), (1.6, 1.6, 1.6), 2.0),
        "across_blocks": (0.2, (0.2, 0.2, 0.2), (2.4, 0.4, 0.4), 3.0),
        "clamp": (0.1, (0.2, 0.2, 0.2), (2.4, 0.4, 0.4), 0.5)}[case]
    scene_j = js.Scene(primitives=(js.Sphere(center=center, radius=radius),))
    scene_t = ts.Scene(primitives=(ts.Sphere(center=center, radius=radius),))
    ((jt, jpool, slots), (tt, tpool, _)), idx = _tsdf_pools(
        scene_j, scene_t, (0.0, 0.0, 0.0), hi_m)
    it_j = jesdf.update_esdf(jpool, jt, voxel_size_m=VOXEL,
                             params=jesdf.EsdfIntegratorParams(
                                 max_esdf_distance_m=max_d))
    it_t = tesdf.update_esdf(tpool, tt, voxel_size_m=VOXEL,
                             params=tesdf.EsdfIntegratorParams(
                                 max_esdf_distance_m=max_d))
    assert it_t == it_j and 1 <= it_t <= 16
    for k in ("esdf_site", "esdf_sq_dist", "esdf_is_site", "esdf_is_inside",
              "esdf_observed"):
        np.testing.assert_array_equal(tpool[k].numpy(), np.asarray(jpool[k]),
                                      k)
    est = tesdf.esdf_distance_m(tpool, VOXEL, max_d).numpy()[slots]
    np.testing.assert_array_equal(
        est, np.asarray(jesdf.esdf_distance_m(jpool, VOXEL, max_d))[slots])
    centers = tcenters(torch.from_numpy(idx), VOXEL)
    gt = scene_t.sdf(centers).numpy()
    if case == "analytic":
        m = (gt > 3 * VOXEL) & (gt < 0.5)
        err = np.abs(est[m] - gt[m])
        assert np.median(err) < VOXEL and err.max() < 2.5 * VOXEL
        inside = gt < -2 * VOXEL
        assert inside.sum() > 50 and (est[inside] < 0).mean() > 0.95
    elif case == "across_blocks":
        far = (centers[..., 0].numpy() > 1.5) & (np.abs(gt) < 2.5)
        assert far.sum() > 100
        err = np.abs(est[far] - gt[far])
        assert np.median(err) < VOXEL and err.max() < 3 * VOXEL
    else:
        assert est.max() <= 0.5 + 1e-5


# ------------------------------------------------ marching cubes (Mapper)
def _sphere_layers(radius=0.4, center=(0.33, 0.21, 0.17)):
    scene_j = js.Scene(primitives=(js.Sphere(center=center, radius=radius),))
    scene_t = ts.Scene(primitives=(ts.Sphere(center=center, radius=radius),))
    (jside, tside), _ = _tsdf_pools(
        scene_j, scene_t, np.asarray(center) - radius - 4 * VOXEL,
        np.asarray(center) + radius + 4 * VOXEL)
    layers = []
    for mod, (table, pool, slots) in ((jmesh, jside), (tmesh, tside)):
        layer = mod.MeshLayer(VOXEL)
        mod.mesh_dirty_blocks(layer, pool, table, slots)
        layers.append(layer)
    return scene_t, layers


def test_sphere_mesh_matches_reference_on_surface_and_watertight():
    radius = 0.4
    scene, (jl, tl) = _sphere_layers(radius)
    assert tl.blocks.keys() == jl.blocks.keys()
    for k, b in jl.blocks.items():
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(tl.blocks[k], f),
                                          getattr(b, f), f)
    verts, _, tris = tl.as_arrays()
    assert tris.shape[0] > 100
    assert np.abs(scene.sdf(torch.from_numpy(verts)).numpy()).max() \
        < 0.35 * VOXEL
    q = np.round(verts / VOXEL * 1024.0).astype(np.int64)
    _, first, inv = np.unique(q, axis=0, return_index=True,
                              return_inverse=True)
    tris_g = inv.reshape(-1)[tris]
    v = verts[first]
    p0, p1, p2 = v[tris_g[:, 0]], v[tris_g[:, 1]], v[tris_g[:, 2]]
    signed_vol = np.sum(np.einsum("ij,ij->i", p0, np.cross(p1, p2))) / 6.0
    assert signed_vol > 0
    np.testing.assert_allclose(signed_vol, 4.0 / 3.0 * np.pi * radius ** 3,
                               rtol=0.05)
    edges = {}
    for t in tris_g:
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            edges[(a, b)] = edges.get((a, b), 0) + 1
    assert all(c == 1 and edges.get((b, a), 0) == 1
               for (a, b), c in edges.items())


def test_mesh_updates_are_incremental():
    _, (_, layer) = _sphere_layers()
    assert len(layer.blocks) > 4
    total = sum(b.triangles.shape[0] for b in layer.blocks.values())
    assert layer.as_arrays()[2].shape[0] == total
    key = next(iter(layer.blocks))
    removed = layer.blocks[key].triangles.shape[0]
    layer.remove_blocks([key])
    assert layer.as_arrays()[2].shape[0] == total - removed


# ---------------------------------------------------------------- Mapper
@pytest.fixture(scope="module")
def fused(frames):
    """Both Mappers after depth + color of the three frames, the ESDF and a
    mesh update."""
    j, t = _mapper_pair(enable_freespace=True)
    for depth, color, T in frames:
        assert t.integrate_depth(depth, T, TCAM) == \
            j.integrate_depth(depth, T, JCAM)
        assert t.integrate_color(color, T, TCAM, depth=depth) == \
            j.integrate_color(color, T, JCAM, depth=depth)
    assert t.update_esdf() == j.update_esdf()
    assert t.update_mesh() == j.update_mesh()
    return j, t


def test_mapper_integrate_esdf_mesh_match_reference(fused):
    j, t = fused
    assert t.table.num_allocated > 300
    _assert_same_maps(j, t)
    assert t.last_meshed_keys == j.last_meshed_keys
    # The same triangles; vertices within 1e-5 m (a TSDF voxel that differs
    # in the last bit moves its vertex by as much; the marching cubes
    # alone are held bit for bit above).
    assert t.mesh_layer.blocks.keys() == j.mesh_layer.blocks.keys()
    for k, b in j.mesh_layer.blocks.items():
        got = t.mesh_layer.blocks[k]
        np.testing.assert_array_equal(got.triangles, b.triangles)
        np.testing.assert_allclose(got.vertices, b.vertices, atol=1e-5)
        assert np.abs(got.colors.astype(int) - b.colors).max() <= 1
    assert (t.pool["color_weight"] > 0).sum() > 5000
    assert (t.pool["esdf_sq_dist"] == 0).any()


def _copy_pair(fused, tmp_path):
    """Fresh Mapper pairs holding the fused map (through the map files)."""
    j0, t0 = fused
    jser.save_map(j0, tmp_path / "m.nvblx")
    j, t = _mapper_pair(enable_freespace=True)
    jser.load_map(j, tmp_path / "m.nvblx")
    tser.load_map(t, tmp_path / "m.nvblx")
    for a, b in ((j, j0), (t, t0)):
        a.last_depth_T_L_C, a.last_depth_camera = (b.last_depth_T_L_C,
                                                   b.last_depth_camera)
    return j, t


def test_mapper_decay_clear_and_freespace_match_reference(fused, tmp_path,
                                                          frames):
    j, t = _copy_pair(fused, tmp_path)
    _assert_same_maps(j, t)
    for _ in range(3):
        assert t.decay_tsdf() == j.decay_tsdf()
    t.update_freespace(100.0)
    j.update_freespace(100.0)
    t.update_freespace(400.0)
    j.update_freespace(400.0)
    _assert_same_maps(j, t)
    spheres, aabbs = [((1.5, 1.0, 1.0), 0.4)], [((-2.4, -2.0, 0.0),
                                                 (-1.6, -1.0, 1.0))]
    t.clear_tsdf_inside_shapes(spheres, aabbs)
    j.clear_tsdf_inside_shapes(spheres, aabbs)
    n = t.clear_outside_radius((1.0, 0.5, 1.0), 2.0)
    assert n == j.clear_outside_radius((1.0, 0.5, 1.0), 2.0) > 0
    _assert_same_maps(j, t)
    assert t.update_mesh() == j.update_mesh()
    assert t.mesh_layer.blocks.keys() == j.mesh_layer.blocks.keys()
    assert (t.pool["freespace_consecutive_ms"] > 0).any()


def test_occupancy_mapper_matches_reference(frames):
    j, t = _mapper_pair(projective_layer="occupancy", enable_color=False,
                        capacity=4096)
    for depth, color, T in frames:
        t.integrate_depth(depth, T, TCAM)
        j.integrate_depth(depth, T, JCAM)
        assert t.integrate_color(color, T, TCAM) == 0
    assert t.update_esdf() == j.update_esdf()
    _assert_same_maps(j, t, float_rule=())
    assert (t.pool["esdf_sq_dist"] == 0).any()
    for _ in range(2):
        assert t.decay_occupancy() == j.decay_occupancy()
    _assert_same_maps(j, t, float_rule=())
    assert t.update_mesh() == 0


# -------------------------------------------------------------- map files
def test_save_load_map_roundtrip(tmp_path):
    m1 = tmapper.Mapper(voxel_size_m=0.05, capacity=64, device="cpu")
    idx = np.asarray([[0, 0, 0], [1, 2, 3]], np.int32)
    slots, _ = m1.table.allocate(idx)
    m1.pool["tsdf_distance"][slots[0], 7] = 0.33
    m1.pool["tsdf_weight"][slots[0], 7] = 2.0
    p = tmp_path / "map.nvblx"
    tser.save_map(m1, p)
    assert p.exists()
    m2 = tmapper.Mapper(voxel_size_m=0.05, capacity=64, device="cpu")
    assert tser.load_map(m2, p) == 2
    s = m2.table.slot_of((0, 0, 0))
    assert s >= 0
    assert float(m2.pool["tsdf_distance"][s, 7]) == pytest.approx(0.33)
    assert m2.table.slot_of((1, 2, 3)) >= 0


def test_load_map_rejects_mismatched_voxel_size_and_channels(tmp_path):
    p = tmp_path / "map.nvblx"
    tser.save_map(tmapper.Mapper(voxel_size_m=0.05, capacity=16,
                                 device="cpu"), p)
    assert p.exists()
    with pytest.raises(ValueError, match="voxel size"):
        tser.load_map(tmapper.Mapper(voxel_size_m=0.1, capacity=16,
                                     device="cpu"), p)
    with pytest.raises(ValueError, match="lacks channels"):
        tser.load_map(tmapper.Mapper(voxel_size_m=0.05, capacity=16,
                                     enable_color=False, device="cpu"), p)


def test_map_files_cross_load(fused, tmp_path):
    """A map saved by either package loads in the other: the same blocks
    and channels; the two files hold the same arrays and header."""
    j0, t0 = fused
    tser.save_map(t0, tmp_path / "port.nvblx")
    jser.save_map(j0, tmp_path / "jax.nvblx")
    with np.load(tmp_path / "port.nvblx") as a, \
            np.load(tmp_path / "jax.nvblx") as b:
        assert sorted(a.files) == sorted(b.files)
        assert bytes(a["meta_json"]) == bytes(b["meta_json"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
    j, t = _mapper_pair(enable_freespace=True, capacity=256)
    # The small capacity grows on load.
    assert jser.load_map(j, tmp_path / "port.nvblx") == \
        tser.load_map(t, tmp_path / "jax.nvblx") == t0.table.num_allocated
    assert t.table.capacity > 256
    _assert_same_maps(j, t)
    # The loaded blocks take slots 0..n-1 in the saved (slot) order.
    n, saved = t.table.num_allocated, j0.table.allocated_slots()
    np.testing.assert_array_equal(t.table.block_indices[:n],
                                  j0.table.block_indices[saved])
    for k, ch in j0.pool.channels.items():
        np.testing.assert_array_equal(t.pool[k][:n].numpy(),
                                      np.asarray(ch)[saved], k)


# -------------------------------------- slicer, dense grid, voxel-layer PLY
def test_slicer_dense_grid_and_voxel_ply_match_reference(fused, tmp_path):
    """On one map (the reference's, loaded into the port through its map
    file), the port's slices, dense grid and voxel-layer PLYs equal the
    reference's bit for bit."""
    j, _ = fused
    jser.save_map(j, tmp_path / "j.nvblx")
    _, t = _mapper_pair(enable_freespace=True)
    tser.load_map(t, tmp_path / "j.nvblx")
    for h in (0.3, 1.0):
        kw = dict(voxel_size_m=VOXEL, slice_height_m=h, max_distance_m=0.6)
        spec_t, img_t = tslicer.slice_esdf_layer(t.pool, t.table, **kw)
        spec_j, img_j = jslicer.slice_esdf_layer(j.pool, j.table, **kw)
        assert spec_t == tslicer.SliceSpec(**vars(spec_j))
        np.testing.assert_array_equal(
            tslicer.build_slot_image(t.table, spec_t),
            jslicer.build_slot_image(j.table, spec_j))
        np.testing.assert_array_equal(img_t, img_j)
        assert (img_t < 1000.0).mean() > 0.1
    assert tslicer.compute_slice_spec(tbp.BlockTable(4), VOXEL, 0.3) is None
    lo, hi = (-0.5, -0.4, 0.2), (0.6, 0.5, 1.3)
    got = tdg.esdf_and_gradients(t, lo, hi)
    want = jdg.esdf_and_gradients(j, lo, hi)
    assert got.origin_m == want.origin_m
    np.testing.assert_array_equal(got.esdf, np.asarray(want.esdf))
    np.testing.assert_array_equal(got.gradients, np.asarray(want.gradients))
    for a, b in zip(tdg.dense_voxel_lookup(t.table, lo, hi, VOXEL),
                    jdg.dense_voxel_lookup(j.table, lo, hi, VOXEL)):
        np.testing.assert_array_equal(a, b)
    for layer in ("tsdf", "esdf", "freespace"):
        n_t = tply.write_voxel_layer_ply(tmp_path / f"t_{layer}.ply", t,
                                         layer)
        n_j = jply.write_voxel_layer_ply(tmp_path / f"j_{layer}.ply", j,
                                         layer)
        assert n_t == n_j > 0
        assert (tmp_path / f"t_{layer}.ply").read_bytes() == \
            (tmp_path / f"j_{layer}.ply").read_bytes()


# -------------------------------- DeviceMapper vs Mapper (world_grid:145)
def test_device_mapper_matches_host_mapper_tsdf(frames):
    """The DeviceMapper and the host-table Mapper of the port fuse the same
    TSDF into the same blocks, as the reference's pair does."""
    host = tmapper.Mapper(voxel_size_m=VOXEL, capacity=8192,
                          enable_color=False, enable_esdf=False,
                          device="cpu")
    dev = DeviceMapper(voxel_size_m=VOXEL,
                       world=twg.WorldGridConfig(dims=(64, 64, 32),
                                                 capacity=8192,
                                                 origin_block=(-32, -32, -8)),
                       enable_color=False, device="cpu")
    jhost = jmapper.Mapper(voxel_size_m=VOXEL, capacity=8192,
                           enable_color=False, enable_esdf=False)
    for depth, _, T in frames:
        host.integrate_depth(depth, T, TCAM)
        dev.integrate_depth(depth, T, TCAM)
        jhost.integrate_depth(depth, T, JCAM)
    n = dev.block_count()
    assert n == host.table.num_allocated == jhost.table.num_allocated
    bidx = dev.state.block_index_of_slot[:n].numpy()
    slots = np.asarray([host.table.slot_of(tuple(b)) for b in bidx])
    assert (slots >= 0).all()
    for k in ("tsdf_distance", "tsdf_weight"):
        np.testing.assert_allclose(dev.channels[k][:n].numpy(),
                                   host.pool[k].numpy()[slots], atol=1e-5,
                                   err_msg=k)
    _assert_same_maps(jhost, host)
