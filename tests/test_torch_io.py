"""The port's IO and host mesh helpers against the reference (CPU): the PLY
writers and the occupancy-grid files byte for byte, the slice combiners,
and the native library (compaction, weld, PLY) against its numpy versions
and the reference's binding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu import native as jnative
from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.io import occupancy_grid_io as jgrid
from isaac_ros_nvblox_tpu.io import ply as jply
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper.params import ProjectiveLayerType as JLayer
from isaac_ros_nvblox_tpu.ops import esdf_slicer as jslicer
from isaac_ros_nvblox_tpu_torch import native
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.io import occupancy_grid_io as tgrid
from isaac_ros_nvblox_tpu_torch.io import ply as tply
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper.params import ProjectiveLayerType
from isaac_ros_nvblox_tpu_torch.ops import esdf_slicer as tslicer

STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")


def _mesh(seed=0, n_verts=40, n_tris=60):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_verts, 3)).astype(np.float32),
            rng.integers(0, n_verts, (n_tris, 3)).astype(np.int32),
            rng.integers(0, 256, (n_verts, 3)).astype(np.uint8))


@pytest.mark.parametrize("with_color", [True, False])
def test_mesh_ply_bytes_match_reference(tmp_path, with_color):
    """The numpy writer and the native one write the reference's bytes."""
    v, t, c = _mesh()
    c = c if with_color else None
    jply.write_mesh_ply(tmp_path / "j.ply", v, t, c)
    tply.write_mesh_ply(tmp_path / "t.ply", v, t, c)
    native.write_mesh_ply(tmp_path / "n.ply", v, c, t)
    want = (tmp_path / "j.ply").read_bytes()
    assert (tmp_path / "t.ply").read_bytes() == want
    assert (tmp_path / "n.ply").read_bytes() == want
    assert (b"property uchar red" in want) == with_color


@pytest.mark.parametrize("with_intensity", [True, False])
def test_pointcloud_ply_bytes_match_reference(tmp_path, with_intensity):
    pts = np.random.default_rng(1).normal(size=(33, 3)).astype(np.float32)
    inten = np.arange(33, dtype=np.float32) if with_intensity else None
    jply.write_pointcloud_ply(tmp_path / "j.ply", pts, inten)
    tply.write_pointcloud_ply(tmp_path / "t.ply", pts, inten)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def _random_mappers(layer):
    """A port mapper and a reference mapper holding one random map: 40
    allocated slots, 5 of them freed, random channels."""
    world = dict(dims=(16, 16, 8), capacity=64, origin_block=(-8, -8, -2))
    occ = layer == "occupancy"
    t = tdm.DeviceMapper(
        0.05, world=twg.WorldGridConfig(**world), device="cpu",
        enable_color=False, enable_freespace=not occ,
        projective_layer=(ProjectiveLayerType.OCCUPANCY if occ else None))
    rng = np.random.default_rng(2)
    cells = rng.choice(16 * 16 * 8, 40, replace=False)
    bidx = np.stack(np.unravel_index(cells, (16, 16, 8)), 1) - [8, 8, 2]
    st = t.state
    st.block_index_of_slot[:40] = torch.from_numpy(bidx.astype(np.int32))
    st.block_index_of_slot[35:40] = twg.FREED_BLOCK_SENTINEL
    st.alloc_count.fill_(40)
    for name, ch in t.channels.items():
        if ch.dtype == torch.bool:
            ch.copy_(torch.from_numpy(rng.random(ch.shape) < 0.5))
        elif ch.dtype == torch.uint8:
            ch.copy_(torch.from_numpy((rng.random(ch.shape) < 0.5).astype(
                np.uint8)))
        elif name == "esdf_sq_dist":
            sq = rng.integers(0, 2000, ch.shape).astype(np.float32)
            sq[rng.random(ch.shape) < 0.1] = np.float32(1e12)
            ch.copy_(torch.from_numpy(sq))
        else:
            ch.copy_(torch.from_numpy(rng.normal(size=ch.shape).astype(
                np.float32)))
    j = jdm.DeviceMapper(0.05, world=jwg.WorldGridConfig(**world),
                         enable_color=False, enable_esdf=True,
                         enable_freespace=not occ,
                         projective_layer=JLayer(t.projective_layer.value))
    a = t.state_arrays()
    j.state = jwg.WorldGridState(**{f: jnp.asarray(a[f]) for f in STATE})
    assert sorted(j.channels) == sorted(t.channels)
    j.channels = {k: jnp.asarray(a[k]) for k in t.channels}
    return t, j


@pytest.mark.parametrize("layer,channel", [
    ("tsdf", "tsdf"), ("tsdf", "esdf"), ("tsdf", "freespace"),
    ("occupancy", "occupancy")])
def test_voxel_layer_ply_matches_reference(tmp_path, layer, channel):
    t, j = _random_mappers(layer)
    n_t = tply.write_voxel_layer_ply_device(tmp_path / "t.ply", t, channel)
    n_j = jply.write_voxel_layer_ply_device(tmp_path / "j.ply", j, channel)
    assert n_t == n_j > 1000
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    with pytest.raises(ValueError, match="unknown channel"):
        tply.write_voxel_layer_ply_device(tmp_path / "x.ply", t, "color")


def test_occupancy_grid_files_match_reference(tmp_path):
    rng = np.random.default_rng(4)
    grid = rng.choice(np.asarray([tslicer.OCC_UNKNOWN, tslicer.OCC_FREE,
                                  tslicer.OCC_OCCUPIED], np.int8), (23, 41))
    jgrid.save_occupancy_grid(tmp_path / "j", "map", grid, 0.05, -1.25, 2.5)
    tgrid.save_occupancy_grid(tmp_path / "t", "map", grid, 0.05, -1.25, 2.5)
    for f in ("map.png", "map.yaml"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


def test_slice_combiners_match_reference():
    rng = np.random.default_rng(5)
    unknown = 1000.0
    imgs = []
    for _ in range(3):
        img = rng.uniform(-1.0, 3.0, (17, 29)).astype(np.float32)
        img[rng.random(img.shape) < 0.4] = unknown
        imgs.append(img)
    got = tslicer.combine_distance_images(imgs, unknown)
    want = jslicer.combine_distance_images(imgs, unknown)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and (got == unknown).any()
    for thr in (0.2, 0.0, 1.5):
        g = tslicer.occupancy_grid_from_slice(got, thr, unknown)
        np.testing.assert_array_equal(
            g, jslicer.occupancy_grid_from_slice(got, thr, unknown))
        assert g.dtype == np.int8
    assert (tslicer.OCC_UNKNOWN, tslicer.OCC_FREE, tslicer.OCC_OCCUPIED) == (
        jslicer.OCC_UNKNOWN, jslicer.OCC_FREE, jslicer.OCC_OCCUPIED)


@pytest.mark.parametrize("with_color", [True, False])
def test_native_compaction_matches_plain_and_reference(with_color):
    """compact_mesh_blocks (native) equals its numpy version and the
    reference binding's output, bit for bit; so does compact_triangles."""
    rng = np.random.default_rng(6)
    N, K, V = 7, 16, 512
    verts = rng.random((N, 3, K, V)).astype(np.float32)
    cols = rng.random((N, 3, K, V)).astype(np.float32) if with_color else None
    mask = rng.random((N, K, V)) < 0.05
    mask[:, 15] = False
    mask[3] = False                     # an empty block
    got = native.compact_mesh_blocks(verts, cols, mask)
    plain = native.compact_mesh_blocks_plain(verts, cols, mask)
    ref = jnative.compact_mesh_blocks(verts, cols, mask)
    for g, p, r in zip(got, plain, ref):
        if r is None:
            assert g is None and p is None
            continue
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, r)
    assert got[0][4] == got[0][3] and got[0][-1] > 1000
    soup = rng.random((50, 3, 3)).astype(np.float32)
    soup_c = rng.random((50, 3, 3)).astype(np.float32)
    valid = rng.random(50) < 0.5
    for g, p in zip(native.compact_triangles(soup, soup_c, valid),
                    native.compact_triangles_plain(soup, soup_c, valid)):
        np.testing.assert_array_equal(g, p)


def test_native_weld_matches_plain_and_reference():
    """weld_mesh: the reference binding's output exactly; the numpy version
    welds the same mesh (the same triangles' vertices and colors, as many
    vertices), numbered in sorted-key order instead of first appearance."""
    rng = np.random.default_rng(7)
    base = rng.random((80, 3)).astype(np.float32)
    soup = base[rng.integers(0, 80, (120, 3))]
    colors = (rng.random((80, 3)) * 300.0 - 20.0).astype(np.float32)
    soup_c = colors[rng.integers(0, 80, (120, 3))]
    got = native.weld_mesh(soup, soup_c, 1e-4)
    for g, r in zip(got, jnative.weld_mesh(soup, soup_c, 1e-4)):
        np.testing.assert_array_equal(g, r)
    v, c, t = got
    pv, pc, pt = native.weld_mesh_plain(soup, soup_c, 1e-4)
    assert v.shape == pv.shape and v.shape[0] < 3 * 120
    np.testing.assert_array_equal(v[t], pv[pt])
    np.testing.assert_array_equal(c[t], pc[pt])
    np.testing.assert_array_equal(v[t], soup)


def test_native_library_builds_into_the_build_dir():
    path = native.library_path()
    assert path.parent.name == "torch_native"
    assert path.parent.parent.name == "build"
    native.library()
    assert path.exists()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build of the host library raises with the compiler's
    output: nothing falls back to the numpy versions."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="mesh_native: false failed"):
        native.weld_mesh(np.zeros((1, 3, 3), np.float32),
                         np.zeros((1, 3, 3), np.float32), 1e-4)
    assert not list((tmp_path / "build").glob("*.so"))
