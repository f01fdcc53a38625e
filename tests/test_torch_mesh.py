"""Port vs reference: mesh tables, halo gathering, marching cubes (the plain
version of the marching_cubes kernel against the reference's Pallas kernel
in interpret mode, and the full-map XLA mirror), soup resolution, the mesh
layer and its weld; the plain version of the mesh_compact kernel against
the host CSR it replaces (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core.block_pool import NEIGHBOR_OFFSETS as J_NBR
from isaac_ros_nvblox_tpu.core.types import voxel_centers_for_blocks
from isaac_ros_nvblox_tpu.models.scene import Scene, Sphere
from isaac_ros_nvblox_tpu.ops import halo as jhalo
from isaac_ros_nvblox_tpu.ops import mesh as jmesh
from isaac_ros_nvblox_tpu.ops import mesh_pallas as jmp
from isaac_ros_nvblox_tpu.ops import mesh_tables as jtab
from isaac_ros_nvblox_tpu_torch import native
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.ops import halo as thalo
from isaac_ros_nvblox_tpu_torch.ops import mesh as tmesh
from isaac_ros_nvblox_tpu_torch.ops import mesh_cuda as tmc
from isaac_ros_nvblox_tpu_torch.ops import mesh_tables as ttab

torch.set_num_threads(2)

VOXEL = 0.05


def test_mesh_tables_equal_reference():
    for a, b in zip(ttab.build_tables(), jtab.build_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttab.CORNERS, jtab.CORNERS)
    assert ttab.EDGES == jtab.EDGES and ttab.FACES == jtab.FACES
    assert ttab.MAX_TRIS_PER_CUBE == jtab.MAX_TRIS_PER_CUBE
    np.testing.assert_array_equal(twg.NEIGHBOR_OFFSETS, np.asarray(J_NBR))
    assert tmc.NEIGHBOR_COLS == list(jmp.NEIGHBOR_COLS)
    np.testing.assert_array_equal(twg.OCTANT_OFFSETS, np.asarray(jmp._DIRS))


def _sphere_pool(seed=0, radius=0.35, center=(0.31, 0.29, 0.27)):
    """Blocks around a sphere with its clipped SDF (weights mostly 1, some
    below the mesh threshold), planar colors, and each block's 27
    neighbour slots."""
    rng = np.random.RandomState(seed)
    bs = 8 * VOXEL
    lo = np.floor((np.asarray(center) - radius - 4 * VOXEL) / bs).astype(int)
    hi = np.floor((np.asarray(center) + radius + 4 * VOXEL) / bs).astype(int)
    idx = np.array([(x, y, z) for x in range(lo[0], hi[0] + 1)
                    for y in range(lo[1], hi[1] + 1)
                    for z in range(lo[2], hi[2] + 1)], np.int32)
    n = len(idx)
    cap = n + 8
    scene = Scene(primitives=(Sphere(center=center, radius=radius),))
    centers = np.asarray(voxel_centers_for_blocks(jnp.asarray(idx), VOXEL))
    d = np.zeros((cap, 512), np.float32)
    w = np.zeros((cap, 512), np.float32)
    d[:n] = np.clip(np.asarray(scene.sdf(jnp.asarray(centers))), -0.2, 0.2)
    w[:n] = np.where(rng.rand(n, 512) < 0.05, 1e-5, 1.0)
    d[n:] = rng.uniform(-0.1, 0.1, (8, 512))     # rows no block points at
    col = (centers.sum(-1) * 40.0) % 255.0
    colors = [np.zeros((cap, 512), np.float32) for _ in range(3)]
    for ch in range(3):
        colors[ch][:n] = (col + 30.0 * ch) % 255.0
    slot_of = {tuple(b): s for s, b in enumerate(idx.tolist())}
    nbrs = np.array([[slot_of.get(tuple(b + o), -1) for o in J_NBR.tolist()]
                     for b in idx], np.int32)
    return idx, d, w, colors, nbrs


def _mc_both(d, w, colors, nbr8, valid, with_color):
    j = jmp.marching_cubes_fused(
        jnp.asarray(d), jnp.asarray(w),
        tuple(jnp.asarray(c) for c in colors) if with_color else None,
        jnp.asarray(nbr8), jnp.asarray(valid), min_weight=1e-4,
        with_color=with_color, interpret=True)
    t = tmc.marching_cubes_fused(
        torch.from_numpy(d), torch.from_numpy(w),
        tuple(torch.from_numpy(c) for c in colors) if with_color else None,
        torch.from_numpy(nbr8), torch.from_numpy(valid), min_weight=1e-4,
        with_color=with_color)
    return j, t


def _bits(x):
    return x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).view(np.int16)


def _assert_mc_equal(j, t, live):
    """All three bf16 outputs bit-exact on live blocks; tables everywhere.
    Blocks without a crossing are sentinel in the port; the reference
    writes their vertex planes only when another block of its 8-block
    program is live, and always a zero table."""
    for k, (a, b) in enumerate(zip(j, t)):
        if a is None:
            assert b is None
            continue
        a, b = _bits(a), _bits(b)
        np.testing.assert_array_equal(b[live], a[live], err_msg=str(k))
        if k == 2:
            np.testing.assert_array_equal(b, a)
    verts = t[0].to(torch.float32).numpy()
    assert (verts[~live] == -1.0).all()
    assert (t[2].to(torch.float32).numpy()[~live] == 0.0).all()


def test_kernel_lut_layout():
    """The marching_cubes kernel's table: per config the count and 15 edge
    ids of the reference's tables, the edges' corner pairs, zero padding
    to whole 16-byte words."""
    lut = tmc.kernel_lut()
    tri_table, tri_counts, _, _ = jtab.build_tables()
    assert lut.dtype == np.int8 and lut.size % 16 == 0
    per_config = lut[:256 * 16].reshape(256, 16)
    np.testing.assert_array_equal(per_config[:, 0], tri_counts)
    np.testing.assert_array_equal(per_config[:, 1:], tri_table)
    edges = np.asarray(jtab.EDGES)
    np.testing.assert_array_equal(lut[4096:4108], edges[:, 0])
    np.testing.assert_array_equal(lut[4108:4120], edges[:, 1])
    assert not lut[4120:].any()


@pytest.mark.parametrize("with_color", [True, False])
def test_mc_plain_matches_pallas(with_color):
    idx, d, w, colors, nbrs = _sphere_pool()
    nbr8 = nbrs[:, tmc.NEIGHBOR_COLS]
    valid = np.ones((len(idx),), np.int32)
    valid[3] = 0                              # a padding row
    j, t = _mc_both(d, w, colors, nbr8, valid, with_color)
    live = tmc.surface_crossing(torch.from_numpy(d), torch.from_numpy(w),
                                torch.from_numpy(nbr8),
                                min_weight=1e-4).numpy() & (valid > 0)
    assert 10 < live.sum() < len(idx)
    _assert_mc_equal(j, t, live)
    counts = t[2][:, 0].to(torch.float32).numpy()
    assert counts.sum() > 500


def test_mc_plain_absent_neighbours():
    """Rows with absent neighbours (nbr8 = -1) read weight 0 there: the
    cubes needing them emit nothing, bit for bit as the reference."""
    idx, d, w, colors, nbrs = _sphere_pool(seed=1)
    rng = np.random.RandomState(2)
    nbr8 = nbrs[:, tmc.NEIGHBOR_COLS].copy()
    drop = rng.rand(*nbr8.shape) < 0.3
    drop[:, 0] = False
    nbr8[drop] = -1
    lone = len(idx) // 2
    nbr8[lone, 1:] = -1
    valid = np.ones((len(idx),), np.int32)
    j, t = _mc_both(d, w, colors, nbr8, valid, True)
    live = tmc.surface_crossing(torch.from_numpy(d), torch.from_numpy(w),
                                torch.from_numpy(nbr8),
                                min_weight=1e-4).numpy()
    _assert_mc_equal(j, t, live)
    verts, _ = tmc.resolve_edge_soup(t[0], t[1], t[2])
    mask = verts[lone, 0].to(torch.float32).numpy() >= 0
    lanes = np.arange(512)
    edge = ((lanes // 64) == 7) | (((lanes // 8) % 8) == 7) | ((lanes % 8) == 7)
    assert not mask[:, edge].any()


def test_surface_crossing_matches_reference():
    idx, d, w, _, nbrs = _sphere_pool(seed=3)
    nbr8 = nbrs[:, tmc.NEIGHBOR_COLS]
    nbr8[::5, 2] = -1
    for mw in (1e-4, 0.5):
        want = np.asarray(jmp.surface_crossing(
            jnp.asarray(d), jnp.asarray(w), jnp.asarray(nbr8), min_weight=mw))
        got = tmc.surface_crossing(torch.from_numpy(d), torch.from_numpy(w),
                                   torch.from_numpy(nbr8), min_weight=mw)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any() and not want.all()


def test_soup_and_world_verts_match_reference():
    """resolve_edge_soup + local_to_world_verts: exact against the
    reference's functions on the same kernel outputs; against the XLA
    marching_cubes_blocks within the bf16 quantization."""
    idx, d, w, colors, nbrs = _sphere_pool(seed=4)
    nbr8 = nbrs[:, tmc.NEIGHBOR_COLS]
    valid = np.ones((len(idx),), np.int32)
    _, t = _mc_both(d, w, colors, nbr8, valid, True)
    vj, cj = jmp.resolve_edge_soup(
        jnp.asarray(t[0].to(torch.float32).numpy()).astype(jnp.bfloat16),
        jnp.asarray(t[1].to(torch.float32).numpy()).astype(jnp.bfloat16),
        jnp.asarray(t[2].to(torch.float32).numpy()).astype(jnp.bfloat16),
        with_color=True)
    vt, ct = tmc.resolve_edge_soup(*t, with_color=True)
    np.testing.assert_array_equal(_bits(vt), _bits(vj))
    np.testing.assert_array_equal(_bits(ct), _bits(cj))
    world_j, mask_j = jmp.local_to_world_verts(vj, jnp.asarray(idx), VOXEL)
    world_t, mask_t = tmc.local_to_world_verts(vt, torch.from_numpy(idx),
                                               VOXEL)
    np.testing.assert_array_equal(world_t.numpy(), np.asarray(world_j))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))

    # Against the full-map XLA mirror (tests/test_mesh_pallas.py:86-95).
    cap = d.shape[0]
    color_grid = np.stack(colors, -1).reshape(cap, 8, 8, 8, 3)
    v_ref, c_ref, valid_ref = (np.asarray(a) for a in jmesh.marching_cubes_blocks(
        jnp.asarray(d.reshape(cap, 8, 8, 8)),
        jnp.asarray(w.reshape(cap, 8, 8, 8)), jnp.asarray(color_grid),
        jnp.asarray(nbrs), jnp.asarray(idx), voxel_size_m=VOXEL,
        min_weight=1e-4))
    world = world_t.numpy()
    N = world.shape[0]
    pts = np.stack([world[:, 0], world[:, 1], world[:, 2]], -1)
    pts = pts.transpose(0, 2, 1, 3)[:, :, :15]              # [N, 512, 15, 3]
    tri_valid = mask_t.numpy().transpose(0, 2, 1)[:, :, :15][..., 0::3]
    np.testing.assert_array_equal(tri_valid, valid_ref)
    assert valid_ref.sum() > 100
    np.testing.assert_allclose(pts.reshape(N, 512, 5, 3, 3)[valid_ref],
                               v_ref[valid_ref], atol=2 ** -8 * 9 * VOXEL)
    cols = ct.to(torch.float32).numpy()
    cols = np.stack([cols[:, 0], cols[:, 1], cols[:, 2]], -1)
    cols = cols.transpose(0, 2, 1, 3)[:, :, :15].reshape(N, 512, 5, 3, 3)
    np.testing.assert_allclose(cols[valid_ref], c_ref[valid_ref], atol=1.5)


def test_marching_cubes_blocks_and_halo_match_reference():
    idx, d, w, colors, nbrs = _sphere_pool(seed=5)
    cap = d.shape[0]
    nbrs = nbrs.copy()
    nbrs[::4, 22] = -1
    grid_j = [jnp.asarray(a.reshape(cap, 8, 8, 8)) for a in (d, w)]
    grid_t = [torch.from_numpy(a.reshape(cap, 8, 8, 8)) for a in (d, w)]
    cg = np.stack(colors, -1).reshape(cap, 8, 8, 8, 3)
    for lo, hi in ((0, 1), (1, 1), (1, 0)):
        np.testing.assert_array_equal(
            thalo.gather_halo(torch.from_numpy(cg), torch.from_numpy(nbrs),
                              lo=lo, hi=hi, fill=0.5).numpy(),
            np.asarray(jhalo.gather_halo(jnp.asarray(cg), jnp.asarray(nbrs),
                                         lo=lo, hi=hi, fill=0.5)))
    want = jmesh.marching_cubes_blocks(
        *grid_j, jnp.asarray(cg), jnp.asarray(nbrs), jnp.asarray(idx),
        voxel_size_m=VOXEL, min_weight=1e-4)
    got = tmesh.marching_cubes_blocks(
        *grid_t, torch.from_numpy(cg), torch.from_numpy(nbrs),
        torch.from_numpy(idx), voxel_size_m=VOXEL, min_weight=1e-4)
    vj, cj, mj = (np.asarray(a) for a in want)
    vt, ct, mt = (a.numpy() for a in got)
    np.testing.assert_array_equal(mt, mj)
    assert mj.sum() > 100
    np.testing.assert_allclose(vt[mj], vj[mj], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct[mj], cj[mj], rtol=0, atol=1e-3)

    # The host mesh layer: same welded vertex and triangle counts.
    layers = (jmesh.MeshLayer(VOXEL), tmesh.MeshLayer(VOXEL))
    for i in range(len(idx)):
        m = mj[i].reshape(-1)
        layers[0].update_block(tuple(idx[i]), vj[i].reshape(-1, 3, 3)[m],
                               cj[i].reshape(-1, 3, 3)[m])
        layers[1].update_block(tuple(idx[i]), vt[i].reshape(-1, 3, 3)[m],
                               ct[i].reshape(-1, 3, 3)[m])
    (v_a, c_a, t_a), (v_b, c_b, t_b) = (lay.as_arrays() for lay in layers)
    assert t_b.shape == t_a.shape and v_b.shape == v_a.shape
    assert len(v_b) < 3 * len(t_b) / 2            # welded
    np.testing.assert_allclose(np.sort(v_b, 0), np.sort(v_a, 0), atol=1e-5)
    np.testing.assert_allclose(v_b[t_b], v_a[t_a], atol=1e-5)


def _compact_soup(case, n=12, seed=11):
    """A bf16 soup `[n, 3, 16, 512]` for `case` (vertices in [0, 8) where
    live, the sentinel elsewhere; a few -0.0 and 0.0 vertices, live),
    colors or None, block indices and the live rows' count; the rows past
    the live ones are all sentinel, as the dirty compaction leaves them."""
    rng = np.random.default_rng(seed)
    verts = rng.uniform(0.0, 8.0, (n, 3, 16, 512)).astype(np.float32)
    live = rng.random((n, 16, 512)) < 0.05
    live[:, 15] = False                      # resolve_edge_soup's pad slot
    verts[:, :, 0, :3] = -0.0
    verts[:, :, 1, :3] = 0.0
    live[:, 0:2, :3] = True
    n_live = n
    if case == "no_live_row":
        live[4] = False
    elif case == "full_row":
        live[5] = True
    elif case == "n_live_below_n":
        n_live = n - 5
    live[n_live:] = False
    verts = np.where(live[:, None], verts, tmc.SENTINEL).astype(np.float32)
    colors = rng.uniform(0.0, 255.0, (n, 3, 16, 512)).astype(np.float32)
    colors = np.where(live[:, None], colors, 0.0).astype(np.float32)
    bidx = rng.integers(-40, 40, (n, 3)).astype(np.int32)
    return (torch.from_numpy(verts).to(torch.bfloat16),
            None if case == "color_off"
            else torch.from_numpy(colors).to(torch.bfloat16),
            torch.from_numpy(bidx), n_live)


@pytest.mark.parametrize("case", ["random", "no_live_row", "full_row",
                                  "n_live_below_n", "color_off"])
def test_mesh_compact_plain_matches_host_csr(case):
    """mesh_row_offsets + mesh_compact (plain versions) equal the host CSR
    they replace, native.compact_mesh_blocks of local_to_world_verts'
    output, bit for bit: offsets, block indices, vertices, colors."""
    verts, colors, bidx, n_live = _compact_soup(case)
    world, mask = tmc.local_to_world_verts(verts[:n_live], bidx[:n_live],
                                           VOXEL)
    want_off, want_v, want_c = native.compact_mesh_blocks(
        world.numpy(), None if colors is None
        else colors[:n_live].float().numpy(), mask.numpy())
    offsets = tmc.mesh_row_offsets(verts)
    assert offsets.dtype == torch.int64 and offsets.shape == (13,)
    total = int(offsets[n_live])
    assert int(offsets[-1]) == total == want_v.shape[0] > 1000
    csr, flat = tmc.mesh_compact(verts, colors, bidx, offsets, n_live,
                                 total, VOXEL)
    np.testing.assert_array_equal(csr[:n_live + 1].numpy(), want_off)
    np.testing.assert_array_equal(csr[n_live + 1:].numpy(),
                                  bidx[:n_live].numpy().reshape(-1))
    assert flat.dtype == torch.float32
    assert flat.shape == (1 if colors is None else 2, total, 3)
    np.testing.assert_array_equal(flat[0].numpy().view(np.uint32),
                                  want_v.view(np.uint32))
    if colors is not None:
        np.testing.assert_array_equal(flat[1].numpy(), want_c)
    counts = np.diff(want_off)
    if case == "no_live_row":
        assert counts[4] == 0
    if case == "full_row":
        assert counts[5] == 16 * 512
