"""Port vs reference: the EDT's output pruning (the reference's needed-rows
chain, isaac_ros_nvblox_tpu/ops/esdf_dense.py::esdf_from_sites_dense) and
the plain passes with a block mask. Every finite value is an integer below
2^24, so all comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.ops import esdf_dense as jed
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ted

torch.set_num_threads(2)


def _hollow_room(dims_b, cap=256):
    """Blocks on the four walls of the region (no floor or ceiling), sites
    on the wall planes 3 voxels inside the region's faces."""
    Nx, Ny, Nz = dims_b
    cells = np.array([(x, y, z) for x in range(Nx) for y in range(Ny)
                      for z in range(Nz)
                      if x in (0, Nx - 1) or y in (0, Ny - 1)], np.int32)
    n = len(cells)
    out = np.zeros((cap, 3), np.int32)
    out[:n] = cells
    l = np.arange(8)
    lx, ly, _ = np.meshgrid(l, l, l, indexing="ij")
    is_site = np.zeros((cap, 512), bool)
    for s, (cx, cy, _) in enumerate(cells):
        gx, gy = cx * 8 + lx, cy * 8 + ly
        wall = ((gx == 3) | (gx == Nx * 8 - 4) | (gy == 3)
                | (gy == Ny * 8 - 4))
        is_site[s] = wall.reshape(-1)
    return out, is_site, n


def _numpy_masks(cells, n, dims_b, band):
    """The reference's chain in numpy: allocated blocks, dilated by
    ceil(band/8) blocks along the last pass axis, then the mid one."""
    alloc = np.zeros(dims_b, bool)
    for c in cells[:n]:
        alloc[tuple(c)] = True
    _, mid, last = np.argsort(dims_b, kind="stable")
    hb = -(-band // 8)

    def dilate(m, axis):
        out = np.zeros_like(m)
        for idx in np.ndindex(*m.shape):
            lo = list(idx)
            hi = list(idx)
            lo[axis] = max(0, idx[axis] - hb)
            hi[axis] = idx[axis] + hb + 1
            hi = [h if a == axis else h + 1 for a, h in enumerate(hi)]
            out[idx] = m[tuple(slice(a, b) for a, b in zip(lo, hi))].any()
        return out

    need_mid = dilate(alloc, last)
    return dilate(need_mid, mid), need_mid, alloc


@pytest.mark.parametrize("dims_b,band", [((8, 7, 2), 12), ((6, 9, 3), 9)])
def test_pruned_solve_matches_reference_on_hollow_room(dims_b, band):
    cells, is_site, n = _hollow_room(dims_b)
    origin = np.array([2, -3, 1], np.int32)
    in_region, row = ted.region_rows(torch.from_numpy(cells + origin),
                                     torch.tensor(n, dtype=torch.int32),
                                     torch.from_numpy(origin), dims_b)
    masks = ted.needed_masks(row, dims_b, band)
    # Pruning removes most of the last pass's blocks and some of the rest.
    assert float(masks[2].float().mean()) < 0.5
    assert float(masks[1].float().mean()) < 1.0
    got = ted.esdf_from_sites_dense(
        torch.from_numpy(is_site), torch.from_numpy(cells + origin),
        torch.tensor(n, dtype=torch.int32), torch.from_numpy(origin),
        dims_b=dims_b, band=band).numpy()
    ref = ted.esdf_from_sites_reference(is_site, cells, n, dims_b, band)
    np.testing.assert_array_equal(got, ref)
    assert (got[:n] < ted.INF).mean() > 0.5
    sq_j = jed.esdf_from_sites_dense(
        jnp.asarray(is_site), jnp.asarray(cells + origin), jnp.int32(n),
        jnp.asarray(origin), dims_b=dims_b, band=band, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(sq_j))
    # The pruned dense solve is INF outside the allocated blocks.
    seeds = ted.seed_grid(torch.from_numpy(is_site), in_region, row, dims_b)
    dense = ted.solve_region(seeds, band, masks)
    outside = ~ted.needed_voxels(masks[2], dense.shape)
    assert bool((dense[outside] == float(ted.INF)).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_needed_masks_match_numpy_chain(seed):
    rng = np.random.default_rng(seed)
    dims_b = tuple(int(d) for d in rng.integers(2, 9, 3))
    band = int(rng.choice([5, 9, 17, 40]))
    nb = int(np.prod(dims_b))
    n = int(rng.integers(1, nb // 3 + 2))
    all_cells = np.stack(np.meshgrid(*[np.arange(d) for d in dims_b],
                                     indexing="ij"), -1).reshape(-1, 3)
    cap = n + 5
    cells = np.full((cap, 3), -7, np.int32)      # dead slots off-region
    cells[:n] = all_cells[rng.choice(nb, n, replace=False)]
    cells[n] = (0, 0, 0)                         # beyond alloc_count
    origin = np.array([-1, 5, 2], np.int32)
    in_region, row = ted.region_rows(torch.from_numpy(cells + origin),
                                     torch.tensor(n, dtype=torch.int32),
                                     torch.from_numpy(origin), dims_b)
    got = ted.needed_masks(row, dims_b, band)
    want = _numpy_masks(cells, n, dims_b, band)
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and tuple(g.shape) == dims_b
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("shape", [(24, 17, 30), (5, 40, 9), (1, 8, 3)])
def test_plain_passes_with_mask(shape):
    rng = np.random.default_rng(shape[0])
    band = 9
    blocks = tuple(-(-d // 8) for d in shape)
    needed = torch.from_numpy(rng.random(blocks) < 0.5)
    vox = np.repeat(np.repeat(np.repeat(needed.numpy(), 8, 0), 8, 1), 8, 2)
    vox = torch.from_numpy(vox[:shape[0], :shape[1], :shape[2]])
    assert torch.equal(ted.needed_voxels(needed, shape), vox)
    seeds = torch.from_numpy(
        np.where(rng.random(shape) < 0.05, 0, ted.INF).astype(np.float32))
    vals = torch.from_numpy(np.where(rng.random(shape) < 0.3,
                                     rng.integers(0, 120, shape),
                                     ted.INF).astype(np.float32))
    inf = torch.full(shape, float(ted.INF))
    every = torch.ones(blocks, dtype=torch.bool)
    for axis in range(3):
        for fn, x in ((ted.edt_pass1_plain, seeds),
                      (ted.edt_pass_plain, vals)):
            full = fn(x, axis, band)
            got = fn(x, axis, band, needed)
            assert torch.equal(got, torch.where(vox, full, inf))
            assert torch.equal(fn(x, axis, band, every), full)
            assert torch.equal(fn(x, axis, band, ~every), inf)
