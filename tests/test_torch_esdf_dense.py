"""Port vs reference: the exact banded EDT (plain versions of edt_pass1 and
edt_pass) and ESDF site extraction. Every finite value is an integer below
2^24, so all comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.ops import esdf as jesdf
from isaac_ros_nvblox_tpu.ops import esdf_dense as jed
from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.ops import esdf as tesdf
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ted

torch.set_num_threads(2)


def _random_site_map(rng, dims_b, n_blocks, cap=64, p_site=0.02):
    Nx, Ny, Nz = dims_b
    all_cells = np.stack(np.meshgrid(np.arange(Nx), np.arange(Ny),
                                     np.arange(Nz), indexing="ij"),
                         -1).reshape(-1, 3)
    sel = rng.choice(len(all_cells), size=min(n_blocks, len(all_cells)),
                     replace=False)
    cells = np.zeros((cap, 3), np.int32)
    cells[:len(sel)] = all_cells[sel]
    is_site = np.zeros((cap, 512), bool)
    is_site[:len(sel)] = rng.random((len(sel), 512)) < p_site
    return cells, is_site, len(sel)


def _port(is_site, bidx, n, origin, dims_b, band):
    return ted.esdf_from_sites_dense(
        torch.from_numpy(is_site), torch.from_numpy(bidx),
        torch.tensor(n, dtype=torch.int32), torch.from_numpy(origin),
        dims_b=dims_b, band=band).numpy()


@pytest.mark.parametrize("band", [5, 12, 17])
@pytest.mark.parametrize("dims_b", [(4, 3, 2), (2, 2, 5)])
def test_dense_edt_matches_reference(band, dims_b):
    rng = np.random.default_rng(42 + band)
    cells, is_site, n = _random_site_map(rng, dims_b, n_blocks=14)
    origin = np.array([3, -2, 7], np.int32)
    got = _port(is_site, cells + origin, n, origin, dims_b, band)
    ref = ted.esdf_from_sites_reference(is_site, cells, n, dims_b, band)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        ref, jed.esdf_from_sites_reference(is_site, cells, n, dims_b, band))


def test_dense_edt_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    dims_b, band = (3, 2, 2), 9
    cells, is_site, n = _random_site_map(rng, dims_b, n_blocks=10)
    origin = np.array([-1, 4, 0], np.int32)
    sq_j = jed.esdf_from_sites_dense(
        jnp.asarray(is_site), jnp.asarray(cells + origin), jnp.int32(n),
        jnp.asarray(origin), dims_b=dims_b, band=band, interpret=True)
    got = _port(is_site, cells + origin, n, origin, dims_b, band)
    np.testing.assert_array_equal(got, np.asarray(sq_j))


def test_unallocated_gap_propagation():
    cap, dims_b, band = 8, (4, 1, 1), 20
    cells = np.zeros((cap, 3), np.int32)
    cells[1] = (3, 0, 0)   # gap of 2 blocks between
    is_site = np.zeros((cap, 512), bool)
    is_site[0, 0] = True
    origin = np.zeros(3, np.int32)
    sq = _port(is_site, cells, 2, origin, dims_b, band)
    assert sq[1, 0] == ted.INF              # x = 24: beyond the band
    is_site[0, 448] = True                  # x = 7 -> 17 voxels away
    sq = _port(is_site, cells, 2, origin, dims_b, band)
    assert sq[1, 0] == 17.0 ** 2
    assert np.all(sq[2:] == ted.INF)        # unallocated slots
    np.testing.assert_array_equal(
        sq, ted.esdf_from_sites_reference(is_site, cells, 2, dims_b, band))


def test_empty_region_and_corridor():
    cells = np.zeros((16, 3), np.int32)
    cells[0] = (1, 1, 0)
    sq = _port(np.zeros((16, 512), bool), cells, 1, np.zeros(3, np.int32),
               (3, 3, 1), 8)
    assert np.all(sq == ted.INF)
    # A long corridor with blocks only at both ends.
    rng = np.random.default_rng(11)
    corner = [(cx, cy, cz) for cx in (0, 1, 10, 11) for cy in range(2)
              for cz in range(2)]
    cells = np.zeros((64, 3), np.int32)
    cells[:len(corner)] = corner
    is_site = np.zeros((64, 512), bool)
    is_site[:len(corner)] = rng.random((len(corner), 512)) < 0.01
    origin = np.array([-5, 2, 0], np.int32)
    np.testing.assert_array_equal(
        _port(is_site, cells + origin, len(corner), origin, (12, 4, 2), 12),
        ted.esdf_from_sites_reference(is_site, cells, len(corner),
                                      (12, 4, 2), 12))


def _brute_lines(lines, band, first):
    """Per-line brute force of the 1-D passes (numpy, float64)."""
    L, S = lines.shape
    out = np.full((L, S), np.inf)
    for i in range(S):
        for k in range(-band, band + 1):
            if 0 <= i + k < S:
                cand = lines[:, i + k] + (abs(k) if first else k * k)
                out[:, i] = np.minimum(out[:, i], cand)
    if first:
        out = np.where(out <= band, out * out, np.inf)
    return np.where(np.isinf(out), ted.INF, out).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pass_plain_versions_brute_force(axis):
    rng = np.random.default_rng(axis)
    shape = (23, 17, 29)
    band = 7
    seeds = np.where(rng.random(shape) < 0.03, 0.0, ted.INF).astype(np.float32)
    p1 = ted.edt_pass1_plain(torch.from_numpy(seeds), axis, band).numpy()
    lines = np.moveaxis(seeds, axis, -1).reshape(-1, shape[axis])
    lines = np.where(lines >= ted.INF, np.inf, lines)
    want1 = _brute_lines(lines, band, first=True)
    np.testing.assert_array_equal(
        np.moveaxis(p1, axis, -1).reshape(-1, shape[axis]), want1)
    # The banded pass on squared-distance input.
    vals = np.where(rng.random(shape) < 0.3,
                    rng.integers(0, 200, shape), ted.INF).astype(np.float32)
    p = ted.edt_pass_plain(torch.from_numpy(vals), axis, band).numpy()
    lines = np.moveaxis(vals, axis, -1).reshape(-1, shape[axis])
    lines = np.where(lines >= ted.INF, np.inf, lines.astype(np.float64))
    np.testing.assert_array_equal(
        np.moveaxis(p, axis, -1).reshape(-1, shape[axis]),
        _brute_lines(lines, band, first=False))
    # The wrappers take the plain versions for CPU tensors, launching
    # nothing.
    before = dict(kernels.LAUNCHES)
    t = torch.from_numpy(seeds)
    assert torch.equal(ted.edt_pass1(t, axis, band),
                       ted.edt_pass1_plain(t, axis, band))
    assert torch.equal(ted.edt_pass(t, axis, band),
                       ted.edt_pass_plain(t, axis, band))
    assert kernels.LAUNCHES == before


def test_sites_from_tsdf_identical():
    rng = np.random.default_rng(2)
    d = (rng.normal(0, 0.1, (32, 512))).astype(np.float32)
    d[0, :8] = [0.05, -0.05, np.float32(0.05) + 1e-8, 0.0, -0.0, 0.2, 0.049999,
                0.050001]
    w = rng.random((32, 512)).astype(np.float32) * 1e-3
    kw = dict(max_site_distance_vox=1.0, min_weight=1e-4)
    got = tesdf.esdf_sites_from_tsdf(torch.from_numpy(d), torch.from_numpy(w),
                                     voxel_size_m=0.05, **kw)
    want = jesdf.esdf_sites_from_tsdf(jnp.asarray(d), jnp.asarray(w),
                                      voxel_size_m=jnp.float32(0.05), **kw)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _sweep_lines(lines, band):
    """The first pass as the kernel computes it (numpy): the unbanded L1
    transform as min(forward, backward), forward[i] = min_{j<=i} in[j] - j
    + i and backward[i] = min_{j>=i} in[j] + j - i, then d*d where
    d <= band, else INF."""
    S = lines.shape[1]
    i = np.arange(S, dtype=np.float32)
    fwd = np.minimum.accumulate(lines - i, axis=1) + i
    bwd = np.minimum.accumulate((lines + i)[:, ::-1], axis=1)[:, ::-1] - i
    d = np.minimum(fwd, bwd)
    return np.where(d <= band, d * d, ted.INF).astype(np.float32)


@pytest.mark.parametrize("band", [0, 3, 9, 40])
def test_pass1_non_binary_input(band):
    """For any non-negative integer input the banded first pass equals the
    brute force, and equals the two unbanded sweeps of its kernel."""
    rng = np.random.default_rng(band)
    shape = (7, 13, 90)
    vals = np.where(rng.random(shape) < 0.15,
                    rng.integers(0, 3 * band + 3, shape),
                    ted.INF).astype(np.float32)
    for axis in range(3):
        p1 = ted.edt_pass1_plain(torch.from_numpy(vals), axis, band).numpy()
        lines = np.moveaxis(vals, axis, -1).reshape(-1, shape[axis])
        got = np.moveaxis(p1, axis, -1).reshape(-1, shape[axis])
        brute = _brute_lines(np.where(lines >= ted.INF, np.inf,
                                      lines.astype(np.float64)),
                             band, first=True)
        np.testing.assert_array_equal(got, brute)
        np.testing.assert_array_equal(_sweep_lines(lines, band), brute)
