"""Port vs reference: projective TSDF fusion (plain version of tsdf_fuse).

The port's `integrate_tsdf` mirrors the reference's XLA path
(`ops/tsdf.py::integrate_tsdf`) step for step; the Pallas kernel samples a
decimation pyramid and is held to the statistical bounds of
tests/test_tsdf_pallas.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import tsdf as jts
from isaac_ros_nvblox_tpu.ops import view as jv
from isaac_ros_nvblox_tpu.ops.tsdf_pallas import integrate_tsdf_pallas
from isaac_ros_nvblox_tpu_torch.core.types import (Transform,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.ops import tsdf as tts
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda

torch.set_num_threads(2)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
JCAM = jc.Camera(**CAM_ARGS)
TCAM = tc.Camera(**CAM_ARGS)
VOXEL = 0.05
CAP = 2048


@pytest.fixture(scope="module")
def orbit_batches():
    """Three orbit frames of the default scene with their view batches,
    allocated by the reference."""
    st = jwg.create_world_grid(jwg.WorldGridConfig(
        dims=(48, 48, 24), capacity=CAP, origin_block=(-24, -24, -6)))
    out = []
    for k in range(3):
        T = js.orbit_pose(2 * np.pi * k / 8 + 0.3)
        depth = js.render_depth(js.default_test_scene(), JCAM, jnp.asarray(T))
        grid, origin = jv.touched_block_grid(
            depth, jnp.asarray(T), camera=JCAM, voxel_size_m=VOXEL,
            max_distance_m=3.0, truncation_m=0.2)
        st, slots, bidx, _ = jwg.allocate_and_batch(st, grid, origin,
                                                    max_blocks=1024)
        out.append((np.array(depth), T, np.array(slots), np.array(bidx)))
    return out


def near_rounding_tie(bidx, T, camera=TCAM, tol=1e-3):
    """bool[n, 512]: each voxel of the blocks `bidx` (i32[n, 3]) projects
    within `tol` px of a half-pixel rounding boundary from pose `T`, where
    a last-bit difference in the transform may sample the neighbouring
    pixel."""
    c = voxel_centers_for_blocks(torch.tensor(np.asarray(bidx)), VOXEL)
    p = Transform.apply(Transform.inverse(torch.tensor(np.asarray(T))), c)
    uv, _ = camera.project(p)
    frac = (uv - torch.floor(uv) - 0.5).abs()
    return (frac < tol).any(-1).numpy()


def _near_rounding_tie(slots, bidx, T):
    """near_rounding_tie of a view batch, scattered into pool rows."""
    tie = near_rounding_tie(bidx, T)
    out = np.zeros((CAP, 512), bool)
    ok = slots < CAP
    out[slots[ok]] = tie[ok]
    return out


@pytest.mark.parametrize("mode", list(jts.WeightingFunctionType))
def test_integrate_tsdf_matches_reference(orbit_batches, mode):
    p_j = jts.TsdfIntegratorParams(weighting_mode=mode,
                                   max_integration_distance_m=3.0)
    p_t = tts.TsdfIntegratorParams(
        weighting_mode=tts.WeightingFunctionType(mode.value),
        max_integration_distance_m=3.0)
    d_j = jnp.zeros((CAP, 512), jnp.float32)
    w_j = jnp.zeros((CAP, 512), jnp.float32)
    d_t = torch.zeros(CAP, 512)
    w_t = torch.zeros(CAP, 512)
    ties = np.zeros((CAP, 512), bool)
    for depth, T, slots, bidx in orbit_batches:
        d_j, w_j = jts.integrate_tsdf(
            d_j, w_j, jnp.asarray(slots), jnp.asarray(bidx),
            jnp.asarray(depth), jnp.asarray(T), camera=JCAM,
            voxel_size_m=VOXEL, params=p_j)
        tts.integrate_tsdf(d_t, w_t, torch.from_numpy(slots),
                           torch.from_numpy(bidx), torch.from_numpy(depth),
                           torch.from_numpy(T), camera=TCAM,
                           voxel_size_m=VOXEL, params=p_t)
        ties |= _near_rounding_tie(slots, bidx, T)
    d_j, w_j = np.asarray(d_j), np.asarray(w_j)
    assert (w_j > 0).sum() > 2000   # the penalty mode weighs only near-surface
    # atol 1e-5 on >= 99.9% of the voxels; the rest only where a voxel
    # projects onto a pixel-rounding tie (a last-bit difference in the
    # transform may then sample the neighbouring pixel).
    bad = ((np.abs(d_t.numpy() - d_j) > 1e-5)
           | (np.abs(w_t.numpy() - w_j) > 1e-5))
    assert bad.mean() <= 1e-3, bad.sum()
    assert not (bad & ~ties).any(), (bad & ~ties).sum()


def _pallas_setup(seed=0, n_blocks=64):
    rng = np.random.RandomState(seed)
    bidx = np.stack([rng.randint(-6, 6, n_blocks), rng.randint(-5, 5, n_blocks),
                     rng.randint(1, 11, n_blocks)], axis=1).astype(np.int32)
    bidx = np.unique(bidx, axis=0)
    n = bidx.shape[0]
    slots = np.concatenate([np.arange(n), [256]]).astype(np.int32)
    bidx = np.concatenate([bidx, [[0, 0, 0]]]).astype(np.int32)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.4
    return slots, bidx, T


def _run_both(depth, params_j, params_t):
    slots, bidx, T = _pallas_setup()
    d_p, w_p = integrate_tsdf_pallas(
        jnp.zeros((256, 512)), jnp.zeros((256, 512)), jnp.asarray(slots),
        jnp.asarray(bidx), jnp.asarray(depth), jnp.asarray(T), camera=JCAM,
        voxel_size_m=VOXEL, params=params_j,
        interpret=jax.default_backend() == "cpu")
    d_t, w_t = tts.integrate_tsdf(
        torch.zeros(256, 512), torch.zeros(256, 512), torch.from_numpy(slots),
        torch.from_numpy(bidx), torch.from_numpy(depth), torch.from_numpy(T),
        camera=TCAM, voxel_size_m=VOXEL, params=params_t)
    return (np.asarray(d_p), np.asarray(w_p)), (d_t.numpy(), w_t.numpy())


def test_matches_pallas_flat_wall():
    """A constant-depth image is decimation-invariant: atol 2e-5 (the
    tolerance tests/test_tsdf_pallas.py holds Pallas to)."""
    depth = np.full((JCAM.height, JCAM.width), 2.0, np.float32)
    (d_p, w_p), (d_t, w_t) = _run_both(depth, jts.TsdfIntegratorParams(),
                                       tts.TsdfIntegratorParams())
    assert w_t.max() > 0
    np.testing.assert_allclose(d_t, d_p, rtol=0, atol=2e-5)
    np.testing.assert_allclose(w_t, w_p, rtol=0, atol=2e-5)


def test_matches_pallas_textured_statistics():
    """Varying depth: Pallas samples decimated levels, so hold the port to
    the bounds of tests/test_tsdf_pallas.py (agreement > 0.999, median
    error < 0.01, p99 < 0.05)."""
    rng = np.random.RandomState(1)
    base = 2.0 + 0.3 * np.sin(np.linspace(0, 6, JCAM.width))[None, :]
    depth = (np.broadcast_to(base, (JCAM.height, JCAM.width))
             + rng.rand(JCAM.height, JCAM.width) * 0.01).astype(np.float32)
    (d_p, w_p), (d_t, w_t) = _run_both(depth, jts.TsdfIntegratorParams(),
                                       tts.TsdfIntegratorParams())
    m_p, m_t = w_p > 0, w_t > 0
    assert (m_p == m_t).mean() > 0.999
    err = np.abs(d_t - d_p)[m_p & m_t]
    assert np.median(err) < 0.01
    assert np.percentile(err, 99) < 0.05


def test_padding_rows_untouched():
    slots, bidx, T = _pallas_setup()
    depth = torch.full((JCAM.height, JCAM.width), 2.0)
    d = torch.zeros(256, 512)
    w = torch.zeros(256, 512)
    d[100] = 7.0
    d[255] = 3.0
    # Real slot 0, then padding entries (cap and a negative) whose block
    # indices are in view: neither row 100 nor the clamp target 255 moves.
    s = torch.tensor([0, 256, -1], dtype=torch.int32)
    b = torch.from_numpy(np.stack([bidx[0], bidx[0], bidx[0]]))
    for fn in (tts.integrate_tsdf, integrate_tsdf_cuda):
        fn(d, w, s, b, depth, torch.from_numpy(T), camera=TCAM,
           voxel_size_m=VOXEL, params=tts.TsdfIntegratorParams())
        assert bool((d[100] == 7.0).all()) and bool((d[255] == 3.0).all())
        assert bool((w[1:] == 0).all())
