"""Port vs reference: core types, camera, synthetic scene, drop-scatter.

Inputs are made with numpy from a seed and go through the JAX function and
its counterpart in isaac_ros_nvblox_tpu_torch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import types as jt
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu_torch.core import types as tt
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.models import scene as ts

torch.set_num_threads(1)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
JCAM = jc.Camera(**CAM_ARGS)
TCAM = tc.Camera(**CAM_ARGS)


def _pose(seed):
    rng = np.random.RandomState(seed)
    T = js.orbit_pose(rng.uniform(0, 2 * np.pi), radius=rng.uniform(1, 3))
    T[:3, 3] += rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    return T


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_matches(seed):
    T = _pose(seed)
    pts = (np.random.RandomState(seed).randn(4096, 3) * 3).astype(np.float32)
    inv_j = np.asarray(jax.jit(jt.Transform.inverse)(jnp.asarray(T)))
    inv_t = tt.Transform.inverse(torch.from_numpy(T)).numpy()
    np.testing.assert_array_equal(inv_t, inv_j)
    app_j = np.asarray(jax.jit(jt.Transform.apply)(jnp.asarray(T), pts))
    app_t = tt.Transform.apply(torch.from_numpy(T), torch.from_numpy(pts))
    # A 3x3 product: same accumulation order (core/types.py), atol 1e-6.
    np.testing.assert_allclose(app_t.numpy(), app_j, rtol=0, atol=1e-6)
    rot_j = np.asarray(jax.jit(jt.Transform.rotate)(jnp.asarray(T), pts))
    rot_t = tt.Transform.rotate(torch.from_numpy(T), torch.from_numpy(pts))
    np.testing.assert_allclose(rot_t.numpy(), rot_j, rtol=0, atol=1e-6)


def test_camera_project_and_sample_exact():
    rng = np.random.RandomState(3)
    p = np.concatenate([rng.randn(3000, 3) * [1.0, 1.0, 0.2] + [0, 0, 1.5],
                        [[0.0, 0.0, 0.0], [0.1, 0.1, -1.0]]]).astype(np.float32)
    uv_j, ok_j = jax.jit(JCAM.project)(jnp.asarray(p))
    uv_t, ok_t = TCAM.project(torch.from_numpy(p))
    np.testing.assert_array_equal(uv_t.numpy(), np.asarray(uv_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    img = rng.rand(JCAM.height, JCAM.width).astype(np.float32)
    uv = (rng.rand(5000, 2) * [170, 130] - 5).astype(np.float32)
    uv[:64] = np.floor(uv[:64]) + 0.5   # half-pixel ties round to even
    s_j = jax.jit(jc.sample_image_nearest)(jnp.asarray(img), jnp.asarray(uv))
    s_t = tc.sample_image_nearest(torch.from_numpy(img), torch.from_numpy(uv))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_voxel_centers_exact():
    b = np.random.RandomState(4).randint(-40, 40, (33, 3)).astype(np.int32)
    c_j = jax.jit(jt.voxel_centers_for_blocks,
                  static_argnums=1)(jnp.asarray(b), 0.05)
    c_t = tt.voxel_centers_for_blocks(torch.from_numpy(b), 0.05)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(tt.local_voxel_offsets(),
                                  jt.local_voxel_offsets())


def test_ray_directions():
    d_j = np.asarray(jax.jit(JCAM.ray_directions)())
    d_t = TCAM.ray_directions(device="cpu").numpy()
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [0, 3])
def test_render_depth(k):
    T = js.orbit_pose(2 * np.pi * k / 8)
    d_j = np.asarray(js.render_depth(js.default_test_scene(), JCAM,
                                     jnp.asarray(T)))
    d_t = ts.render_depth(ts.default_test_scene(), TCAM, T,
                          device="cpu").numpy()
    assert (d_j > 0).mean() > 0.9
    # 96 sphere-tracing steps in float32; XLA fuses the loop body its own
    # way. Within 1e-5 m on all but 0.1% of the pixels; grazing rays, where
    # tracing amplifies a last-bit difference, within 1e-3 m.
    err = np.abs(d_t - d_j)
    assert (err <= 1e-5).mean() >= 0.999, (err > 1e-5).sum()
    assert err.max() <= 1e-3, err.max()


def test_scene_sdf_and_poses():
    rng = np.random.RandomState(5)
    p = (rng.randn(2000, 3) * 3).astype(np.float32)
    prims = [(js.Sphere((0.1, 0.2, 0.3), 0.7), ts.Sphere((0.1, 0.2, 0.3), 0.7)),
             (js.Box((1, 0, 0), (0.5, 0.2, 0.3)), ts.Box((1, 0, 0), (0.5, 0.2, 0.3))),
             (js.Plane((0.2, 0.1, 1.0), 0.4), ts.Plane((0.2, 0.1, 1.0), 0.4)),
             (js.default_test_scene(), ts.default_test_scene())]
    for pj, pt in prims:
        np.testing.assert_allclose(pt.sdf(torch.from_numpy(p)).numpy(),
                                   np.asarray(jax.jit(pj.sdf)(p)), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(ts.orbit_pose(0.7, 1.3, 1.1),
                                  js.orbit_pose(0.7, 1.3, 1.1))


def test_set_rows_drop_matches_jax_drop_scatter():
    rng = np.random.RandomState(6)
    for trial in range(4):
        dst = rng.randn(16, 4).astype(np.float32)
        # Non-negative indices: JAX wraps negative ones before dropping,
        # and no caller passes any.
        idx = rng.permutation(np.arange(0, 24))[:12].astype(np.int32)
        if trial == 3:
            idx[:] = 16 + np.arange(12)      # every entry dropped
        vals = rng.randn(12, 4).astype(np.float32)
        ref = np.asarray(jnp.asarray(dst).at[idx].set(vals, mode="drop"))
        got = tt.set_rows_drop(torch.from_numpy(dst.copy()),
                               torch.from_numpy(idx), torch.from_numpy(vals))
        np.testing.assert_array_equal(got.numpy(), ref)


def test_fma_rounds_once():
    a = np.float32(1 + 2 ** -12)
    got = tt.fma(torch.tensor([a]), torch.tensor([a]), -1.0).item()
    # (1 + 2^-12)^2 - 1 = 2^-11 + 2^-24: exact with one rounding, while
    # rounding the product first loses the 2^-24 term.
    assert got == 2.0 ** -11 + 2.0 ** -24


def _fma_exact(a, b, c):
    """float32 a*b + c rounded once (to nearest, ties to even), from the
    exact rational value."""
    from fractions import Fraction
    r = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(r))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda x: (abs(Fraction(float(x)) - r),
                                    int(np.asarray(x).view(np.uint32)) & 1))


def test_fma_rounds_once_at_float64_ties():
    """Where the float64 sum of the exact product and c rounds onto a
    float32 tie, fma still rounds the exact value once: (1 - 2^-20) *
    2^-24 (1 + 2^-20) + (1 + 2^-23) lies 2^-64 below the tie 1 + 3 * 2^-24,
    so it rounds down, where the float64 sum (the tie itself) would round
    to even, up. The same on random operands of wide range, against the
    exact rational value."""
    a = np.float32(1 - 2 ** -20)
    b = np.float32(2 ** -24 * (1 + 2 ** -20))
    c = np.float32(1 + 2 ** -23)
    for sign in (1, -1):
        got = tt.fma(torch.tensor([sign * a]), torch.tensor([b]),
                     torch.tensor([sign * c])).item()
        assert got == sign * (1 + 2 ** -23)
    rng = np.random.default_rng(3)
    n = 2000
    A, B, C = ((rng.standard_normal(n) * np.exp2(rng.integers(lo, 30, n)))
               .astype(np.float32) for lo in (-30, -30, -60))
    got = tt.fma(torch.from_numpy(A), torch.from_numpy(B),
                 torch.from_numpy(C)).numpy()
    want = np.array([_fma_exact(*x) for x in zip(A, B, C)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_transform_inverse_matches_at_a_float64_tie():
    """The orbit pose of human_frames' frame 12: a row of its inverse's
    translation, -R^T t, meets a float32 tie in float64 (the fault that
    left one voxel of the people-segmentation occupancy map unobserved);
    the inverse and the voxels it moves equal XLA's bit for bit."""
    T = js.orbit_pose(2 * np.pi * 12 / 16, radius=1.5)
    inv_j = np.asarray(jax.jit(jt.Transform.inverse)(jnp.asarray(T)))
    inv_t = tt.Transform.inverse(torch.from_numpy(T)).numpy()
    np.testing.assert_array_equal(inv_t.view(np.uint32), inv_j.view(np.uint32))
    pts = (np.random.RandomState(5).randn(4096, 3) * 3).astype(np.float32)
    f = jax.jit(lambda T, p: jt.Transform.apply(jt.Transform.inverse(T), p))
    np.testing.assert_array_equal(
        tt.Transform.apply(tt.Transform.inverse(torch.from_numpy(T)),
                           torch.from_numpy(pts)).numpy(),
        np.asarray(f(jnp.asarray(T), jnp.asarray(pts))))
