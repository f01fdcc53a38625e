"""Port vs reference: color rendering, the cluttered scene, and the plain
versions of the color kernels (color_fuse, tsdf_color_fuse) on the CPU.

The port's `integrate_color_planar` mirrors the reference's XLA function
step for step; its fused TSDF + color plain version equals the reference's
`integrate_tsdf` followed by `integrate_color_planar` on the same batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import color as jcol
from isaac_ros_nvblox_tpu.ops import tsdf as jts
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.models import scene as ts
from isaac_ros_nvblox_tpu_torch.ops import color as tcol
from isaac_ros_nvblox_tpu_torch.ops import tsdf as tts
from isaac_ros_nvblox_tpu_torch.ops.color_cuda import integrate_color_cuda
from isaac_ros_nvblox_tpu_torch.ops.tsdf_color_cuda import (
    integrate_tsdf_color_cuda)
from test_torch_tsdf import near_rounding_tie

torch.set_num_threads(2)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
JCAM = jc.Camera(**CAM_ARGS)
TCAM = tc.Camera(**CAM_ARGS)
VOXEL = 0.05
CAP = 256
MODES = [jts.WeightingFunctionType.INVERSE_SQUARE_DROPOFF,
         jts.WeightingFunctionType.CONSTANT_DROPOFF,
         jts.WeightingFunctionType.INVERSE_SQUARE_TSDF_DISTANCE_PENALTY,
         jts.WeightingFunctionType.LINEAR_WITH_MAX]


@pytest.mark.parametrize("k", [1, 5])
def test_render_color_matches_reference(k):
    T = js.orbit_pose(2 * np.pi * k / 8)
    c_j = np.asarray(js.render_color(js.default_test_scene(), JCAM,
                                     jnp.asarray(T)))
    c_t = ts.render_color(ts.default_test_scene(), TCAM, T,
                          device="cpu").numpy()
    assert c_t.dtype == np.uint8 and c_t.shape == c_j.shape
    assert (c_j > 0).any(-1).mean() > 0.9
    # |p| * 64 mod 256, truncated to u8: the render tolerance of
    # test_torch_core.py (1e-5 m on all but 0.1% of the hit points) moves a
    # channel by one level where 64 |p| sits that close to an integer.
    same = (c_t == c_j).all(-1)
    assert same.mean() >= 0.999, (~same).sum()


def test_cluttered_scene_matches_reference():
    j, t = js.cluttered_multi_room_scene(), ts.cluttered_multi_room_scene()
    assert len(t.primitives) == len(j.primitives) == 13
    for a, b in zip(j.primitives, t.primitives):
        assert type(a).__name__ == type(b).__name__
        assert vars(a) == vars(b)
    p = (np.random.RandomState(4).randn(4000, 3) * [4, 3, 1.5]
         + [0, 0, 1.5]).astype(np.float32)
    np.testing.assert_allclose(t.sdf(torch.from_numpy(p)).numpy(),
                               np.asarray(j.sdf(jnp.asarray(p))), rtol=0,
                               atol=1e-6)


def _setup(seed=0, depth_shape=(120, 160)):
    """A batch of random blocks in front of a camera, a prior map, a smooth
    depth image of the given shape and a random color image."""
    rng = np.random.RandomState(seed)
    bidx = np.unique(np.stack([rng.randint(-6, 6, 80), rng.randint(-5, 5, 80),
                               rng.randint(1, 11, 80)], 1), axis=0)
    n = bidx.shape[0]
    slots = np.concatenate([np.arange(n), [CAP]]).astype(np.int32)
    bidx = np.concatenate([bidx, [[0, 0, 0]]]).astype(np.int32)
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = -0.4
    pool = [rng.uniform(-0.2, 0.2, (CAP, 512)), rng.uniform(0, 2, (CAP, 512)),
            rng.uniform(0, 255, (CAP, 512)), rng.uniform(0, 255, (CAP, 512)),
            rng.uniform(0, 255, (CAP, 512)), rng.uniform(0, 1, (CAP, 512))]
    pool = [a.astype(np.float32) for a in pool]
    Hd, Wd = depth_shape
    depth = (3.0 + 0.2 * np.sin(np.arange(Hd)[:, None] * 120 / Hd / 7.0)
             + 0.1 * np.cos(np.arange(Wd)[None, :] * 160 / Wd / 11.0)
             ).astype(np.float32)
    depth[::9, ::13] = 0.0
    color = rng.randint(0, 256, (JCAM.height, JCAM.width, 3)).astype(np.uint8)
    return pool, slots, bidx, depth, color, T


def _ties(bidx, T, scale=None):
    """bool[CAP, 512] voxels near a pixel-rounding tie (at full resolution,
    and at `scale` for a depth image of another size)."""
    tie = near_rounding_tie(bidx, T)
    if scale is not None:
        shifted = tc.Camera(fx=160.0 * scale, fy=160.0 * scale,
                            cx=79.5 * scale, cy=59.5 * scale, width=160,
                            height=120)
        tie |= near_rounding_tie(bidx, T, camera=shifted)
    out = np.zeros((CAP, 512), bool)
    out[np.arange(len(bidx) - 1)] = tie[:-1]
    return out


def _assert_close(got, want, ties, names):
    """Equal on >= 99.9% of the voxels; any other difference only at a
    pixel-rounding tie (test_torch_tsdf.py's rule)."""
    bad = np.zeros((CAP, 512), bool)
    for g, w in zip(got, want):
        bad |= np.asarray(g) != np.asarray(w)
    assert bad.mean() <= 1e-3, (names, bad.sum())
    assert not (bad & ~ties).any(), (names, (bad & ~ties).sum())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("depth_kind", ["aligned", "half", "zero"])
def test_color_plain_matches_reference(mode, depth_kind):
    shape = (60, 80) if depth_kind == "half" else (120, 160)
    pool, slots, bidx, depth, color, T = _setup(1, shape)
    if depth_kind == "zero":
        depth[:] = 0.0          # no occlusion test
    p_j = jts.TsdfIntegratorParams(weighting_mode=mode,
                                   max_integration_distance_m=5.0)
    p_t = tts.TsdfIntegratorParams(
        weighting_mode=tts.WeightingFunctionType(mode.value),
        max_integration_distance_m=5.0)
    want = jcol.integrate_color_planar(
        *[jnp.asarray(a) for a in pool[2:]], jnp.asarray(pool[0]),
        jnp.asarray(pool[1]), jnp.asarray(slots), jnp.asarray(bidx),
        jnp.asarray(color), jnp.asarray(depth), jnp.asarray(T), camera=JCAM,
        voxel_size_m=VOXEL, params=p_j)
    t = [torch.from_numpy(a.copy()) for a in pool]
    got = integrate_color_cuda(
        *t[2:], t[0], t[1], torch.from_numpy(slots), torch.from_numpy(bidx),
        torch.from_numpy(color), torch.from_numpy(depth), torch.from_numpy(T),
        camera=TCAM, voxel_size_m=VOXEL, params=p_t)
    changed = (got[3].numpy() != pool[5]).sum()
    assert changed > 1000, changed
    _assert_close(got, want, _ties(bidx, T, 0.5 if depth_kind == "half"
                                   else None), "rgbw")


@pytest.mark.parametrize("mode", MODES)
def test_fused_plain_matches_reference_sequence(mode):
    pool, slots, bidx, depth, color, T = _setup(2)
    depth[5:9, :] = np.nan
    p_j = jts.TsdfIntegratorParams(weighting_mode=mode,
                                   max_integration_distance_m=5.0)
    p_t = tts.TsdfIntegratorParams(
        weighting_mode=tts.WeightingFunctionType(mode.value),
        max_integration_distance_m=5.0)
    kw_j = dict(camera=JCAM, voxel_size_m=VOXEL, params=p_j)
    kw_t = dict(camera=TCAM, voxel_size_m=VOXEL, params=p_t)
    j = [jnp.asarray(a) for a in pool]
    d1, w1 = jts.integrate_tsdf(j[0], j[1], jnp.asarray(slots),
                                jnp.asarray(bidx), jnp.asarray(depth),
                                jnp.asarray(T), **kw_j)
    want = (d1, w1) + tuple(jcol.integrate_color_planar(
        *j[2:], d1, w1, jnp.asarray(slots), jnp.asarray(bidx),
        jnp.asarray(color), jnp.asarray(depth), jnp.asarray(T), **kw_j))
    args = (torch.from_numpy(slots), torch.from_numpy(bidx),
            torch.from_numpy(depth), torch.from_numpy(color),
            torch.from_numpy(T))
    got = integrate_tsdf_color_cuda(
        *[torch.from_numpy(a.copy()) for a in pool], *args, **kw_t)
    assert (got[5].numpy() != pool[5]).sum() > 1000
    _assert_close(got, want, _ties(bidx, T), "d w r g b cw")
    # The port's own TSDF step then color step: bit for bit.
    seq = [torch.from_numpy(a.copy()) for a in pool]
    tts.integrate_tsdf(seq[0], seq[1], args[0], args[1], args[2], args[4],
                       **kw_t)
    tcol.integrate_color_planar(*seq[2:], seq[0], seq[1], args[0], args[1],
                                args[3], args[2], args[4], **kw_t)
    for g, s in zip(got, seq):
        assert torch.equal(g, s)


def _slot_ties(slots, bidx, T, scale=None):
    """_ties of a batch whose real entries sit at arbitrary slots."""
    tie = near_rounding_tie(bidx, T)
    if scale is not None:
        shifted = tc.Camera(fx=160.0 * scale, fy=160.0 * scale,
                            cx=79.5 * scale, cy=59.5 * scale, width=160,
                            height=120)
        tie |= near_rounding_tie(bidx, T, camera=shifted)
    out = np.zeros((CAP, 512), bool)
    ok = (slots >= 0) & (slots < CAP)
    out[slots[ok]] = tie[ok]
    return out


@pytest.mark.parametrize("layout", ["padded", "one_entry"])
@pytest.mark.parametrize("kernel", ["color", "color_half", "tsdf_color"])
def test_color_plain_batch_layouts_match_reference(kernel, layout):
    """The plain versions, which the card kernels equal bit for bit,
    against the reference on batches the kernels' persistent walk treats
    specially: real entries turned into padding with slot -1 and slot ==
    cap, and a batch of one entry; rows outside the batch untouched on
    both sides. The reference's `.at[]` reads slot -1 as row cap - 1
    (Python indexing) where the port reads it as padding; its own
    allocator pads with cap, so the reference is given cap there."""
    half = kernel == "color_half"
    pool, slots, bidx, depth, color, T = _setup(
        3, (60, 80) if half else (120, 160))
    mode = jts.WeightingFunctionType.INVERSE_SQUARE_TSDF_DISTANCE_PENALTY
    p_j = jts.TsdfIntegratorParams(weighting_mode=mode,
                                   max_integration_distance_m=5.0)
    p_t = tts.TsdfIntegratorParams(
        weighting_mode=tts.WeightingFunctionType(mode.value),
        max_integration_distance_m=5.0)
    kw_j = dict(camera=JCAM, voxel_size_m=VOXEL, params=p_j)
    kw_t = dict(camera=TCAM, voxel_size_m=VOXEL, params=p_t)
    first = 0 if kernel == "tsdf_color" else 2

    def port(s, b):
        t = [torch.from_numpy(a.copy()) for a in pool]
        s, b = torch.from_numpy(s), torch.from_numpy(b)
        if kernel == "tsdf_color":
            out = integrate_tsdf_color_cuda(
                *t, s, b, torch.from_numpy(depth), torch.from_numpy(color),
                torch.from_numpy(T), **kw_t)
        else:
            out = integrate_color_cuda(
                *t[2:], t[0], t[1], s, b, torch.from_numpy(color),
                torch.from_numpy(depth), torch.from_numpy(T), **kw_t)
        return [a.numpy() for a in out]

    def reference(s, b):
        j = [jnp.asarray(a) for a in pool]
        s = jnp.asarray(np.where(s < 0, CAP, s).astype(np.int32))
        b, T_j = jnp.asarray(b), jnp.asarray(T)
        d, w = j[0], j[1]
        if kernel == "tsdf_color":
            d, w = jts.integrate_tsdf(d, w, s, b, jnp.asarray(depth), T_j,
                                      **kw_j)
        rgbw = jcol.integrate_color_planar(
            *j[2:], d, w, s, b, jnp.asarray(color), jnp.asarray(depth), T_j,
            **kw_j)
        return [np.asarray(a) for a in ((d, w) + tuple(rgbw))[first:]]

    real = np.nonzero(slots < CAP)[0]
    if layout == "one_entry":
        # The real entry with the most colored voxels.
        cw = port(slots, bidx)[-1]
        k = real[np.argmax((cw != pool[5])[slots[real]].sum(1))]
        s, b = slots[k:k + 1].copy(), bidx[k:k + 1].copy()
    else:
        s, b = slots.copy(), bidx.copy()
        s[real[::5]] = -1
        s[real[2::7]] = CAP
    got, want = port(s, b), reference(s, b)
    inside = np.zeros(CAP, bool)
    inside[s[(s >= 0) & (s < CAP)]] = True
    assert inside.sum() == (1 if layout == "one_entry" else
                            len(real) - len(real[::5]) - len(
                                np.setdiff1d(real[2::7], real[::5])))
    for g, w, start in zip(got, want, pool[first:]):
        np.testing.assert_array_equal(g[~inside], start[~inside])
        np.testing.assert_array_equal(w[~inside], start[~inside])
    assert (got[-1][inside] != pool[5][inside]).sum() > (
        100 if layout == "one_entry" else 1000)
    _assert_close(got, want, _slot_ties(s, b, T, 0.5 if half else None),
                  kernel)
