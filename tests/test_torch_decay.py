"""Port vs reference: decay, slot freeing and map clearing (CPU).

Decay is an elementwise pass and must equal the reference bit for bit;
freeing must leave the same allocator state and removed-block ring, so
that the next allocation hands out the same recycled slots.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import decay as jdecay
from isaac_ros_nvblox_tpu.ops import view as jv
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.ops import decay as tdecay
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams as TTsdf
from test_torch_occupancy import STATE, jax_mapper_arrays
from test_torch_tsdf import JCAM, TCAM, VOXEL

torch.set_num_threads(2)

CAP = 256
GRID = dict(dims=(24, 24, 16), capacity=CAP, origin_block=(-12, -12, -4))


def _pool(seed=0):
    """A pool of random TSDF rows: blocks in front of an orbit camera, some
    weights tiny (decay to 0), freed rows (sentinel) and unused rows."""
    rng = np.random.RandomState(seed)
    bidx = np.stack([rng.randint(-8, 8, CAP), rng.randint(-8, 8, CAP),
                     rng.randint(-2, 8, CAP)], 1).astype(np.int32)
    bidx[200:210] = twg.FREED_BLOCK_SENTINEL
    d = (rng.randn(CAP, 512) * 0.1).astype(np.float32)
    w = (rng.rand(CAP, 512) * 2.0).astype(np.float32)
    w[rng.rand(CAP, 512) < 0.3] = 1e-3
    w[::9] = 0.0
    return d, w, bidx, js.orbit_pose(0.7, radius=1.5)


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("free_distance", [False, True])
def test_decay_tsdf_bit_exact(view, free_distance):
    d, w, bidx, T = _pool()
    kw = dict(set_free_distance_on_decayed=free_distance, decay_factor=0.6)
    want = jdecay.decay_tsdf(
        jnp.asarray(d), jnp.asarray(w), jnp.asarray(bidx), jnp.asarray(T),
        params=jdecay.TsdfDecayParams(**kw), voxel_size_m=VOXEL,
        camera=JCAM if view else None, view_distance_m=3.0)
    got = tdecay.decay_tsdf(
        torch.from_numpy(d), torch.from_numpy(w), torch.from_numpy(bidx),
        torch.from_numpy(T), params=tdecay.TsdfDecayParams(**kw),
        voxel_size_m=VOXEL, camera=TCAM if view else None,
        view_distance_m=3.0)
    kept = (np.asarray(want[1]) == w) & (w > 1e-3)
    assert (kept.sum() > 1000) == view
    assert (np.asarray(want[1]) == 0).sum() > (w == 0).sum() + 10000
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("to_free", [False, True])
def test_decay_occupancy_bit_exact(to_free):
    rng = np.random.RandomState(1)
    lo = (rng.randn(CAP, 512) * 3).astype(np.float32)
    lo[rng.rand(CAP, 512) < 0.2] = 0.0
    lo[::5] = np.float32(0.2006707)   # near the free target
    params = dict(to_free=to_free)
    want = jdecay.decay_occupancy(jnp.asarray(lo),
                                  params=jdecay.OccupancyDecayParams(**params))
    got = tdecay.decay_occupancy(torch.from_numpy(lo),
                                 params=tdecay.OccupancyDecayParams(**params))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def _allocated(seed=2):
    """The reference's allocator after two view batches, with its arrays."""
    st = jwg.create_world_grid(jwg.WorldGridConfig(**GRID))
    scene = js.default_test_scene()
    for k in range(2):
        T = js.orbit_pose(0.4 * k + seed * 0.1, radius=1.5)
        depth = js.render_depth(scene, JCAM, jnp.asarray(T))
        grid, origin = jv.touched_block_grid(
            depth, jnp.asarray(T), camera=JCAM, voxel_size_m=VOXEL,
            max_distance_m=1.5, truncation_m=0.2)
        st, *_ = jwg.allocate_and_batch(st, grid, origin, max_blocks=256)
    return st


def _jax_state_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def test_free_slots_then_allocation_match_reference():
    st = _allocated()
    n = int(st.alloc_count)
    assert n > 50
    rng = np.random.RandomState(3)
    # Live slots, a duplicate-free mix with out-of-range and -1 entries.
    free = np.concatenate([rng.choice(n, 40, replace=False),
                           [-1, CAP, CAP + 5]]).astype(np.int32)
    t_st = twg.WorldGridState.from_numpy(_jax_state_arrays(st), "cpu")
    st = jwg.free_slots(st, jnp.asarray(free))
    t_st = twg.free_slots(t_st, torch.from_numpy(free))
    want = _jax_state_arrays(st)
    for f, v in t_st.to_numpy().items():
        np.testing.assert_array_equal(v, want[f], err_msg=f)
    assert int(want["free_count"]) == 40
    # Freeing a freed slot again changes nothing.
    t_st = twg.free_slots(t_st, torch.from_numpy(free[:5]))
    assert int(t_st.free_count) == 40
    # The next view allocates recycled slots first, in the same order.
    T = js.orbit_pose(2.5, radius=1.5)
    depth = js.render_depth(js.default_test_scene(), JCAM, jnp.asarray(T))
    grid, origin = jv.touched_block_grid(
        depth, jnp.asarray(T), camera=JCAM, voxel_size_m=VOXEL,
        max_distance_m=1.5, truncation_m=0.2)
    st, slots_j, _, _ = jwg.allocate_and_batch(st, grid, origin,
                                               max_blocks=256)
    t_st, slots_t, _, _ = twg.allocate_and_batch(
        t_st, torch.from_numpy(np.asarray(grid)),
        torch.from_numpy(np.asarray(origin)), max_blocks=256)
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))
    want = _jax_state_arrays(st)
    for f, v in t_st.to_numpy().items():
        np.testing.assert_array_equal(v, want[f], err_msg=f)
    assert int(want["free_count"]) < 40


def _channels_pair(st, seed=5):
    rng = np.random.RandomState(seed)
    chans = {"tsdf_distance": (rng.randn(CAP, 512) * 0.1).astype(np.float32),
             "tsdf_weight": rng.rand(CAP, 512).astype(np.float32),
             "esdf_sq_dist": rng.rand(CAP, 512).astype(np.float32),
             "esdf_is_inside": rng.rand(CAP, 512) < 0.5}
    dirty = rng.rand(CAP) < 0.5
    return chans, dirty


def _run_pair(fn_j, fn_t, max_free, ring):
    """One freeing step on both sides from the same allocator, channels,
    dirty bits and a removed ring of size `ring` that already holds 3."""
    st = _allocated(4)
    chans, dirty = _channels_pair(st)
    t_st = twg.WorldGridState.from_numpy(_jax_state_arrays(st), "cpu")
    removed = (np.zeros((ring, 3), np.int32), np.int32(ring - 2))
    t_ch = {k: torch.from_numpy(v.copy()) for k, v in chans.items()}
    t_dirty = [torch.from_numpy(dirty.copy()) for _ in range(2)]
    t_removed = (torch.from_numpy(removed[0].copy()),
                 torch.tensor(removed[1]))
    st_j, ch_j, d_j, e_j, (log_j, cnt_j) = fn_j(
        st, {k: jnp.asarray(v) for k, v in chans.items()},
        jnp.asarray(dirty), jnp.asarray(dirty),
        (jnp.asarray(removed[0]), jnp.asarray(removed[1])), max_free)
    t_st, cnt_t = fn_t(t_st, t_ch, *t_dirty, t_removed, max_free)
    want = _jax_state_arrays(st_j)
    for f, v in t_st.to_numpy().items():
        np.testing.assert_array_equal(v, want[f], err_msg=f)
    for k, v in t_ch.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ch_j[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(t_dirty[0].numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(t_dirty[1].numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(t_removed[0].numpy(), np.asarray(log_j))
    assert int(cnt_t) == int(cnt_j)
    return int(cnt_j) - (ring - 2)


@pytest.mark.parametrize("max_free", [16, 4096])
def test_free_mask_ring_and_resets_match_reference(max_free):
    """`_free_mask` on a dead mask: the lowest `max_free` dead slots are
    freed, their rows reset (INF ESDF, zeros elsewhere), their dirty bits
    cleared and their block indices logged in the ring, which wraps."""
    rng = np.random.RandomState(6)
    dead = rng.rand(CAP) < 0.6

    def fn_j(st, ch, d, e, removed, mf):
        live = jwg.live_slot_mask(st)
        return jdm._free_mask(st, ch, d, e, removed, live & dead,
                              max_free=mf)

    def fn_t(st, ch, d, e, removed, mf):
        live = twg.live_slot_mask(st)
        return tdm._free_mask(st, ch, d, e, removed,
                              live & torch.from_numpy(dead), max_free=mf)

    n = _run_pair(fn_j, fn_t, max_free, ring=8)
    assert n == 16 if max_free == 16 else n > 16


def test_clear_outside_radius_matches_reference():
    center = np.array([0.3, -0.2, 1.0], np.float32)

    def fn_j(st, ch, d, e, removed, mf):
        return jdm._clear_outside_radius_fused(
            st, ch, d, e, removed, jnp.asarray(center), jnp.float32(1.3),
            voxel_size_m=VOXEL, max_free=mf)

    def fn_t(st, ch, d, e, removed, mf):
        return tdm._clear_outside_radius_fused(
            st, ch, d, e, removed, torch.from_numpy(center), 1.3,
            voxel_size_m=VOXEL, max_free=mf)

    assert _run_pair(fn_j, fn_t, 8192, ring=CAP) > 20


def test_clear_shapes_match_reference():
    st = _allocated(4)
    chans, dirty = _channels_pair(st)
    spheres = np.zeros((8, 4), np.float32)
    spheres[0] = (0.4, 0.0, 1.0, 0.5)
    spheres[1] = (-0.5, 0.5, 0.6, -1.0)        # inert: radius <= 0
    aabbs = np.zeros((8, 6), np.float32)
    aabbs[0] = (-1.0, -1.0, 0.0, -0.2, 0.1, 0.8)
    aabbs[1] = (1.0, 1.0, 1.0, 0.5, 2.0, 2.0)  # inert: empty
    d_j, w_j, dd_j, ed_j = jdm._clear_shapes_fused(
        st, jnp.asarray(chans["tsdf_distance"]),
        jnp.asarray(chans["tsdf_weight"]), jnp.asarray(dirty),
        jnp.asarray(dirty), jnp.asarray(spheres), jnp.asarray(aabbs),
        voxel_size_m=VOXEL)
    t_st = twg.WorldGridState.from_numpy(_jax_state_arrays(st), "cpu")
    d_t = torch.from_numpy(chans["tsdf_distance"].copy())
    w_t = torch.from_numpy(chans["tsdf_weight"].copy())
    dd_t, ed_t = torch.from_numpy(dirty.copy()), torch.from_numpy(dirty.copy())
    # The port takes the given shapes only: inert padding changes nothing.
    tdm._clear_shapes_fused(t_st, d_t, w_t, dd_t, ed_t,
                            torch.from_numpy(spheres[:2]),
                            torch.from_numpy(aabbs[:2]), voxel_size_m=VOXEL)
    assert (np.asarray(w_j) == 0).sum() > 2000
    for g, x in ((d_t, d_j), (w_t, w_j), (dd_t, dd_j), (ed_t, ed_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_tsdf_mapper_decay_and_clear_match_reference():
    """The TSDF mapper's entry points: two frames by the reference, loaded
    into the port; then on both sides a frame, three decays (factor 0.1,
    the last view excluded and never freed), a frame into recycled slots,
    clearing outside a radius and inside a sphere."""
    world = dict(dims=(48, 48, 24), capacity=2048,
                 origin_block=(-24, -24, -6))
    decay = dict(decay_factor=0.1)
    j = jdm.DeviceMapper(
        VOXEL, params=dataclasses.replace(
            jp.MapperParams(projective=JTsdf(max_integration_distance_m=3.0)),
            tsdf_decay=jdecay.TsdfDecayParams(**decay)),
        world=jwg.WorldGridConfig(**world), enable_color=False,
        enable_esdf=True, max_blocks_per_frame=1024)
    t = tdm.DeviceMapper(
        VOXEL, params=dataclasses.replace(
            tp.MapperParams(projective=TTsdf(max_integration_distance_m=3.0)),
            tsdf_decay=tdecay.TsdfDecayParams(**decay)),
        world=twg.WorldGridConfig(**world), enable_color=False,
        max_blocks_per_frame=1024, device="cpu")
    scene = js.default_test_scene()
    frames = [(np.array(js.render_depth(scene, JCAM, jnp.asarray(T))), T)
              for T in (js.orbit_pose(0.9 * k, radius=1.8) for k in range(4))]
    for depth, T in frames[:2]:
        j.integrate_depth(depth, T, JCAM)
    t.load_state_arrays(jax_mapper_arrays(j))
    # A loaded map starts clean (load_state_arrays clears the dirty bits).
    j.dirty = jnp.zeros_like(j.dirty)
    for m, cam in ((j, JCAM), (t, TCAM)):
        m.integrate_depth(*frames[2], cam)
        for _ in range(3):
            m.decay()
        m.integrate_depth(*frames[3], cam)
        m.clear_outside_radius((0.5, 0.0, 1.0), 2.0)
        m.clear_tsdf_inside_shapes(spheres=[((1.5, 1.0, 1.0), 0.7)])
    want, got = jax_mapper_arrays(j), t.state_arrays()
    assert int(want["removed_count"]) > 100
    for f in STATE + ("removed_log", "removed_count"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(t.dirty.numpy(), np.asarray(j.dirty))
    from test_torch_device_mapper import assert_tsdf_matches
    assert_tsdf_matches(got, want, [T for _, T in frames], TCAM)
