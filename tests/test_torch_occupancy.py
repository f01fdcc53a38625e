"""Port vs reference: occupancy fusion (plain version of occupancy_fuse)
and the occupancy mapper as a whole (CPU).

The port's `integrate_occupancy` mirrors the reference's XLA path
(`ops/occupancy.py`); the Pallas kernel samples a decimation pyramid and is
held to the bounds of tests/test_occupancy_pallas.py. The slice test runs
the reference's occupancy DeviceMapper (its XLA integrator, its EDT kernels
in interpret mode) and the port's from the same start state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import esdf as jesdf
from isaac_ros_nvblox_tpu.ops import occupancy as jocc
from isaac_ros_nvblox_tpu.ops import view as jv
from isaac_ros_nvblox_tpu.ops.occupancy_pallas import (
    integrate_occupancy_pallas)
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.ops import esdf as tesdf
from isaac_ros_nvblox_tpu_torch.ops import occupancy as tocc
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams as TEsdf
from isaac_ros_nvblox_tpu_torch.ops.occupancy_cuda import (
    integrate_occupancy_cuda)
from test_torch_tsdf import (CAP, JCAM, TCAM, VOXEL, _pallas_setup,
                             near_rounding_tie)

torch.set_num_threads(2)

# Parameter corners: the defaults, a narrow band with tight clamps (the
# clamps bind within three frames), and a wide band with skewed odds.
CORNERS = {
    "default": {},
    "narrow_clamped": dict(occupied_region_half_width_m=0.05,
                           min_log_odds=-1.0, max_log_odds=1.2),
    "wide_skewed": dict(occupied_region_half_width_m=0.25,
                        free_region_occupancy_probability=0.45,
                        occupied_region_occupancy_probability=0.9),
}


@pytest.fixture(scope="module")
def orbit_batches():
    """Three orbit frames of the default scene with their occupancy view
    batches (3 m, half width 0.1 m as truncation), allocated by the
    reference."""
    st = jwg.create_world_grid(jwg.WorldGridConfig(
        dims=(48, 48, 24), capacity=CAP, origin_block=(-24, -24, -6)))
    out = []
    for k in range(3):
        T = js.orbit_pose(2 * np.pi * k / 8 + 0.1)
        depth = js.render_depth(js.default_test_scene(), JCAM, jnp.asarray(T))
        grid, origin = jv.touched_block_grid(
            depth, jnp.asarray(T), camera=JCAM, voxel_size_m=VOXEL,
            max_distance_m=3.0, truncation_m=0.1)
        st, slots, bidx, _ = jwg.allocate_and_batch(st, grid, origin,
                                                    max_blocks=1024)
        out.append((np.array(depth), T, np.array(slots), np.array(bidx)))
    return out


def _ties(batches):
    """Voxels that project onto a pixel-rounding tie from a batch's pose
    (a last-bit difference in the transform may sample the neighbour)."""
    ties = np.zeros((CAP, 512), bool)
    for _, T, slots, bidx in batches:
        ok = slots < CAP
        ties[slots[ok]] |= near_rounding_tie(bidx, T)[ok]
    return ties


@pytest.mark.parametrize("corner", list(CORNERS))
def test_integrate_occupancy_matches_reference(orbit_batches, corner):
    kw = dict(max_integration_distance_m=3.0, **CORNERS[corner])
    p_j = jocc.OccupancyIntegratorParams(**kw)
    p_t = tocc.OccupancyIntegratorParams(**kw)
    lo_j = jnp.zeros((CAP, 512), jnp.float32)
    ob_j = jnp.zeros((CAP, 512), jnp.uint8)
    lo_t = torch.zeros(CAP, 512)
    ob_t = torch.zeros(CAP, 512, dtype=torch.uint8)
    for depth, T, slots, bidx in orbit_batches:
        lo_j, ob_j = jocc.integrate_occupancy(
            lo_j, ob_j, jnp.asarray(slots), jnp.asarray(bidx),
            jnp.asarray(depth), jnp.asarray(T), camera=JCAM,
            voxel_size_m=VOXEL, params=p_j)
        integrate_occupancy_cuda(
            lo_t, ob_t, torch.from_numpy(slots), torch.from_numpy(bidx),
            torch.from_numpy(depth), torch.from_numpy(T), camera=TCAM,
            voxel_size_m=VOXEL, params=p_t)
    lo_j, ob_j = np.asarray(lo_j), np.asarray(ob_j)
    assert ob_t.dtype == torch.uint8
    assert (ob_j > 0).sum() > 20000 and (lo_j > 0).sum() > 500
    if corner == "narrow_clamped":
        assert (lo_j == np.float32(1.2)).any() and (lo_j == -1.0).any()
    # Equal on >= 99.9% of the voxels; the rest only at pixel-rounding ties.
    bad = (lo_t.numpy() != lo_j) | (ob_t.numpy() != ob_j)
    assert bad.mean() <= 1e-3, bad.sum()
    assert not (bad & ~_ties(orbit_batches)).any()


@pytest.mark.parametrize("layout", ["padded", "one_entry"])
def test_integrate_occupancy_batch_layouts_match_reference(orbit_batches,
                                                           layout):
    """The plain version, which the card kernel equals bit for bit, against
    the reference on batches the kernel's persistent walk treats specially:
    real entries turned into padding with slot -1 and slot == cap, and a
    batch of one entry; rows outside the batch untouched on both sides,
    from random start rows. The reference's `.at[]` reads slot -1 as row
    cap - 1 (Python indexing) where the port reads it as padding; its own
    allocator pads with cap, so the reference is given cap there."""
    depth, T, slots, bidx = orbit_batches[0]
    rng = np.random.RandomState(7)
    lo0 = np.clip(rng.randn(CAP, 512) * 3.0, -10.0, 10.0).astype(np.float32)
    ob0 = (rng.rand(CAP, 512) < 0.3).astype(np.uint8)
    kw = dict(max_integration_distance_m=3.0)
    p_j = jocc.OccupancyIntegratorParams(**kw)
    p_t = tocc.OccupancyIntegratorParams(**kw)

    def port(s, b):
        return [a.numpy() for a in tocc.integrate_occupancy(
            torch.from_numpy(lo0.copy()), torch.from_numpy(ob0.copy()),
            torch.from_numpy(s), torch.from_numpy(b),
            torch.from_numpy(depth), torch.from_numpy(T), camera=TCAM,
            voxel_size_m=VOXEL, params=p_t)]

    real = np.nonzero(slots < CAP)[0]
    if layout == "one_entry":
        # The real entry with the most updated voxels.
        lo_all = port(slots, bidx)[0]
        k = real[np.argmax((lo_all != lo0)[slots[real]].sum(1))]
        s, b = slots[k:k + 1].copy(), bidx[k:k + 1].copy()
    else:
        s, b = slots.copy(), bidx.copy()
        s[real[::5]] = -1
        s[real[2::7]] = CAP
    lo_t, ob_t = port(s, b)
    lo_j, ob_j = [np.asarray(a) for a in jocc.integrate_occupancy(
        jnp.asarray(lo0), jnp.asarray(ob0),
        jnp.asarray(np.where(s < 0, CAP, s).astype(np.int32)),
        jnp.asarray(b), jnp.asarray(depth), jnp.asarray(T), camera=JCAM,
        voxel_size_m=VOXEL, params=p_j)]
    inside = np.zeros(CAP, bool)
    inside[s[(s >= 0) & (s < CAP)]] = True
    assert inside.sum() == (1 if layout == "one_entry" else
                            len(real) - len(real[::5]) - len(
                                np.setdiff1d(real[2::7], real[::5])))
    for got, want, start in ((lo_t, lo_j, lo0), (ob_t, ob_j, ob0)):
        np.testing.assert_array_equal(got[~inside], start[~inside])
        np.testing.assert_array_equal(want[~inside], start[~inside])
    assert (lo_t[inside] != lo0[inside]).sum() > (
        100 if layout == "one_entry" else 20000)
    # Equal on >= 99.9% of the voxels; the rest only at pixel-rounding ties.
    bad = (lo_t != lo_j) | (ob_t != ob_j)
    assert bad.mean() <= 1e-3, bad.sum()
    assert not (bad & ~_ties(orbit_batches)).any()


def _pallas_pair(depth, seed=0):
    slots, bidx, T = _pallas_setup(seed)
    p = jocc.OccupancyIntegratorParams()
    lo_p, ob_p = integrate_occupancy_pallas(
        jnp.zeros((256, 512)), jnp.zeros((256, 512), jnp.uint8),
        jnp.asarray(slots), jnp.asarray(bidx), jnp.asarray(depth),
        jnp.asarray(T), camera=JCAM, voxel_size_m=VOXEL, params=p,
        interpret=jax.default_backend() == "cpu")
    lo_t, ob_t = tocc.integrate_occupancy(
        torch.zeros(256, 512), torch.zeros(256, 512, dtype=torch.uint8),
        torch.from_numpy(slots), torch.from_numpy(bidx),
        torch.from_numpy(depth), torch.from_numpy(T), camera=TCAM,
        voxel_size_m=VOXEL, params=tocc.OccupancyIntegratorParams())
    return (np.asarray(lo_p), np.asarray(ob_p)), (lo_t.numpy(), ob_t.numpy())


@pytest.mark.parametrize("depth_kind", ["flat", "textured"])
def test_matches_pallas_within_its_bounds(depth_kind):
    """The Pallas kernel's own test bounds (tests/test_occupancy_pallas.py
    :45-68): exact on a flat wall (decimation-invariant); on textured
    depth observed agreement > 0.995 and log-odds agreement > 0.97."""
    depth = np.full((JCAM.height, JCAM.width), 2.0, np.float32)
    if depth_kind == "textured":
        rng = np.random.RandomState(1)
        base = 2.0 + 0.3 * np.sin(np.linspace(0, 6, JCAM.width))[None, :]
        depth = (np.broadcast_to(base, depth.shape)
                 + rng.rand(*depth.shape) * 0.01).astype(np.float32)
    (lo_p, ob_p), (lo_t, ob_t) = _pallas_pair(depth)
    assert (ob_t > 0).sum() > 300
    if depth_kind == "flat":
        np.testing.assert_allclose(lo_t, lo_p, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ob_t, ob_p)
        return
    m_p, m_t = ob_p > 0, ob_t > 0
    assert (m_p == m_t).mean() > 0.995
    assert (lo_t[m_p & m_t] == lo_p[m_p & m_t]).mean() > 0.97


def test_padding_rows_untouched():
    slots, bidx, T = _pallas_setup()
    depth = torch.full((TCAM.height, TCAM.width), 2.0)
    lo = torch.zeros(256, 512)
    ob = torch.zeros(256, 512, dtype=torch.uint8)
    lo[100] = 7.0
    lo[255] = 3.0
    s = torch.tensor([0, 256, -1], dtype=torch.int32)
    # A block in free space before the wall, for every entry.
    b = torch.tensor([[0, 0, 2]] * 3, dtype=torch.int32)
    for fn in (tocc.integrate_occupancy, integrate_occupancy_cuda):
        fn(lo, ob, s, b, depth, torch.from_numpy(T), camera=TCAM,
           voxel_size_m=VOXEL, params=tocc.OccupancyIntegratorParams())
        assert bool((lo[100] == 7.0).all()) and bool((lo[255] == 3.0).all())
        assert bool(ob[0].any()) and not bool(ob[1:].any())


def test_sites_from_occupancy_match_reference():
    rng = np.random.RandomState(4)
    lo = rng.randn(64, 512).astype(np.float32)
    lo[::7] = 0.0
    obs = rng.rand(64, 512) < 0.6
    for thr in (0.0, 0.4):
        want = jesdf.esdf_sites_from_occupancy(
            jnp.asarray(lo), jnp.asarray(obs),
            occupied_log_odds_threshold=thr)
        got = tesdf.esdf_sites_from_occupancy(
            torch.from_numpy(lo), torch.from_numpy(obs),
            occupied_log_odds_threshold=thr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_params_and_layer_types_match_reference():
    for m in jp.MappingType:
        t = tp.MappingType(m.value)
        assert (tp.projective_layer_type(t).value
                == jp.projective_layer_type(m).value)
    jm, tm = jp.MapperParams(), tp.MapperParams()
    for group in ("occupancy", "tsdf_decay", "occupancy_decay"):
        assert (dataclasses.asdict(getattr(tm, group))
                == dataclasses.asdict(getattr(jm, group))), group


# ---------------------------------------------------------------------------
# The occupancy mapper as a whole
# ---------------------------------------------------------------------------

WORLD = dict(dims=(48, 48, 24), capacity=2048, origin_block=(-24, -24, -6))
STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")
ESDF = ("esdf_sq_dist", "esdf_is_inside", "esdf_observed")


def _occ_mappers():
    occ = dict(max_integration_distance_m=3.0)
    j = jdm.DeviceMapper(
        VOXEL, params=jp.MapperParams(
            occupancy=jocc.OccupancyIntegratorParams(**occ),
            esdf=jesdf.EsdfIntegratorParams(max_esdf_distance_m=0.6)),
        world=jwg.WorldGridConfig(**WORLD), enable_color=False,
        projective_layer=jp.ProjectiveLayerType.OCCUPANCY,
        max_blocks_per_frame=1024)
    t = tdm.DeviceMapper(
        VOXEL, params=tp.MapperParams(
            occupancy=tocc.OccupancyIntegratorParams(**occ),
            esdf=TEsdf(max_esdf_distance_m=0.6)),
        world=twg.WorldGridConfig(**WORLD),
        projective_layer=tp.ProjectiveLayerType.OCCUPANCY,
        max_blocks_per_frame=1024, device="cpu")
    return j, t


def jax_mapper_arrays(m):
    """The reference mapper's state, channels and removed ring as numpy."""
    out = {f: np.asarray(getattr(m.state, f)) for f in STATE}
    out.update({k: np.asarray(v) for k, v in m.channels.items()})
    out["removed_log"] = np.asarray(m.removed_log)
    out["removed_count"] = np.asarray(m.removed_count)
    return out


@pytest.mark.parametrize("occ_m,proj_m", [(5.0, 2.0), (2.0, 5.0)])
def test_occupancy_region_covers_its_blocks(occ_m, proj_m):
    """An occupancy layer allocates out to the occupancy params' max
    distance, whatever the projective one: the host-tracked AABB (the
    frame of the ESDF solves) holds every block a frame allocated, and
    no more than that distance's frustum."""
    from isaac_ros_nvblox_tpu_torch.ops import view as tview
    scene = js.default_test_scene()
    T = js.orbit_pose(0.3, radius=1.8)
    depth = np.array(js.render_depth(scene, JCAM, jnp.asarray(T)))
    t = tdm.DeviceMapper(
        VOXEL, params=tp.MapperParams(
            projective=tp.TsdfIntegratorParams(
                max_integration_distance_m=proj_m),
            occupancy=tocc.OccupancyIntegratorParams(
                max_integration_distance_m=occ_m)),
        world=twg.WorldGridConfig(**WORLD),
        projective_layer=tp.ProjectiveLayerType.OCCUPANCY,
        max_blocks_per_frame=1024, device="cpu")
    t.integrate_depth(depth, T, TCAM)
    a = t.state_arrays()
    blocks = a["block_index_of_slot"][:int(a["alloc_count"])]
    assert len(blocks) > 0
    assert (blocks >= t._aabb_lo).all() and (blocks <= t._aabb_hi).all()
    lo, hi = tview.frustum_block_aabb(np.asarray(T), TCAM, occ_m, VOXEL)
    w_lo = np.asarray(WORLD["origin_block"])
    w_hi = w_lo + np.asarray(WORLD["dims"]) - 1
    np.testing.assert_array_equal(t._aabb_lo, np.maximum(lo, w_lo))
    np.testing.assert_array_equal(t._aabb_hi, np.minimum(hi, w_hi))


def test_occupancy_mapper_matches_reference():
    """Two frames by the reference, loaded into the port; then on both
    sides: frame, decay (frees the blocks no frame updated), frame (which
    re-allocates recycled slots), ESDF from occupied sites, decay."""
    scene = js.default_test_scene()
    frames = []
    for k in range(4):
        T = js.orbit_pose(2 * np.pi * k / 8, radius=1.8)
        frames.append((np.array(js.render_depth(scene, JCAM, jnp.asarray(T))),
                       T))
    j, t = _occ_mappers()
    for depth, T in frames[:2]:
        j.integrate_depth(depth, T, JCAM)
    t.load_state_arrays(jax_mapper_arrays(j))
    ties = np.zeros((WORLD["capacity"], 512), bool)
    for m, cam in ((j, JCAM), (t, TCAM)):
        m.integrate_depth(*frames[2], cam)
        m.decay()
        m.integrate_depth(*frames[3], cam)
        m.update_esdf()
        m.decay()
    want, got = jax_mapper_arrays(j), t.state_arrays()
    assert int(want["removed_count"]) > 100
    assert int(want["free_count"]) > 0
    for f in STATE + ("removed_log", "removed_count"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    bidx = want["block_index_of_slot"]
    for _, T in frames[2:]:
        ties |= near_rounding_tie(bidx, T)
    bad = ((got["occupancy_log_odds"] != want["occupancy_log_odds"])
           | (got["occupancy_observed"] != want["occupancy_observed"]))
    assert (want["occupancy_observed"] > 0).sum() > 20000
    assert bad.mean() <= 1e-3 and not (bad & ~ties).any(), bad.sum()
    # The ESDF from occupied sites: the maps agree voxel for voxel here, so
    # the integer distances are exact.
    assert (want["esdf_sq_dist"] < 1e11).sum() > 10000
    assert not bad.any()
    for c in ESDF:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    with pytest.raises(NotImplementedError):
        t.integrate_pointcloud(np.zeros((4, 3), np.float32), np.eye(4), None)
