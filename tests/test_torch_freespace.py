"""Port vs reference: the freespace state machine, the halo gathers and the
3^3 occupancy dilation (plain version of kernel dilate_dense), and the
mapper's freespace step in both of its forms (CPU).

The state machine and the dilation are exact functions: equal to the
reference bit for bit. The mapper's step starts from a map the reference
built; its frustum test reads the transform in XLA's accumulation order,
so a voxel may flip where the two differ in the last bit at the frustum's
edge or where a TSDF value sits at the occupancy threshold.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core.world_grid import WorldGridConfig as JWorld
from isaac_ros_nvblox_tpu.mapper import device_mapper as jdm
from isaac_ros_nvblox_tpu.mapper.params import MapperParams as JParams
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu.ops import freespace as jfs
from isaac_ros_nvblox_tpu.ops import halo as jhalo
from isaac_ros_nvblox_tpu.ops.tsdf import TsdfIntegratorParams as JTsdf
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as tdm
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams as TParams
from isaac_ros_nvblox_tpu_torch.ops import freespace as tfs
from isaac_ros_nvblox_tpu_torch.ops import halo as thalo
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams as TTsdf
from test_torch_occupancy import jax_mapper_arrays
from test_torch_tsdf import JCAM, TCAM, VOXEL

torch.set_num_threads(2)

FS = ("freespace_consecutive_ms", "freespace_last_occupied_ms",
      "freespace_high_confidence")


def _state(seed, cap=64, n=40):
    """Random freespace rows, TSDF rows and a view batch in front of a
    camera at the origin looking along +z (padding entries included)."""
    rng = np.random.default_rng(seed)
    cons = np.where(rng.random((cap, 512)) < 0.5, 0.0,
                    rng.uniform(0, 2500, (cap, 512))).astype(np.float32)
    last = np.where(rng.random((cap, 512)) < 0.3, -1e9,
                    rng.uniform(2500, 5000, (cap, 512))).astype(np.float32)
    hc = rng.random((cap, 512)) < 0.4
    d = rng.uniform(-0.2, 0.4, (cap, 512)).astype(np.float32)
    w = np.where(rng.random((cap, 512)) < 0.3, 0.0,
                 rng.uniform(0, 3, (cap, 512))).astype(np.float32)
    cells = np.stack(np.meshgrid(np.arange(-3, 3), np.arange(-3, 3),
                                 np.arange(1, 8), indexing="ij"), -1)
    bidx = rng.permutation(cells.reshape(-1, 3))[:n].astype(np.int32)
    slots = rng.permutation(cap)[:n].astype(np.int32)
    slots = np.concatenate([slots, [cap, cap]]).astype(np.int32)
    bidx = np.concatenate([bidx, [[0, 0, 0], [0, 0, 0]]]).astype(np.int32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.05, -0.1, 0.2)
    rows = np.where(rng.random((n + 2, 512)) < 0.5, -0.85, 1e3).astype(
        np.float32)
    in_view = rng.random((cap, 512)) < 0.7
    return dict(cons=cons, last=last, hc=hc, d=d, w=w, slots=slots,
                bidx=bidx, T=T, rows=rows, in_view=in_view)


@pytest.mark.parametrize("form", ["batch", "batch_rows", "fullpool"])
def test_update_freespace_matches_reference(form):
    s = _state(3)
    fp = dict(max_unobserved_to_keep_consecutive_occupancy_ms=250.0,
              min_duration_since_occupied_for_freespace_ms=1000.0,
              min_consecutive_occupancy_duration_for_reset_ms=2000.0)
    pj, pt = jfs.FreespaceIntegratorParams(**fp), \
        tfs.FreespaceIntegratorParams(**fp)
    t, t0 = 5000.0, 4700.0
    chans_j = [jnp.asarray(s[k]) for k in ("cons", "last", "hc")]
    chans_t = [torch.from_numpy(s[k].copy()) for k in ("cons", "last", "hc")]
    tt = (torch.tensor(t, dtype=torch.float32),
          torch.tensor(t0, dtype=torch.float32))
    if form == "fullpool":
        want = jfs.update_freespace_fullpool(
            *chans_j, jnp.asarray(s["d"]), jnp.asarray(s["w"]),
            jnp.asarray(s["in_view"]), jnp.float32(t), jnp.float32(t0),
            params=pj)
        got = tfs.update_freespace_fullpool(
            *chans_t, torch.from_numpy(s["d"]), torch.from_numpy(s["w"]),
            torch.from_numpy(s["in_view"]), *tt, params=pt)
    else:
        rows = s["rows"] if form == "batch_rows" else None
        want = jfs.update_freespace(
            *chans_j, jnp.asarray(s["d"]), jnp.asarray(s["w"]),
            jnp.asarray(s["slots"]), jnp.asarray(s["bidx"]),
            jnp.asarray(s["T"]), jnp.float32(t), jnp.float32(t0),
            camera=JCAM, voxel_size_m=VOXEL, params=pj,
            distance_rows=None if rows is None else jnp.asarray(rows))
        got = tfs.update_freespace(
            *chans_t, torch.from_numpy(s["d"]), torch.from_numpy(s["w"]),
            torch.from_numpy(s["slots"]), torch.from_numpy(s["bidx"]),
            torch.from_numpy(s["T"]), *tt, camera=TCAM, voxel_size_m=VOXEL,
            params=pt,
            distance_rows=None if rows is None else torch.from_numpy(rows))
    changed = 0
    for g, w, k in zip(got, want, ("cons", "last", "hc")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
        changed += int((np.asarray(w) != s[k]).sum())
    assert changed > 2000


@pytest.mark.parametrize("lo,hi", [(1, 1), (0, 1), (1, 0)])
def test_gather_halo_sliced_matches_reference(lo, hi):
    rng = np.random.default_rng(lo * 2 + hi)
    cap, n = 24, 10
    ch = rng.random((cap, 8, 8, 8)).astype(np.float32)
    nbrs = rng.integers(-1, cap, (n, 27)).astype(np.int32)
    want = np.asarray(jhalo.gather_halo_sliced(
        jnp.asarray(ch), jnp.asarray(nbrs), lo=lo, hi=hi, fill=-2.0))
    got = thalo.gather_halo_sliced(torch.from_numpy(ch),
                                   torch.from_numpy(nbrs), lo=lo, hi=hi,
                                   fill=-2.0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        thalo.gather_halo(torch.from_numpy(ch), torch.from_numpy(nbrs),
                          lo=lo, hi=hi, fill=-2.0).numpy(), want)


def _pool_in_region(dims, seed, cap=48):
    """An occupancy-indicator pool: live blocks in cells of a region at
    `origin` (some outside it, some freed) and rows beyond alloc_count."""
    rng = np.random.default_rng(seed)
    origin = np.array([-3, 2, -1], np.int32)
    cells = np.stack(np.meshgrid(*[np.arange(-1, d + 1) for d in dims],
                                 indexing="ij"), -1).reshape(-1, 3)
    pick = rng.permutation(len(cells))[:min(cap - 8, len(cells))]
    bidx = np.full((cap, 3), 1 << 20, np.int32)
    bidx[:len(pick)] = cells[pick] + origin
    bidx[1] = 1 << 20                  # a freed slot
    vals = (rng.random((cap, 512)) < 0.02).astype(np.float32)
    return vals, bidx, origin, len(pick)


@pytest.mark.parametrize("dims", [(4, 3, 5), (2, 2, 1), (1, 3, 2)])
def test_dilate_occupancy_dense_matches_reference(dims):
    vals, bidx, origin, n = _pool_in_region(dims, sum(dims))
    want = np.asarray(jhalo.dilate_occupancy_dense(
        jnp.asarray(vals), None, jnp.asarray(origin), dims_b=dims,
        block_index_of_slot=jnp.asarray(bidx), alloc_count=jnp.int32(n)))
    got = thalo.dilate_occupancy_dense(
        torch.from_numpy(vals), None, torch.from_numpy(origin), dims_b=dims,
        block_index_of_slot=torch.from_numpy(bidx),
        alloc_count=torch.tensor(n, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > vals).sum() > 100          # it did dilate
    assert (want[n:] == vals[n:]).all()       # rows past alloc keep theirs


@pytest.mark.parametrize("dims", [(3, 2, 5), (1, 4, 3), (2, 1, 1)])
def test_dilate_dense_grid_plain_matches_pallas(dims):
    rng = np.random.default_rng(dims[0] * 7 + dims[2])
    # Values >= 0, not only {0, 1}.
    grid = np.where(rng.random(dims + (512,)) < 0.05,
                    rng.uniform(0, 5, dims + (512,)), 0.0).astype(np.float32)
    want = np.asarray(jhalo.dilate_dense_grid_pallas(
        jnp.asarray(grid), dims_b=dims, interpret=True))
    got = thalo.dilate_dense_grid_plain(torch.from_numpy(grid))
    np.testing.assert_array_equal(got.numpy(), want)
    # The wrapper takes the plain version for a CPU tensor.
    np.testing.assert_array_equal(
        thalo.dilate_dense_grid(torch.from_numpy(grid)).numpy(), want)


WORLD = dict(dims=(64, 64, 32), capacity=4096, origin_block=(-32, -32, -8))
ROOM = js.Scene(primitives=(
    js.RoomBox(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
    js.Box(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4))))


@pytest.fixture(scope="module")
def built():
    """The reference's freespace mapper after 6 orbit frames 300 ms apart
    (the fixture of tests/test_detect_pallas.py, 5 m), then the TSDF of a
    7th frame in which a sphere has appeared in the confident freespace;
    and that frame's pose."""
    jm = jdm.DeviceMapper(
        VOXEL, params=JParams(projective=JTsdf(max_integration_distance_m=5.0)),
        world=JWorld(**WORLD), enable_color=False, enable_freespace=True,
        max_blocks_per_frame=2048)
    for k in range(6):
        T = jnp.asarray(js.orbit_pose(2 * np.pi * k / 8, radius=1.5))
        jm.integrate_depth(js.render_depth(ROOM, JCAM, T), T, JCAM)
        jm.update_freespace(k * 300.0, T, JCAM)
    T = js.orbit_pose(2 * np.pi * 6 / 8, radius=1.5)
    popped = js.Scene(primitives=ROOM.primitives + (
        js.Sphere(center=(0.5, 0.3, 1.0), radius=0.35),))
    jm.integrate_depth(js.render_depth(popped, JCAM, jnp.asarray(T)),
                       jnp.asarray(T), JCAM)
    # Copies: the reference's steps below donate their inputs.
    arrays = {k: np.array(v) for k, v in jax_mapper_arrays(jm).items()}
    arrays["freespace_last_update_ms"] = np.float32(
        jm._freespace_last_update_ms)
    return jm, arrays, T


@pytest.mark.parametrize("form", ["fallback", "fast", "fast_bucket"])
def test_freespace_fused_matches_reference(built, form):
    jm, arrays, T = built
    tm = tdm.DeviceMapper(
        VOXEL, params=TParams(projective=TTsdf(max_integration_distance_m=5.0)),
        world=twg.WorldGridConfig(**WORLD), enable_color=False,
        enable_freespace=True, max_blocks_per_frame=2048, device="cpu")
    tm.load_state_arrays(arrays)
    n = int(arrays["alloc_count"])
    live = arrays["block_index_of_slot"][:n]
    origin = live.min(0)
    dims = tuple(int(d) for d in live.max(0) - origin + 1)
    fast = form != "fallback"
    sb = 3072 if form == "fast_bucket" else 0
    assert n <= 3072
    kw = dict(voxel_size_m=VOXEL, view_distance_m=5.0, max_blocks=2048,
              dims_b=dims if fast else None, slot_bucket=sb)
    # 300 ms of occupancy resets the sphere's voxels (the demotion path).
    reset = dict(min_consecutive_occupancy_duration_for_reset_ms=200.0)
    want = jdm._freespace_fused(
        *[jnp.asarray(arrays[k]) for k in FS], jm.state,
        jnp.asarray(arrays["tsdf_distance"]),
        jnp.asarray(arrays["tsdf_weight"]), jnp.asarray(T),
        jnp.float32(1800.0), jnp.float32(1500.0),
        jnp.asarray(origin) if fast else None, camera=JCAM,
        params=dataclasses.replace(jm.params.freespace, **reset), **kw)
    ch = tm.channels
    tdm._freespace_fused(
        *[ch[k] for k in FS], tm.state, ch["tsdf_distance"],
        ch["tsdf_weight"], torch.from_numpy(T), torch.tensor(1800.0),
        torch.tensor(1500.0), torch.from_numpy(origin) if fast else None,
        camera=TCAM, params=dataclasses.replace(tm.params.freespace, **reset),
        **kw)
    want = [np.asarray(w) for w in want]
    assert want[2].sum() > 50000                  # confident freespace
    changed = {k: int((w != arrays[k]).sum()) for k, w in zip(FS, want)}
    assert min(changed.values()) > 500, changed
    for k, w in zip(FS, want):
        bad = ch[k].numpy() != w
        assert bad.mean() <= 1e-3, (k, int(bad.sum()), changed)
