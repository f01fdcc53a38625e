"""CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (CUDA kernels have no CPU mode),
carry the `cuda` marker and skip elsewhere. This file imports no JAX, so
it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.scene import (default_test_scene,
                                                     orbit_pose, render_color,
                                                     render_depth)
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
from isaac_ros_nvblox_tpu_torch.ops import mesh_cuda as mc
from isaac_ros_nvblox_tpu_torch.ops.color import (integrate_color_planar,
                                                  integrate_tsdf_color)
from isaac_ros_nvblox_tpu_torch.ops.color_cuda import integrate_color_cuda
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                 WeightingFunctionType,
                                                 integrate_tsdf)
from isaac_ros_nvblox_tpu_torch.ops.tsdf_color_cuda import (
    integrate_tsdf_color_cuda)
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda
from isaac_ros_nvblox_tpu_torch.ops.view import (ViewCalculatorParams,
                                                 WorkspaceBoundsType)
from isaac_ros_nvblox_tpu_torch.core.types import (Transform,
                                                   voxel_centers_for_blocks)
from isaac_ros_nvblox_tpu_torch.mapper.params import ProjectiveLayerType
from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
from isaac_ros_nvblox_tpu_torch.ops.decay import TsdfDecayParams
from isaac_ros_nvblox_tpu_torch.ops.lidar_cuda import (
    integrate_tsdf_lidar_cuda)
from isaac_ros_nvblox_tpu_torch.ops.occupancy import (
    OccupancyIntegratorParams, integrate_occupancy)
from isaac_ros_nvblox_tpu_torch.ops.occupancy_cuda import (
    integrate_occupancy_cuda)
from isaac_ros_nvblox_tpu_torch.ops.tsdf import integrate_tsdf_lidar
from isaac_ros_nvblox_tpu_torch.mapper.multi_mapper import MultiMapper
from isaac_ros_nvblox_tpu_torch.mapper.params import (MappingType,
                                                      MultiMapperParams)
from isaac_ros_nvblox_tpu_torch.ops.detect import detect_dynamic_plain
from isaac_ros_nvblox_tpu_torch.ops.detect_cuda import detect_dynamic
from isaac_ros_nvblox_tpu_torch.ops.halo import (dilate_dense_grid,
                                                 dilate_dense_grid_plain)

pytestmark = pytest.mark.cuda

CAM = Camera(fx=160.0, fy=160.0, cx=79.5, cy=59.5, width=160, height=120)
VOXEL = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tsdf_setup(dev, seed=0, cap=256, n_blocks=96):
    rng = np.random.RandomState(seed)
    bidx = np.stack([rng.randint(-6, 6, n_blocks), rng.randint(-5, 5, n_blocks),
                     rng.randint(1, 11, n_blocks)], 1).astype(np.int32)
    bidx = np.unique(bidx, axis=0)
    n = bidx.shape[0]
    slots = np.concatenate([np.arange(n), [cap, -1]]).astype(np.int32)
    bidx = np.concatenate([bidx, [[0, 0, 0], [1, 1, 1]]]).astype(np.int32)
    # A small rotation about a random axis (Rodrigues), camera behind the
    # layer origin.
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    a = 0.15
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
    T[2, 3] = -0.4
    base = 2.0 + 0.3 * np.sin(np.linspace(0, 6, CAM.width))[None, :]
    depth = (np.broadcast_to(base, (CAM.height, CAM.width))
             + rng.rand(CAM.height, CAM.width) * 0.05).astype(np.float32)
    depth[::13, ::7] = np.nan
    d0 = (rng.randn(cap, 512) * 0.05).astype(np.float32)
    w0 = (rng.rand(cap, 512) * 2.0).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)
    return t(d0), t(w0), t(slots), t(bidx), t(depth), t(T.astype(np.float32))


@pytest.mark.parametrize("mode", list(WeightingFunctionType))
def test_tsdf_fuse_matches_plain(dev, mode):
    d0, w0, slots, bidx, depth, T = _tsdf_setup(dev)
    params = TsdfIntegratorParams(weighting_mode=mode)
    d_ref, w_ref = integrate_tsdf(d0.clone(), w0.clone(), slots, bidx, depth,
                                  T, camera=CAM, voxel_size_m=VOXEL,
                                  params=params)
    before = kernels.LAUNCHES["tsdf_fuse"]
    d_k, w_k = integrate_tsdf_cuda(d0.clone(), w0.clone(), slots, bidx, depth,
                                   T, camera=CAM, voxel_size_m=VOXEL,
                                   params=params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tsdf_fuse"] == before + 1
    assert int((w_ref != w0).sum()) > 500  # something was integrated
    # Same float32 steps on both sides (core/types.py): exact.
    torch.testing.assert_close(d_k, d_ref, rtol=0, atol=0)
    torch.testing.assert_close(w_k, w_ref, rtol=0, atol=0)


def test_tsdf_fuse_padding_rows_untouched(dev):
    d0, w0, slots, bidx, depth, T = _tsdf_setup(dev)
    d0[100] = 7.0
    d_k, _ = integrate_tsdf_cuda(d0, w0, slots[:1], bidx[:1], depth, T,
                                 camera=CAM, voxel_size_m=VOXEL,
                                 params=TsdfIntegratorParams())
    torch.cuda.synchronize()
    assert bool((d_k[100] == 7.0).all())


# Batch layouts of the fusion kernels' persistent walk: (N entries, real
# entries at the front, dropped entries among them). allocate_and_batch puts
# the real entries first and fills the rest with slot == cap; a dropped
# entry (pool full) also carries cap, and -1 marks padding elsewhere.
LAYOUTS = {
    "mostly_padding": (4096, 40, False),
    "dropped_inside": (1024, 600, True),
    "n1": (1, 1, False),
    "below_grid": (100, 100, False),
    "bucket_8192": (8192, 8000, True),
    "bucket_16384": (16384, 16384, False),
}


def _layout_batch(layout, blocks, hot, rng):
    """slots i32[N] and block indices i32[N, 3] for LAYOUTS[layout], the
    real entries drawn from `blocks` (distinct; the `hot` ones, which the
    frame updates, first) and given distinct slots of a pool of
    len(blocks) rows; returns (slots, bidx, cap)."""
    n, n_real, dropped = LAYOUTS[layout]
    cap = blocks.shape[0]
    cold = np.setdiff1d(np.arange(cap), hot)
    pick = np.concatenate([rng.permutation(hot),
                           rng.permutation(cold)])[:n_real]
    slots = np.full(n, cap, np.int32)
    bidx = np.zeros((n, 3), np.int32)
    slots[:n_real] = rng.permutation(cap)[:n_real]
    bidx[:n_real] = blocks[pick]
    if dropped:
        slots[:n_real:7] = cap
        slots[3:n_real:11] = -1
    return slots, bidx, cap


def _tsdf_rows(rng, cap, dev):
    """Random TSDF pool rows (distance, weight) f32[cap, 512]."""
    d0 = (rng.randn(cap, 512) * 0.05).astype(np.float32)
    w0 = (rng.rand(cap, 512) * 2.0).astype(np.float32)
    return torch.as_tensor(d0, device=dev), torch.as_tensor(w0, device=dev)


def _check_layout(dev, layout, blocks, image, T, fuse, plain, name, seed,
                  make_rows=_tsdf_rows, marker=1):
    """`fuse` (a kernel wrapper) equals `plain` on the layout's batch, bit
    for bit, with every row outside the batch untouched. The pool rows come
    from `make_rows`; row `marker` of them shows which blocks an update
    reached (the weight by default)."""
    rng = np.random.RandomState(seed)
    cap = blocks.shape[0]
    rows = make_rows(rng, cap, dev)
    # The blocks the frame updates, from the plain version on all of them.
    every = torch.arange(cap, dtype=torch.int32, device=dev)
    m_all = plain(*[r.clone() for r in rows], every,
                  torch.as_tensor(blocks, device=dev), image, T)[marker]
    hot = torch.nonzero((m_all != rows[marker]).any(1))[:, 0].cpu().numpy()
    assert hot.size > 0
    slots, bidx, cap = _layout_batch(layout, blocks, hot, rng)
    s_t = torch.as_tensor(slots, device=dev)
    b_t = torch.as_tensor(bidx, device=dev)
    want = plain(*[r.clone() for r in rows], s_t, b_t, image, T)
    before = kernels.LAUNCHES[name]
    got = fuse(*[r.clone() for r in rows], s_t, b_t, image, T)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    real = torch.as_tensor(slots[(slots >= 0) & (slots < cap)],
                           device=dev).long()
    assert int((want[marker][real] != rows[marker][real]).sum()) > 0
    outside = torch.ones(cap, dtype=torch.bool, device=dev)
    outside[real] = False
    for g, w, base in zip(got, want, rows):
        assert torch.equal(g, w)
        assert torch.equal(g[outside], base[outside])


def _layout_blocks():
    """The layout tests' blocks: a 32 x 32 x 16 cube in front of the
    camera, one pool row each."""
    g = np.stack(np.meshgrid(np.arange(-16, 16), np.arange(-16, 16),
                             np.arange(1, 17), indexing="ij"), -1)
    return g.reshape(-1, 3).astype(np.int32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tsdf_fuse_batch_layouts(dev, layout):
    """Padding, dropped entries and batches from 1 entry to many times the
    persistent grid: bit-exact, rows outside the batch untouched."""
    blocks = _layout_blocks()
    _, _, _, _, depth, T = _tsdf_setup(dev)
    kw = dict(camera=CAM, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(max_integration_distance_m=6.0))
    _check_layout(dev, layout, blocks, depth, T,
                  lambda *a: integrate_tsdf_cuda(*a, **kw),
                  lambda *a: integrate_tsdf(*a, **kw), "tsdf_fuse", seed=1)


def _color_setup(dev, seed=0, depth_shape=None, color_dtype=torch.uint8):
    d0, w0, slots, bidx, depth, T = _tsdf_setup(dev, seed)
    cap = d0.shape[0]
    g = torch.Generator(device="cpu").manual_seed(seed)
    chans = [(torch.rand(cap, 512, generator=g) * 255).to(dev)
             for _ in range(3)] + [torch.rand(cap, 512, generator=g).to(dev)]
    color = (torch.rand(CAM.height, CAM.width, 3, generator=g) * 255).to(
        color_dtype).to(dev)
    if depth_shape is not None:
        depth = torch.nn.functional.interpolate(
            torch.nan_to_num(depth)[None, None], size=depth_shape)[0, 0]
    return d0, w0.clamp_min(0.5), chans, slots, bidx, depth, T, color


@pytest.mark.parametrize("mode", list(WeightingFunctionType))
@pytest.mark.parametrize("depth_kind", ["aligned", "half", "zero"])
def test_color_fuse_matches_plain(dev, mode, depth_kind):
    d0, w0, chans, slots, bidx, depth, T, color = _color_setup(
        dev, depth_shape=(60, 80) if depth_kind == "half" else None,
        color_dtype=torch.float32 if depth_kind == "zero" else torch.uint8)
    if depth_kind == "zero":
        depth = torch.zeros_like(depth)
    kw = dict(camera=CAM, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(weighting_mode=mode))
    want = integrate_color_planar(*[c.clone() for c in chans], d0, w0, slots,
                                  bidx, color, depth, T, **kw)
    before = kernels.LAUNCHES["color_fuse"]
    got = integrate_color_cuda(*[c.clone() for c in chans], d0, w0, slots,
                               bidx, color, depth, T, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["color_fuse"] == before + 1
    assert int((want[3] != chans[3]).sum()) > 500
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", list(WeightingFunctionType))
def test_tsdf_color_fuse_matches_plain_and_sequence(dev, mode):
    d0, w0, chans, slots, bidx, depth, T, color = _color_setup(dev, 1)
    kw = dict(camera=CAM, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(weighting_mode=mode))
    rows = [d0, w0] + chans
    want = integrate_tsdf_color(*[r.clone() for r in rows], slots, bidx,
                                depth, color, T, **kw)
    before = kernels.LAUNCHES["tsdf_color_fuse"]
    got = integrate_tsdf_color_cuda(*[r.clone() for r in rows], slots, bidx,
                                    depth, color, T, **kw)
    # tsdf_fuse then color_fuse on the same batch, bit for bit.
    seq = [r.clone() for r in rows]
    integrate_tsdf_cuda(seq[0], seq[1], slots, bidx, depth, T, **kw)
    integrate_color_cuda(*seq[2:], seq[0], seq[1], slots, bidx, color, depth,
                         T, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tsdf_color_fuse"] == before + 1
    assert int((want[5] != chans[3]).sum()) > 500
    for g, w, q in zip(got, want, seq):
        assert torch.equal(g, w)
        assert torch.equal(g, q)


def _color_rows(rng, cap, dev):
    """Random color pool rows r, g, b (0-255) and weight f32[cap, 512]."""
    rows = [rng.rand(cap, 512) * 255 for _ in range(3)] + [rng.rand(cap, 512)]
    return [torch.as_tensor(a.astype(np.float32), device=dev) for a in rows]


def _color_image(dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.rand(CAM.height, CAM.width, 3, generator=g) * 255).to(
        torch.uint8).to(dev)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tsdf_color_fuse_batch_layouts(dev, layout):
    """The fused TSDF + color kernel on the fusion kernels' batch layouts:
    all six channels bit for bit, rows outside the batch untouched."""
    _, _, _, _, depth, T = _tsdf_setup(dev)
    color = _color_image(dev, 2)
    kw = dict(camera=CAM, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(max_integration_distance_m=6.0))

    def rows(rng, cap, dev):
        return list(_tsdf_rows(rng, cap, dev)) + _color_rows(rng, cap, dev)

    def with_color(fn):
        # (*rows, slots, bidx, depth, T) -> fn(..., depth, color, T)
        return lambda *a: fn(*a[:-1], color, a[-1], **kw)

    _check_layout(dev, layout, _layout_blocks(), depth, T,
                  with_color(integrate_tsdf_color_cuda),
                  with_color(integrate_tsdf_color), "tsdf_color_fuse",
                  seed=5, make_rows=rows, marker=5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("depth_kind",
                         ["aligned", "half", "zero", "mostly_free"])
def test_color_fuse_batch_layouts(dev, layout, depth_kind):
    """The color kernel on the fusion kernels' batch layouts, with the
    TSDF rows read only: aligned, half-resolution and all-zero (no
    occlusion test) depths, and TSDF rows of which 95% lie beyond the
    truncation (most voxels fail the near-surface test); the four color
    rows bit for bit, rows outside the batch untouched."""
    blocks = _layout_blocks()
    cap = blocks.shape[0]
    _, _, _, _, depth, T = _tsdf_setup(dev)
    depth = torch.nan_to_num(depth)
    if depth_kind == "half":
        depth = torch.nn.functional.interpolate(depth[None, None],
                                                size=(60, 80))[0, 0]
    elif depth_kind == "zero":
        depth = torch.zeros_like(depth)
    rng = np.random.RandomState(6)
    d0, w0 = _tsdf_rows(rng, cap, dev)
    if depth_kind == "mostly_free":
        free = torch.as_tensor(rng.rand(cap, 512) < 0.95, device=dev)
        d0 = torch.where(free, torch.full_like(d0, 0.5), d0)
    color = _color_image(dev, 3)
    kw = dict(camera=CAM, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(max_integration_distance_m=6.0))

    def call(fn):
        # (r, g, b, w, slots, bidx, depth, T) -> fn with the TSDF rows
        return lambda *a: fn(*a[:4], d0, w0, a[4], a[5], color, a[6], a[7],
                             **kw)

    _check_layout(dev, layout, blocks, depth.contiguous(), T,
                  call(integrate_color_cuda), call(integrate_color_planar),
                  "color_fuse", seed=7, make_rows=_color_rows, marker=3)


@pytest.mark.parametrize("with_color", [True, False])
def test_marching_cubes_matches_plain(dev, with_color):
    """Sphere SDF blocks with noisy weights, absent neighbours and padding
    rows: all three bf16 outputs bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(5)
    side = 4
    r = torch.arange(side)
    cells = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    n = cells.shape[0]
    cap = n + 4
    lane = torch.arange(512)
    local = torch.stack([lane // 64, (lane // 8) % 8, lane % 8], -1)
    p = ((cells[:, None] * 8 + local[None]).float() + 0.5) * VOXEL
    sdf = torch.linalg.norm(p - 0.8, dim=-1) - 0.55
    d = torch.zeros(cap, 512)
    d[:n] = sdf.clamp(-0.2, 0.2)
    w = torch.zeros(cap, 512)
    w[:n] = torch.where(torch.rand(n, 512, generator=g) < 0.05, 1e-5, 1.0)
    cols = [torch.rand(cap, 512, generator=g) * 255 for _ in range(3)]
    slot_of = {tuple(c): i for i, c in enumerate(cells.tolist())}
    nbr8 = torch.tensor([[slot_of.get((c[0] + o[0], c[1] + o[1], c[2] + o[2]),
                                      -1) for o in wg.OCTANT_OFFSETS.tolist()]
                         for c in cells.tolist()], dtype=torch.int32)
    nbr8[::7, 3] = -1
    valid = torch.ones(n, dtype=torch.int32)
    valid[::11] = 0
    args = [t.to(dev) for t in (d, w)]
    crows = tuple(c.to(dev) for c in cols) if with_color else None
    kw = dict(min_weight=1e-4, with_color=with_color)
    want = mc.marching_cubes_plain(*args, crows, nbr8.to(dev), valid.to(dev),
                                   **kw)
    before = kernels.LAUNCHES["marching_cubes"]
    got = mc.marching_cubes_fused(*args, crows, nbr8.to(dev), valid.to(dev),
                                  **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["marching_cubes"] == before + 1
    assert float(want[2][:, 0].float().sum()) > 500
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _sphere_pool(side, g, extra=4):
    """Pool rows of a side^3 cube of blocks holding a clipped sphere SDF,
    weights with 5% below the 1e-4 mesh threshold, random colors, and the
    blocks' nbr8 rows (-1 where the neighbour lies outside the cube)."""
    r = torch.arange(side)
    cells = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(
        -1, 3)
    n = cells.shape[0]
    cap = n + extra
    lane = torch.arange(512)
    local = torch.stack([lane // 64, (lane // 8) % 8, lane % 8], -1)
    p = ((cells[:, None] * 8 + local[None]).float() + 0.5) * VOXEL
    c = side * 8 * VOXEL / 2
    sdf = torch.linalg.norm(p - c, dim=-1) - 0.7 * c
    d = torch.zeros(cap, 512)
    d[:n] = sdf.clamp(-0.2, 0.2)
    w = torch.zeros(cap, 512)
    w[:n] = torch.where(torch.rand(n, 512, generator=g) < 0.05, 1e-5, 1.0)
    cols = [torch.rand(cap, 512, generator=g) * 255 for _ in range(3)]
    slot_of = {tuple(q): i for i, q in enumerate(cells.tolist())}
    nbr8 = torch.tensor([[slot_of.get((q[0] + o[0], q[1] + o[1], q[2] + o[2]),
                                      -1) for o in wg.OCTANT_OFFSETS.tolist()]
                         for q in cells.tolist()], dtype=torch.int32)
    return d, w, cols, nbr8


def _mc_batch(layout, g):
    """(tsdf, weight, colors, nbr8, valid) of one batch layout."""
    d, w, cols, nbr8 = _sphere_pool(8, g)
    live = (mc.surface_crossing(d, w, nbr8, min_weight=1e-4)).nonzero()[:, 0]
    # The crossing block with the most triangles.
    table = mc.marching_cubes_plain(
        d, w, None, nbr8[live], torch.ones(live.numel(), dtype=torch.int32),
        min_weight=1e-4, with_color=False)[2]
    best = int(live[table[:, 0].float().sum(1).argmax()])
    if layout == "pipeline":
        # The mesh step's surface batch: crossing rows first, padding after.
        rows = live[:448]
        nbr = torch.full((512, 8), -1, dtype=torch.int32)
        nbr[:rows.numel()] = nbr8[rows]
        valid = (torch.arange(512) < rows.numel()).to(torch.int32)
    elif layout == "all_padding":
        nbr = torch.full((512, 8), -1, dtype=torch.int32)
        nbr[:64] = nbr8[live[:64]]
        valid = torch.zeros(512, dtype=torch.int32)
    elif layout == "one_row":
        nbr = nbr8[best:best + 1]
        valid = torch.ones(1, dtype=torch.int32)
    elif layout == "absent_neighbours":
        # Row 0 holds the surface; every octant column is absent in some
        # rows, whose corners then read row 0's TSDF and colors at weight 0.
        src = best
        for t in (d, w, *cols):
            t[[0, src]] = t[[src, 0]]
        relabel = torch.arange(d.shape[0], dtype=torch.int32)
        relabel[0], relabel[src] = src, 0
        nbr8 = torch.where(nbr8 >= 0, relabel[nbr8.clamp_min(0).long()], -1)
        rows = live
        nbr = nbr8[rows].clone()
        for c in range(8):
            nbr[c::8, c] = -1
        nbr[-16:, 1:] = -1
        valid = torch.ones(nbr.shape[0], dtype=torch.int32)
    else:  # longer_than_grid: more rows than 4 x the persistent grid
        rows = torch.cat([live, torch.arange(512)]).repeat(4)[:2600]
        nbr = nbr8[rows]
        valid = (torch.arange(2600) % 13 != 0).to(torch.int32)
    return d, w, cols, nbr, valid


@pytest.mark.parametrize("with_color", [True, False])
@pytest.mark.parametrize("layout", ["pipeline", "all_padding", "one_row",
                                    "absent_neighbours", "longer_than_grid"])
def test_marching_cubes_batch_layouts(dev, layout, with_color):
    """The kernel's batch walk and halo tile on the mesh step's layouts:
    one launch, all three bf16 outputs bit for bit."""
    g = torch.Generator(device="cpu").manual_seed(7)
    d, w, cols, nbr8, valid = _mc_batch(layout, g)
    args = [t.to(dev) for t in (d, w)]
    crows = tuple(c.to(dev) for c in cols) if with_color else None
    kw = dict(min_weight=1e-4, with_color=with_color)
    want = mc.marching_cubes_plain(*args, crows, nbr8.to(dev), valid.to(dev),
                                   **kw)
    before = kernels.LAUNCHES["marching_cubes"]
    got = mc.marching_cubes_fused(*args, crows, nbr8.to(dev), valid.to(dev),
                                  **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["marching_cubes"] == before + 1
    n_tris = float(want[2][:, 0].float().sum())
    assert (n_tris == 0) == (layout == "all_padding")
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _random_soup(n, n_live, share, g):
    """A bf16 soup `[n, 3, 16, 512]` with `share` of the first n_live rows'
    slots live (vertices in [0, 8), colors in [0, 255)), every other slot
    the sentinel -1 with zero color."""
    live = torch.rand(n, 16, 512, generator=g) < share
    live[n_live:] = False
    verts = torch.where(live[:, None],
                        torch.rand(n, 3, 16, 512, generator=g) * 8.0, -1.0)
    colors = torch.where(live[:, None],
                         torch.rand(n, 3, 16, 512, generator=g) * 255.0, 0.0)
    return verts.to(torch.bfloat16), colors.to(torch.bfloat16)


@pytest.mark.parametrize("case", ["pipeline", "color_off", "no_live_rows",
                                  "one_row", "full_rows",
                                  "longer_than_scan"])
def test_mesh_compact_matches_plain(dev, case):
    """mesh_row_offsets and mesh_compact on the mesh step's soup and edge
    layouts: one launch each, the offsets, CSR ints, f32 vertices and
    colors bit for bit the plain versions'."""
    g = torch.Generator(device="cpu").manual_seed(9)
    if case in ("pipeline", "color_off", "no_live_rows", "one_row"):
        d, w, cols, nbr8, valid = _mc_batch(
            {"no_live_rows": "all_padding", "one_row": "one_row"}.get(
                case, "pipeline"), g)
        ve, ce, table = mc.marching_cubes_fused(
            d.to(dev), w.to(dev), tuple(c.to(dev) for c in cols),
            nbr8.to(dev), valid.to(dev), min_weight=1e-4, with_color=True)
        verts, colors = mc.resolve_edge_soup(ve, ce, table)
        n_live = int(valid.sum())
        if case == "color_off":
            colors = None
    else:
        n, n_live, share = ((64, 64, 1.0) if case == "full_rows"
                            else (2600, 2500, 0.02))
        verts, colors = (t.to(dev) for t in _random_soup(n, n_live, share,
                                                         g))
    n = verts.shape[0]
    bidx = torch.randint(-300, 300, (n, 3), generator=g, dtype=torch.int32)
    bidx[n_live:] = 0
    bidx = bidx.to(dev)
    before = dict(kernels.LAUNCHES)
    offsets = mc.mesh_row_offsets(verts)
    want_off = mc.mesh_row_offsets_plain(verts)
    total = int(offsets[n_live])
    csr, flat = mc.mesh_compact(verts, colors, bidx, offsets, n_live, total,
                                VOXEL)
    want = mc.mesh_compact_plain(verts, colors, bidx, want_off, n_live,
                                 total, VOXEL)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mesh_offsets"] == before["mesh_offsets"] + 1
    assert kernels.LAUNCHES["mesh_compact"] == (
        before["mesh_compact"] + (n_live > 0))
    assert torch.equal(offsets, want_off)
    assert int(offsets[-1]) == total
    assert (total == 0) == (case == "no_live_rows")
    if case == "full_rows":
        assert total == 64 * 16 * 512
    assert torch.equal(csr, want[0])
    assert flat.shape == want[1].shape
    assert torch.equal(flat.view(torch.int32), want[1].view(torch.int32))


def _block_mask(shape, kind, g):
    blocks = tuple((d + 7) // 8 for d in shape)
    if kind == "none":
        return None
    if kind == "random":
        return torch.rand(blocks, generator=g) < 0.5
    return torch.full(blocks, kind == "all", dtype=torch.bool)


def _check_edt_pair(dev, seeds, pass_in, axis, band, needed):
    """edt_pass1 on `seeds` and edt_pass on `pass_in` along `axis`: one
    launch each, bit for bit equal to the plain versions."""
    before = dict(kernels.LAUNCHES)
    p1 = ed.edt_pass1(seeds, axis, band, needed)
    p = ed.edt_pass(pass_in, axis, band, needed)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edt_pass1"] == before["edt_pass1"] + 1
    assert kernels.LAUNCHES["edt_pass"] == before["edt_pass"] + 1
    assert torch.equal(p1, ed.edt_pass1_plain(seeds, axis, band, needed))
    assert torch.equal(p, ed.edt_pass_plain(pass_in, axis, band, needed))
    return p1, p


@pytest.mark.parametrize("mask", ["none", "all", "empty", "random"])
@pytest.mark.parametrize("shape", [(24, 16, 40), (8, 400, 16), (500, 8, 8),
                                   (16, 24, 1), (1, 9, 33), (13, 1, 7),
                                   (3, 130, 5), (37, 1, 1)])
@pytest.mark.parametrize("band", [5, 17, 40])
def test_edt_passes_match_plain(dev, shape, band, mask):
    """Random seeds and the first pass's output through the next pass, on
    every axis (B == 1 along Z, and along X or Y where the later axes have
    size 1; B > 1 otherwise; S = 1, S < band, S not a multiple of 8), band
    40 (the kernel's fixed-band instance) beside two others, with no mask,
    all, none or random blocks needed."""
    g = torch.Generator(device="cpu").manual_seed(band + shape[0])
    seeds = torch.where(torch.rand(shape, generator=g) < 0.01,
                        torch.zeros(()), torch.full((), float(ed.INF)))
    seeds = seeds.to(dev)
    needed = _block_mask(shape, mask, g)
    needed = None if needed is None else needed.to(dev)
    for axis in range(3):
        p1 = ed.edt_pass1_plain(seeds, axis, band)
        _check_edt_pair(dev, seeds, p1, (axis + 1) % 3, band, needed)
        if mask == "empty":
            p1k = ed.edt_pass1(seeds, axis, band, needed)
            assert bool((p1k == float(ed.INF)).all())


@pytest.mark.parametrize("band", [5, 17, 40])
def test_edt_passes_edge_values(dev, band):
    """All-INF grids, single-site lines, values at and just above band^2,
    and non-binary non-negative input to the first pass."""
    shape = (40, 24, 96)
    g = torch.Generator(device="cpu").manual_seed(band)
    inf = torch.full(shape, float(ed.INF))
    single = inf.clone()
    single[::3, ::5, 37] = 0.0           # one site on every Z line
    single[7, 11, :] = float(ed.INF)
    bb = band * band
    near = torch.where(torch.rand(shape, generator=g) < 0.05,
                       torch.randint(bb - 1, bb + 3, shape,
                                     generator=g).float(), inf)
    ints = torch.where(torch.rand(shape, generator=g) < 0.1,
                       torch.randint(0, 3 * band + 2, shape,
                                     generator=g).float(), inf)
    needed = _block_mask(shape, "random", g).to(dev)
    for grid in (inf, single, near, ints):
        grid = grid.to(dev)
        for axis in range(3):
            for nd in (None, needed):
                _check_edt_pair(dev, grid, grid, axis, band, nd)
    p1, p = _check_edt_pair(dev, inf.to(dev), inf.to(dev), 2, band, None)
    assert bool((p1 == float(ed.INF)).all() and (p == float(ed.INF)).all())
    p1, _ = _check_edt_pair(dev, single.to(dev), inf.to(dev), 2, band, None)
    assert float(p1[0, 0, 37]) == 0.0
    assert float(p1[0, 0, 37 + band]) == float(band ** 2)
    assert float(p1[0, 0, 36 - band]) == float(ed.INF)


def test_esdf_dense_cuda_matches_reference(dev):
    rng = np.random.default_rng(3)
    dims_b, cap, n = (6, 5, 4), 128, 60
    all_cells = np.stack(np.meshgrid(*[np.arange(d) for d in dims_b],
                                     indexing="ij"), -1).reshape(-1, 3)
    cells = np.zeros((cap, 3), np.int32)
    cells[:n] = all_cells[rng.choice(len(all_cells), n, replace=False)]
    is_site = np.zeros((cap, 512), bool)
    is_site[:n] = rng.random((n, 512)) < 0.01
    origin = np.array([-4, 2, 1], np.int32)
    sq = ed.esdf_from_sites_dense(
        torch.as_tensor(is_site, device=dev),
        torch.as_tensor(cells + origin, device=dev),
        torch.tensor(n, dtype=torch.int32, device=dev),
        torch.as_tensor(origin, device=dev), dims_b=dims_b, band=17)
    ref = ed.esdf_from_sites_reference(is_site, cells, n, dims_b, 17)
    np.testing.assert_array_equal(sq.cpu().numpy(), ref)


def test_device_mapper_cuda_equals_cpu(dev):
    """The whole slice on the card equals the plain path on the CPU."""
    scene = default_test_scene()
    frames = []
    for k in range(3):
        T = orbit_pose(2 * np.pi * k / 8)
        frames.append((render_depth(scene, CAM, T, device="cpu").numpy(), T))
    cfg = wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                             origin_block=(-24, -24, -6))
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    maps = [DeviceMapper(VOXEL, params=params, world=cfg,
                         max_blocks_per_frame=2048, device=d)
            for d in ("cpu", dev)]
    for m in maps:
        for depth, T in frames:
            m.integrate_depth(depth, T, CAM)
        m.update_esdf()
    a, b = (m.state_arrays() for m in maps)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_colored_mesh_slice_cuda_equals_cpu(dev):
    """Replay at the benchmark's cadence on the card equals the plain path
    on the CPU: TSDF, colors, ESDF, dirty and pending bits, and the mesh."""
    scene = default_test_scene()
    poses = np.stack([orbit_pose(2 * np.pi * k / 12, radius=1.8)
                      for k in range(10)]).astype(np.float32)
    depths = torch.stack([render_depth(scene, CAM, T, device="cpu")
                          for T in poses])
    colors = torch.stack([render_color(scene, CAM, T, device="cpu")
                          for T in poses])
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    cfg = wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                             origin_block=(-24, -24, -6))
    maps = [DeviceMapper(VOXEL, params=params, world=cfg,
                         max_blocks_per_frame=1024, device=d)
            for d in ("cpu", dev)]
    outs = []
    for m in maps:
        m.replay_frames(depths, torch.from_numpy(poses), CAM,
                        colors=colors, esdf_every=4, mesh_every=8,
                        color_every=8, esdf_region=((-12, -12, -2),
                                                    (24, 24, 10)),
                        mesh_max_blocks=512, mesh_surface_blocks=32)
        m.integrate_color(colors[3], poses[3], CAM, depth=depths[3, ::2, ::2])
        mesh = m.update_mesh_dirty_device(max_blocks=512)
        outs.append(([t.cpu() for t in mesh], m.state_arrays(),
                     m.dirty.cpu().numpy(), m.take_mesh_clear_keys()))
    (mesh_a, a, dirty_a, keys_a), (mesh_b, b, dirty_b, keys_b) = outs
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(dirty_a, dirty_b)
    assert keys_a == keys_b
    for x, y in zip(mesh_a, mesh_b):
        assert torch.equal(x, y)
    assert a["mesh_pending"].any() and bool(mesh_a[2].any())


def test_replay_makes_no_host_sync(dev):
    """Frame steps at every cadence (TSDF, TSDF + color, color, ESDF,
    mesh), the mesh update and the fused 2-D ESDF tick never wait on the
    device (CUDA's sync debug mode turns any synchronizing call into an
    error)."""
    scene = default_test_scene()
    poses = torch.stack([torch.as_tensor(orbit_pose(2 * np.pi * k / 8),
                                         device=dev) for k in range(4)])
    depths = torch.stack([render_depth(scene, CAM, poses[k], device=dev)
                          for k in range(4)])
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    m = DeviceMapper(VOXEL, params=params, max_blocks_per_frame=1024,
                     world=wg.WorldGridConfig(dims=(48, 48, 24),
                                              capacity=4096,
                                              origin_block=(-24, -24, -6)),
                     device=dev)
    colors = torch.stack([render_color(scene, CAM, poses[k], device=dev)
                          for k in range(4)])
    cadence = dict(colors=colors, color_every=2, mesh_every=2,
                   mesh_max_blocks=512, mesh_surface_blocks=64)
    # Warm-up: kernel loads and the device tables' one-time copies.
    m.replay_frames(depths, poses, CAM, **cadence)
    m.integrate_color(colors[0], poses[0], CAM, depth=depths[0])
    m.update_mesh_dirty_device(max_blocks=512)
    region = m.esdf_region(margin_blocks=0, mult=1)
    bounded = DeviceMapper(
        VOXEL, params=dataclasses.replace(params, view=ViewCalculatorParams(
            workspace_bounds_type=WorkspaceBoundsType.HEIGHT_BOUNDS,
            workspace_bounds_max_corner_m=(0.0, 0.0, 1.2))),
        max_blocks_per_frame=1024, device=dev,
        world=wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                                 origin_block=(-24, -24, -6)))
    mask = (torch.rand(CAM.height, CAM.width, device=dev) < 0.3).to(
        torch.uint8)
    bounded.integrate_depth(depths[0], poses[0], CAM, mask=mask)
    host_poses = poses.cpu().numpy()
    # The replays' device poses leave the region unknown: the first 2-D
    # tick reads it back once.
    assert m.integrate_depth_with_esdf2d(depths[2], host_poses[2], CAM, 0.1,
                                         0.3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m.replay_frames(depths, poses, CAM, esdf_every=2, esdf_region=region)
        m.replay_frames(depths, poses, CAM, esdf_every=2, esdf_region=region,
                        slot_bucket=1024, **cadence)
        # The online 2-D tick, on a host pose as the node gives it (a
        # device pose, as in the next step, makes the region unknown).
        assert m.integrate_depth_with_esdf2d(depths[3], host_poses[3], CAM,
                                             0.1, 0.3)
        m.integrate_depth(depths[0], poses[0], CAM)
        m.integrate_color(colors[1], poses[1], CAM, depth=depths[1])
        m.integrate_color(colors[1], poses[1], CAM,
                          depth=depths[1, ::2, ::2].contiguous())
        mesh = m.update_mesh_dirty_device(max_blocks=512)
        bounded.integrate_depth(depths[1], poses[1], CAM, mask=mask,
                                mask_mode=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(m.state.overflow_count) == 0
    assert bool((m.channels["esdf_sq_dist"] < 1e11).any())
    assert bool((m.channels["color_weight"] > 0).any())
    assert mesh[0].shape[1:] == (3, 16, 512)


def test_esdf_less_mapper_cuda_equals_cpu_without_host_sync(dev):
    """DeviceMapper(enable_esdf=False): a replay at the benchmark's cadence
    (color, ESDF and mesh cadences set) and frame steps on the card equal
    the CPU run on every array, with no ESDF channel and no EDT launch; the
    card's frame steps never wait on the device."""
    scene = default_test_scene()
    poses = np.stack([orbit_pose(2 * np.pi * k / 12, radius=1.8)
                      for k in range(6)]).astype(np.float32)
    depths = torch.stack([render_depth(scene, CAM, T, device="cpu")
                          for T in poses])
    colors = torch.stack([render_color(scene, CAM, T, device="cpu")
                          for T in poses])
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    cfg = wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                             origin_block=(-24, -24, -6))
    maps = [DeviceMapper(VOXEL, params=params, world=cfg, enable_esdf=False,
                         max_blocks_per_frame=1024, device=d)
            for d in ("cpu", dev)]
    cpu, card = maps
    frames = {cpu: (depths, torch.from_numpy(poses), colors),
              card: (depths.to(dev), torch.from_numpy(poses).to(dev),
                     colors.to(dev))}

    def replay(m, lo, hi):
        d, T, c = frames[m]
        m.replay_frames(d[lo:hi], T[lo:hi], CAM, colors=c[lo:hi],
                        color_every=2, esdf_every=2, mesh_every=3,
                        mesh_max_blocks=512, mesh_surface_blocks=64)

    def step(m):
        d, T, _ = frames[m]
        m.integrate_depth(d[5], T[5], CAM)
        m.update_esdf()

    replay(card, 0, 4)
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay(card, 4, 6)
        step(card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tsdf_color_fuse"] > before["tsdf_color_fuse"]
    for name in ("edt_pass1", "edt_pass"):
        assert kernels.LAUNCHES[name] == before[name], name
    replay(cpu, 0, 4)
    replay(cpu, 4, 6)
    step(cpu)
    a, b = cpu.state_arrays(), card.state_arrays()
    assert a.keys() == b.keys()
    assert not any(k.startswith("esdf_") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(cpu.dirty.numpy(), card.dirty.cpu().numpy())
    np.testing.assert_array_equal(cpu.esdf_dirty.numpy(),
                                  card.esdf_dirty.cpu().numpy())


# ---------------------------------------------------------------------------
# Occupancy and lidar (slice 3)
# ---------------------------------------------------------------------------

# Parameter corners: the defaults, a narrow band with tight clamps and a
# short range, a wide band with skewed odds.
OCC_CORNERS = {
    "default": {},
    "narrow_clamped": dict(occupied_region_half_width_m=0.05,
                           min_log_odds=-1.0, max_log_odds=1.2,
                           max_integration_distance_m=2.5),
    "wide_skewed": dict(occupied_region_half_width_m=0.25,
                        free_region_occupancy_probability=0.45,
                        occupied_region_occupancy_probability=0.9),
}


@pytest.mark.parametrize("corner", list(OCC_CORNERS))
def test_occupancy_fuse_matches_plain(dev, corner):
    d0, w0, slots, bidx, depth, T = _tsdf_setup(dev)
    # Log-odds inside every corner's clamps, as integration keeps them.
    lo0 = (d0 * 20.0).clamp(-1.0, 1.2)
    ob0 = (w0 > 1.0).to(torch.uint8)
    kw = dict(camera=CAM, voxel_size_m=VOXEL,
              params=OccupancyIntegratorParams(**OCC_CORNERS[corner]))
    want = integrate_occupancy(lo0.clone(), ob0.clone(), slots, bidx, depth,
                               T, **kw)
    before = kernels.LAUNCHES["occupancy_fuse"]
    got = integrate_occupancy_cuda(lo0.clone(), ob0.clone(), slots, bidx,
                                   depth, T, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["occupancy_fuse"] == before + 1
    assert int((want[0] != lo0).sum()) > 200
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _occupancy_rows(rng, cap, dev):
    """Random occupancy pool rows: log-odds f32[cap, 512] inside the
    default clamps, observed u8[cap, 512]."""
    lo0 = np.clip(rng.randn(cap, 512) * 3.0, -10.0, 10.0).astype(np.float32)
    ob0 = (rng.rand(cap, 512) < 0.3).astype(np.uint8)
    return torch.as_tensor(lo0, device=dev), torch.as_tensor(ob0, device=dev)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_occupancy_fuse_batch_layouts(dev, layout):
    """The occupancy kernel on the fusion kernels' batch layouts (padding,
    dropped entries, 1 entry, below and far above the persistent grid):
    bit-exact, rows outside the batch untouched."""
    blocks = _layout_blocks()
    _, _, _, _, depth, T = _tsdf_setup(dev)
    kw = dict(camera=CAM, voxel_size_m=VOXEL,
              params=OccupancyIntegratorParams(max_integration_distance_m=6.0))
    _check_layout(dev, layout, blocks, depth, T,
                  lambda *a: integrate_occupancy_cuda(*a, **kw),
                  lambda *a: integrate_occupancy(*a, **kw), "occupancy_fuse",
                  seed=4, make_rows=_occupancy_rows, marker=0)


def level_pose(x, y, z, yaw, tilt=0.0):
    c, s_ = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
    R = R @ np.array([[1.0, 0.0, 0.0], [0.0, np.cos(tilt), -np.sin(tilt)],
                      [0.0, np.sin(tilt), np.cos(tilt)]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = (x, y, z)
    return T


def _lidar_setup(dev, A, E, seed=0, cap=512):
    """Blocks all around the sensor (the batch straddles the +-pi seam),
    padding entries, a textured range image with holes, random rows."""
    rng = np.random.RandomState(seed)
    bidx = np.stack([rng.randint(-12, 12, 400), rng.randint(-12, 12, 400),
                     rng.randint(-2, 3, 400)], 1).astype(np.int32)
    bidx = np.unique(bidx, axis=0)
    n = bidx.shape[0]
    slots = np.concatenate([np.arange(n), [cap, -1]]).astype(np.int32)
    bidx = np.concatenate([bidx, [[0, 0, 0], [1, 1, 1]]]).astype(np.int32)
    base = 3.0 + 0.8 * np.sin(np.linspace(0, 6 * np.pi, A))[None, :]
    img = (np.broadcast_to(base, (E, A)) + rng.rand(E, A) * 0.05)
    img = img.astype(np.float32)
    img[rng.rand(E, A) < 0.05] = 0.0
    img[::5, ::11] = np.nan
    d0 = (rng.randn(cap, 512) * 0.05).astype(np.float32)
    w0 = (rng.rand(cap, 512) * 2.0).astype(np.float32)
    T = level_pose(0.11, -0.07, 0.3, 0.4, tilt=0.05)

    def t(a):
        return torch.as_tensor(a, device=dev)
    return t(d0), t(w0), t(slots), t(bidx), t(img), t(T)


@pytest.mark.parametrize("mode", list(WeightingFunctionType))
@pytest.mark.parametrize("A,E", [(512, 32), (1800, 16)])
def test_tsdf_lidar_fuse_matches_plain(dev, mode, A, E):
    d0, w0, slots, bidx, img, T = _lidar_setup(dev, A, E)
    lidar = Lidar.equal_vertical_fov(A, E, float(np.radians(30.0)),
                                     min_range_m=0.1)
    kw = dict(lidar=lidar, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(weighting_mode=mode,
                                          max_integration_distance_m=6.0))
    want = integrate_tsdf_lidar(d0.clone(), w0.clone(), slots, bidx, img, T,
                                **kw)
    before = kernels.LAUNCHES["tsdf_lidar_fuse"]
    got = integrate_tsdf_lidar_cuda(d0.clone(), w0.clone(), slots, bidx, img,
                                    T, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tsdf_lidar_fuse"] == before + 1
    assert int((want[1] != w0).sum()) > 500
    # Both seam sides are in the batch.
    p = Transform.apply(Transform.inverse(T), voxel_centers_for_blocks(
        bidx[:-2], VOXEL))
    uv, _, ok = lidar.project(p)
    u = uv[..., 0][ok]
    assert bool((u < 0.05 * A).any()) and bool((u > 0.95 * A).any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tsdf_lidar_fuse_batch_layouts(dev, layout):
    """The lidar kernel on the same batch layouts as tsdf_fuse, with blocks
    all around the sensor: bit-exact, rows outside the batch untouched."""
    g = np.stack(np.meshgrid(np.arange(-16, 16), np.arange(-16, 16),
                             np.arange(-4, 12), indexing="ij"), -1)
    blocks = g.reshape(-1, 3).astype(np.int32)
    _, _, _, _, img, T = _lidar_setup(dev, 1800, 16)
    lidar = Lidar.equal_vertical_fov(1800, 16, float(np.radians(30.0)),
                                     min_range_m=0.1)
    kw = dict(lidar=lidar, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(max_integration_distance_m=6.0))
    _check_layout(dev, layout, blocks, img, T,
                  lambda *a: integrate_tsdf_lidar_cuda(*a, **kw),
                  lambda *a: integrate_tsdf_lidar(*a, **kw),
                  "tsdf_lidar_fuse", seed=2)


@pytest.mark.parametrize("mode", list(WeightingFunctionType))
def test_tsdf_lidar_fuse_band_and_range_limits(dev, mode):
    """Voxels above and below the elevation band and on both sides of the
    valid range's two limits, on both sides of the +-pi seam: the kernel
    skips or fuses each as the plain version does, bit for bit."""
    rng = np.random.RandomState(3)
    A, E = 512, 16
    lidar = Lidar.equal_vertical_fov(A, E, float(np.radians(30.0)),
                                     min_range_m=0.5, max_range_m=2.5)
    g = np.stack(np.meshgrid(np.arange(-8, 8), np.arange(-8, 8),
                             np.arange(-4, 4), indexing="ij"), -1)
    bidx = g.reshape(-1, 3).astype(np.int32)
    cap = bidx.shape[0]
    slots = rng.permutation(cap).astype(np.int32)
    img = (1.2 + 1.4 * rng.rand(E, A)).astype(np.float32)
    img[rng.rand(E, A) < 0.05] = 0.0
    T = level_pose(0.013, -0.021, 0.017, 0.3)
    d0 = (rng.randn(cap, 512) * 0.05).astype(np.float32)
    w0 = (rng.rand(cap, 512) * 2.0).astype(np.float32)
    t = [torch.as_tensor(a, device=dev) for a in (d0, w0, slots, bidx, img,
                                                  T)]
    # Where the voxels fall (float64 geometry, enough to show coverage).
    p = Transform.apply(Transform.inverse(t[5]), voxel_centers_for_blocks(
        t[3], VOXEL)).double().cpu().numpy().reshape(-1, 3)
    r = np.linalg.norm(p, axis=1)
    el = np.arcsin(p[:, 2] / r)
    az = np.arctan2(p[:, 1], p[:, 0])
    half = np.radians(15.0)
    band = np.abs(el) <= half
    for side in (az > np.pi - 0.1, az < -np.pi + 0.1):
        assert ((np.abs(el) > half + 0.05) & (r > 0.6) & (r < 2.4)
                & side).any()
        for lim in (0.5, 2.5):
            assert (band & side & (r < lim) & (r > lim - VOXEL)).any()
            assert (band & side & (r > lim) & (r < lim + VOXEL)).any()
    kw = dict(lidar=lidar, voxel_size_m=VOXEL,
              params=TsdfIntegratorParams(weighting_mode=mode,
                                          max_integration_distance_m=6.0))
    want = integrate_tsdf_lidar(t[0].clone(), t[1].clone(), *t[2:], **kw)
    got = integrate_tsdf_lidar_cuda(t[0].clone(), t[1].clone(), *t[2:],
                                    **kw)
    torch.cuda.synchronize()
    assert int((want[1] != t[1]).sum()) > 500
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _occupancy_mapper(d, **kw):
    params = MapperParams(
        occupancy=OccupancyIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    return DeviceMapper(VOXEL, params=params,
                        world=wg.WorldGridConfig(dims=(48, 48, 24),
                                                 capacity=4096,
                                                 origin_block=(-24, -24, -6)),
                        projective_layer=ProjectiveLayerType.OCCUPANCY,
                        max_blocks_per_frame=1024, device=d, **kw)


def test_occupancy_path_cuda_equals_cpu(dev):
    """Frames, decay every 2nd, ESDF every 2nd: the card equals the plain
    path on the CPU in every array."""
    scene = default_test_scene()
    poses = [orbit_pose(2 * np.pi * k / 8) for k in range(4)]
    depths = [render_depth(scene, CAM, T, device="cpu") for T in poses]
    maps = [_occupancy_mapper(d) for d in ("cpu", dev)]
    for m in maps:
        for k, (depth, T) in enumerate(zip(depths, poses)):
            m.integrate_depth(depth, T, CAM)
            if k % 2 == 1:
                m.decay()
                m.update_esdf()
    a, b = (m.state_arrays() for m in maps)
    assert a.keys() == b.keys()
    assert int(a["removed_count"]) > 100
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _lidar_points(scene, lidar, T_L_S, device, row_offset=0.25):
    """Sphere-traced points along the lidar's rays lowered by a quarter
    row (off the range image's row boundaries, where the card's and the
    CPU's atan2 may round a point into different rows)."""
    T = torch.as_tensor(T_L_S, device=device)
    el = (lidar.max_angle_above_zero_elevation_rad
          - (torch.arange(lidar.num_elevation_divisions, device=device)
             + row_offset) * lidar.rads_per_row)
    az = ((torch.arange(lidar.num_azimuth_divisions, device=device) + 0.5)
          / lidar.num_azimuth_divisions * (2 * np.pi) - np.pi)
    elg, azg = torch.meshgrid(el.float(), az.float(), indexing="ij")
    dirs = torch.stack([torch.cos(elg) * torch.cos(azg),
                        torch.cos(elg) * torch.sin(azg), torch.sin(elg)],
                       -1).reshape(-1, 3)
    dirs_L = Transform.rotate(T, dirs)
    t = torch.full((dirs.shape[0],), 1e-3, device=device)
    for _ in range(96):
        d = scene.sdf(dirs_L * t[:, None] + T[:3, 3])
        t = torch.clamp_max(t + torch.where(d > 1e-4, d, torch.zeros_like(d)),
                            20.0)
    return dirs * t[:, None]


def test_lidar_path_cuda_matches_cpu(dev):
    """Scans (one motion-compensated), ESDF and clearing on the card
    against the plain path on the CPU. The card's atan2 and the CPU's
    differ in the last bit on some inputs, so the TSDF is held as the CPU
    tests hold the port to the reference: blocks alike, and within 1e-5
    on >= 99.9% of the observed voxels."""
    scene = default_test_scene()
    lidar = Lidar.equal_vertical_fov(512, 32, float(np.radians(30.0)),
                                     min_range_m=0.1)
    poses = [level_pose(0.3 * k - 0.5, 0.2 * k, 1.3, 0.8 * k)
             for k in range(4)]
    scans = [_lidar_points(scene, lidar, T, "cpu") for T in poses]
    stamps = torch.linspace(0.0, 0.1, scans[0].shape[0])
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    out = []
    for d in ("cpu", dev):
        m = DeviceMapper(VOXEL, params=params, enable_color=False,
                         world=wg.WorldGridConfig(dims=(48, 48, 24),
                                                  capacity=4096,
                                                  origin_block=(-24, -24, -6)),
                         max_blocks_per_frame=2048, device=d)
        m.integrate_pointcloud(scans[0], poses[0], lidar)
        m.integrate_pointcloud(scans[1], poses[1], lidar)
        m.integrate_pointcloud(scans[2], poses[2], lidar, timestamps_s=stamps,
                               T_L_S_end=poses[3])
        m.update_esdf()
        before = m.state_arrays()
        m.clear_outside_radius(poses[3][:3, 3], 2.0)
        m.clear_tsdf_inside_shapes(spheres=[((0.5, 0.5, 1.0), 0.6)])
        out.append((before, m.state_arrays()))
    for stage in (0, 1):
        a, b = out[0][stage], out[1][stage]
        common, ia, ib = _common_blocks(a, b)
        assert len(common) > (500 if stage == 0 else 100)
        d_a, w_a = a["tsdf_distance"][ia], a["tsdf_weight"][ia]
        d_b, w_b = b["tsdf_distance"][ib], b["tsdf_weight"][ib]
        obs = (w_a > 0) | (w_b > 0)
        bad = (np.abs(d_a - d_b) > 1e-5) | (np.abs(w_a - w_b) > 1e-5)
        assert obs.sum() > (20000 if stage == 0 else 2000)
        assert (bad & obs).sum() <= 1e-3 * obs.sum()
        if stage == 0:
            sq_a, sq_b = a["esdf_sq_dist"][ia], b["esdf_sq_dist"][ib]
            assert (sq_a < 1e11).sum() > 10000
            assert (sq_a == sq_b).mean() > 0.995
    n_a, n_b = int(out[0][1]["removed_count"]), int(out[1][1]["removed_count"])
    assert n_a > 100 and abs(n_a - n_b) <= 0.01 * n_a


def _common_blocks(a, b):
    """The live blocks two maps share (at least 99% of either's), and
    their slots on each side."""
    blocks = []
    for x in (a, b):
        n = int(x["alloc_count"])
        blocks.append({tuple(k): i for i, k in
                       enumerate(x["block_index_of_slot"][:n].tolist())
                       if k[0] < wg.FREED_BLOCK_SENTINEL})
    common = sorted(blocks[0].keys() & blocks[1].keys())
    assert len(common) >= 0.99 * max(len(blocks[0]), len(blocks[1]))
    return (common, [blocks[0][k] for k in common],
            [blocks[1][k] for k in common])


def test_slice3_entry_points_make_no_host_sync(dev):
    """The occupancy frame step, decay and the ESDF from occupancy (host
    poses), lidar integration (device and host poses, with motion
    compensation), TSDF decay with and without a last view, and both
    clearings never wait on the device."""
    scene = default_test_scene()
    poses = [orbit_pose(2 * np.pi * k / 8) for k in range(4)]
    depths = torch.stack([render_depth(scene, CAM, T, device=dev)
                          for T in poses])
    om = _occupancy_mapper(dev)
    lidar = Lidar.equal_vertical_fov(512, 32, float(np.radians(30.0)),
                                     min_range_m=0.1)
    l_pose = level_pose(0.2, -0.3, 1.3, 0.7)
    pts = _lidar_points(scene, lidar, l_pose, dev)
    stamps = torch.linspace(0.0, 0.1, pts.shape[0], device=dev)
    T_dev = torch.as_tensor(l_pose, device=dev)
    lm = DeviceMapper(VOXEL, params=MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        tsdf_decay=TsdfDecayParams(decay_factor=0.5)),
        enable_color=False, max_blocks_per_frame=2048, device=dev,
        world=wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                                 origin_block=(-24, -24, -6)))

    def occupancy_steps(k):
        om.integrate_depth(depths[k], poses[k], CAM)
        om.decay()
        om.update_esdf()

    def lidar_steps():
        lm.integrate_pointcloud(pts, l_pose, lidar)
        lm.integrate_pointcloud(pts, T_dev, lidar, timestamps_s=stamps,
                                T_L_S_end=T_dev)
        lm.decay()
        lm.integrate_depth(depths[0], poses[0], CAM)
        lm.decay()
        lm.clear_outside_radius(l_pose[:3, 3], 2.5)
        lm.clear_tsdf_inside_shapes(spheres=[((0.5, 0.0, 1.0), 0.5)],
                                    aabbs=[((-1.0, -1.0, 0.0),
                                            (0.0, 0.0, 1.0))])
        lm.clear_tsdf_inside_shapes(spheres=[((0.2, 0.0, 1.0), 0.3)])

    occupancy_steps(0)          # warm-up: kernel loads, device constants
    lidar_steps()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in (1, 2):
            occupancy_steps(k)
        lidar_steps()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(om.state.overflow_count) == 0
    assert bool((om.channels["esdf_sq_dist"] < 1e11).any())
    assert int(om.removed_count) > 0 and int(lm.removed_count) > 0


# ---------------------------------------------------------------------------
# Dynamics (slice 4): the 3^3 dilation and dynamic-pixel detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(20, 16, 9), (1, 5, 3), (4, 3, 1),
                                  (1, 1, 1), (3, 7, 5), (1, 1, 40),
                                  (40, 1, 1), (2, 33, 3), (48, 40, 24)])
@pytest.mark.parametrize("kind", ["binary", "positive"])
def test_dilate_dense_matches_plain(dev, dims, kind):
    g = torch.Generator(device="cpu").manual_seed(sum(dims))
    r = torch.rand(dims + (512,), generator=g)
    grid = (r < 0.02).float() if kind == "binary" else torch.where(
        r < 0.05, torch.rand(dims + (512,), generator=g) * 7.0, 0.0)
    grid = grid.to(dev)
    for fill in (0.0, 0.5):
        want = dilate_dense_grid_plain(grid, fill)
        before = kernels.LAUNCHES["dilate_dense"]
        got = dilate_dense_grid(grid, fill)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dilate_dense"] == before + 1
        assert torch.equal(got, want)
    assert int((want > grid).sum()) > 0


def _detect_setup(dev, seed=0, shape=(CAM.height, CAM.width)):
    """A world grid with a block of allocated cells, random high-confidence
    bytes, and a depth image of `shape` with zero, negative, too-far, inf
    and NaN pixels."""
    rng = np.random.default_rng(seed)
    cfg = wg.WorldGridConfig(dims=(16, 16, 8), capacity=512,
                             origin_block=(-8, -8, -2))
    st = wg.create_world_grid(cfg, dev)
    cells = rng.random((16, 16, 8)) < 0.6
    n = int(cells.sum())
    sg = np.full((16, 16, 8), -1, np.int32)
    sg[cells] = rng.permutation(n).astype(np.int32)
    st.slot_grid.copy_(torch.as_tensor(sg))
    hc = torch.as_tensor(rng.random((512, 512)) < 0.5, device=dev)
    depth = rng.uniform(0.2, 6.0, shape).astype(np.float32)
    bad = rng.random(depth.shape)
    depth[bad < 0.03] = 0.0
    depth[(bad >= 0.03) & (bad < 0.05)] = -1.0
    depth[(bad >= 0.05) & (bad < 0.06)] = np.inf
    depth[(bad >= 0.06) & (bad < 0.07)] = np.nan
    return st, hc, torch.as_tensor(depth, device=dev)


@pytest.mark.parametrize("subsample", [1, 2, 3])
@pytest.mark.parametrize("pose", ["inside", "tilted", "outside"])
def test_detect_dynamic_matches_plain(dev, subsample, pose):
    st, hc, depth = _detect_setup(dev, subsample)
    T = level_pose(0.1, -0.2, 0.5, 0.3, tilt=-1.2)
    if pose == "tilted":
        T = level_pose(-0.3, 0.1, 1.0, 2.0, tilt=-0.6)
    if pose == "outside":           # most endpoints leave the world grid
        T = level_pose(3.0, -2.5, 1.5, 0.7, tilt=-1.4)
    T = torch.as_tensor(T, device=dev)
    kw = dict(camera=CAM, voxel_size_m=VOXEL, max_depth_m=5.0,
              subsample=subsample)
    want, _ = detect_dynamic_plain(st, hc, depth, T, **kw)
    before = kernels.LAUNCHES["detect_dynamic"]
    got = detect_dynamic(st, hc, depth, T, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["detect_dynamic"] == before + 1
    assert got.dtype == torch.uint8
    assert torch.equal(got, want.to(torch.uint8))
    if pose != "outside":
        assert int(got.sum()) > 100


# Image shapes (H, W) off the kernel's vector path, or at its edges.
DETECT_SHAPES = {
    "157x119": (119, 157),          # W odd, W % s != 0 for s = 2-4
    "1x1": (1, 1),
    "3x5": (3, 5),
    "zero_depth": (CAM.height, CAM.width),
    "misaligned_view": (CAM.height, CAM.width),
}


@pytest.mark.parametrize("subsample", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(DETECT_SHAPES))
def test_detect_dynamic_shapes(dev, case, subsample):
    """An odd width, tiny images, an all-zero image and a depth view that
    starts 4 bytes past an 8-byte boundary (the vector path's load): equal
    to the plain version."""
    H, W = DETECT_SHAPES[case]
    st, hc, depth = _detect_setup(dev, 10 + subsample, shape=(H, W))
    if case == "zero_depth":
        depth = torch.zeros_like(depth)
    if case == "misaligned_view":
        buf = torch.empty(H * W + 1, device=dev)
        buf[1:] = depth.reshape(-1)
        depth = buf[1:].view(H, W)
        assert depth.is_contiguous() and depth.data_ptr() % 8 != 0
    cam = Camera(fx=160.0, fy=160.0, cx=(W - 1) / 2.0, cy=(H - 1) / 2.0,
                 width=W, height=H)
    T = torch.as_tensor(level_pose(0.1, -0.2, 0.5, 0.3, tilt=-1.2),
                        device=dev)
    kw = dict(camera=cam, voxel_size_m=VOXEL, max_depth_m=5.0,
              subsample=subsample)
    want, _ = detect_dynamic_plain(st, hc, depth, T, **kw)
    before = kernels.LAUNCHES["detect_dynamic"]
    got = detect_dynamic(st, hc, depth, T, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["detect_dynamic"] == before + 1
    assert got.shape == (H, W) and got.dtype == torch.uint8
    assert torch.equal(got, want.to(torch.uint8))
    if case in ("157x119", "misaligned_view"):
        assert int(got.sum()) > 100


def test_dynamics_make_no_host_sync(dev):
    """The MultiMapper's dynamic tick (detection, both masked
    integrations, the freespace update in both forms; no component filter)
    and replay_frames_dynamic with a region and a slot bucket never wait
    on the device."""
    scene = default_test_scene()
    poses = [orbit_pose(2 * np.pi * k / 8) for k in range(4)]
    depths = torch.stack([render_depth(scene, CAM, T, device=dev)
                          for T in poses])
    poses_t = torch.stack([torch.as_tensor(T, device=dev) for T in poses])
    times = torch.arange(4, device=dev, dtype=torch.float32) * 300.0
    sp = dataclasses.replace(
        MapperParams(projective=TsdfIntegratorParams(
            max_integration_distance_m=3.0)),
        remove_small_connected_components=False)
    mm = MultiMapper(MultiMapperParams(
        mapping_type=MappingType.DYNAMIC, block_capacity=4096,
        max_blocks_per_frame=1024, static_mapper=sp),
        world=wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                                 origin_block=(-24, -24, -6)), device=dev)
    # Warm-up: kernel loads, the view-batch form, then a known region.
    mm.replay_frames_dynamic(depths, poses_t, times, CAM)
    mm.static_mapper._refresh_region_from_device()
    region = mm.static_mapper.esdf_region(margin_blocks=0, mult=1)
    mm.replay_frames_dynamic(depths, poses_t, times + 1200.0, CAM,
                             region=region, slot_bucket=2048)
    mm.integrate_depth(depths[0], poses[0], CAM, time_ms=2400.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mm.replay_frames_dynamic(depths, poses_t, times + 2700.0, CAM,
                                 region=region, slot_bucket=2048)
        for k in range(4):
            mm.integrate_depth(depths[k], poses[k], CAM,
                               time_ms=3900.0 + 300.0 * k)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    mm.static_mapper.check_slot_bucket()
    for m in (mm.static_mapper, mm.dynamic_mapper):
        assert int(m.state.overflow_count) == 0
    hc = mm.static_mapper.channels["freespace_high_confidence"]
    assert int(hc.sum()) > 10000


def test_dynamics_slice_cuda_equals_cpu(dev):
    """The replay with a region and the eager ticks on the card equal the
    plain path on the CPU in every array."""
    scene = default_test_scene()
    poses = np.stack([orbit_pose(2 * np.pi * k / 8) for k in range(4)])
    depths = torch.stack([render_depth(scene, CAM, T, device="cpu")
                          for T in poses])
    times = torch.arange(4, dtype=torch.float32) * 300.0
    sp = dataclasses.replace(
        MapperParams(projective=TsdfIntegratorParams(
            max_integration_distance_m=3.0)),
        remove_small_connected_components=False)
    out = []
    for d in ("cpu", dev):
        mm = MultiMapper(MultiMapperParams(
            mapping_type=MappingType.DYNAMIC, block_capacity=4096,
            max_blocks_per_frame=1024, static_mapper=sp),
            world=wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                                     origin_block=(-24, -24, -6)), device=d)
        mm.replay_frames_dynamic(depths, torch.from_numpy(poses.astype(
            np.float32)), times, CAM)
        mm.replay_frames_dynamic(depths, torch.from_numpy(poses.astype(
            np.float32)), times + 1200.0, CAM,
            region=((-12, -12, -2), (24, 24, 10)))
        for k in range(4):
            mm.integrate_depth(depths[k], poses[k], CAM,
                               time_ms=2400.0 + 300.0 * k)
        out.append(mm.state_arrays())
    a, b = out
    assert a.keys() == b.keys()
    assert int(a["static_mapper/freespace_high_confidence"].sum()) > 10000
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# The publish slice: the 2-D ESDF, the mesh layer, slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(8, 8), (8, 48), (48, 8), (17, 23),
                                  (48, 48)])
@pytest.mark.parametrize("band", [5, 40])
def test_esdf_2d_matches_plain(dev, dims, band):
    """The 2-D solve on the card (kernels edt_pass1 along x, edt_pass along
    y on an f32[X, Y, 1] grid) equals its plain chain on the CPU bit for
    bit; each pass launches once."""
    rng = np.random.RandomState(dims[0] * 100 + dims[1] + band)
    nx, ny = dims
    cap = 2 * nx * ny + 16
    cols = np.stack([rng.randint(-2, nx + 2, cap), rng.randint(-2, ny + 2, cap)],
                    1)
    bidx = np.concatenate([cols, rng.randint(-1, 3, (cap, 1))], 1).astype(
        np.int32)
    site = rng.rand(cap, 512) < 0.003
    z_ok = rng.rand(cap, 512) < 0.6
    args = [torch.from_numpy(a) for a in (site, z_ok, bidx)] + [
        torch.tensor(cap - 9, dtype=torch.int32),
        torch.tensor([0, 0, 0], dtype=torch.int32)]
    want = ed.esdf_2d_from_sites(*args, dims_b=dims, band=band)
    kernels.reset_launch_counts()
    got = ed.esdf_2d_from_sites(*[a.to(dev) for a in args], dims_b=dims,
                                band=band)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["edt_pass1"] == 1
    assert kernels.LAUNCHES["edt_pass"] == 1
    assert torch.equal(got.cpu(), want)
    assert bool((want == 0).any()) and bool(((want > 0) & (want < 1e11)).any())
    mask = ed.collapse_2d_mask(*[a.to(dev) for a in args], dims_b=dims)
    assert torch.equal(mask.cpu(), ed.collapse_2d_mask(*args, dims_b=dims))


def _publish_mappers(dev_list):
    """A default MultiMapper (static TSDF, K2D; colors) per device, fed the
    same frames: integrate_depth, update_esdf, the fused tick, color."""
    from isaac_ros_nvblox_tpu_torch.mapper import device_io
    scene = default_test_scene()
    poses = [orbit_pose(2 * np.pi * k / 8) for k in range(4)]
    depths = [render_depth(scene, CAM, T, device="cpu") for T in poses]
    colors = [render_color(scene, CAM, T, device="cpu") for T in poses]
    out = []
    for d in dev_list:
        mm = MultiMapper(MultiMapperParams(block_capacity=4096),
                         world=wg.WorldGridConfig(dims=(48, 48, 24),
                                                  capacity=4096,
                                                  origin_block=(-24, -24, -6)),
                         device=d)
        for k in range(4):
            if k % 2:
                assert mm.integrate_depth_with_esdf2d(
                    depths[k], poses[k], CAM, *mm.esdf_2d_band())
            else:
                mm.integrate_depth(depths[k], poses[k], CAM)
                mm.update_esdf()
            mm.integrate_color(colors[k], poses[k], CAM, depth=depths[k])
        keys = mm.update_mesh(max_blocks=1024)
        spec, img = device_io.slice_esdf_2d_device(mm.static_mapper,
                                                   max_distance_m=2.0)
        out.append((mm, keys, spec, img))
    return out


def test_publish_slice_cuda_equals_cpu(dev):
    """The publish path on the card equals the plain path on the CPU: the
    map, the 2-D field, the slice image and the mesh layer (keys, vertices,
    colors, triangles)."""
    (a, ka, sa, ia), (b, kb, sb, ib) = _publish_mappers(["cpu", dev])
    sa_arr, sb_arr = a.state_arrays(), b.state_arrays()
    for k in sa_arr:
        np.testing.assert_array_equal(sa_arr[k], sb_arr[k], err_msg=k)
    fa, fb = a.static_mapper.esdf_2d, b.static_mapper.esdf_2d
    assert fa[0] == fb[0]
    for x, y in zip(fa[1:], fb[1:]):
        assert torch.equal(x, y.cpu())
    assert sa == sb
    np.testing.assert_array_equal(ia, ib)
    assert ka == kb and len(ka) > 50
    la, lb = a.static_mapper.mesh_layer, b.static_mapper.mesh_layer
    assert la.blocks.keys() == lb.blocks.keys()
    for key, blk in la.blocks.items():
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(blk, f),
                                          getattr(lb.blocks[key], f))
    assert len(la.blocks) > 50


# ------------------------------------------------------------ runtime node
NODE_TOPICS = ("~/static_map_slice", "~/pessimistic_static_map_slice",
               "~/map_slice_occupancy_grid", "~/mesh", "~/tsdf_layer",
               "~/color_layer", "~/esdf_layer", "~/back_projected_depth")


def _node(d, msgs=None):
    """A default node (static TSDF, K2D) on device `d` with a 4096-slot
    world and a simulated clock; `msgs` collects every topic."""
    from isaac_ros_nvblox_tpu_torch.runtime.node import NodeParams, NvbloxNode
    node = NvbloxNode(NodeParams(), MultiMapperParams(block_capacity=4096),
                      world=wg.WorldGridConfig(dims=(48, 48, 24),
                                               capacity=4096,
                                               origin_block=(-24, -24, -6)),
                      device=d)
    clock = [0.0]
    node.clock = lambda: clock[0]
    for topic in (NODE_TOPICS if msgs is not None else ()):
        msgs[topic] = []
        node.bus.subscribe(topic, msgs[topic].append)
    return node, clock


def _assert_msgs_equal(a, b, path="msg"):
    """Messages equal field by field: arrays bit for bit, block lists by
    block index."""
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "blocks":
                x = {(k.index.x, k.index.y, k.index.z): k for k in x}
                y = {(k.index.x, k.index.y, k.index.z): k for k in y}
            _assert_msgs_equal(x, y, f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_msgs_equal(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_msgs_equal(x, y, f"{path}[{i}]")
    else:
        assert not isinstance(a, torch.Tensor), path
        assert a == b, path


def test_node_cuda_equals_cpu(dev):
    """The node's ticks on the card equal the plain path on the CPU: the
    same frames, poses, lidar scan and clock give every topic the same
    messages (numpy on both), bit for bit."""
    scene = default_test_scene()
    poses = [orbit_pose(2 * np.pi * k / 16) for k in range(9)]
    depths = [render_depth(scene, CAM, T, device="cpu").numpy()
              for T in poses]
    colors = [render_color(scene, CAM, T, device="cpu").numpy()
              for T in poses]
    lidar = Lidar.equal_vertical_fov(1800, 16, float(np.radians(30.0)),
                                     min_range_m=0.1)
    T_l = np.eye(4, dtype=np.float32)
    T_l[:3, 3] = (0.3, -0.2, 1.2)
    # A ring of returns a quarter row below a row boundary (where the last
    # bit of atan2, which differs between the card and the CPU, would pick
    # the row).
    el = lidar.max_angle_above_zero_elevation_rad - 4.25 * (
        lidar.elevation_range_rad / 15)
    az = (np.arange(1800) + 0.5) / 1800 * 2 * np.pi - np.pi
    ring = (1.5 * np.stack([np.cos(el) * np.cos(az),
                            np.cos(el) * np.sin(az),
                            np.full_like(az, np.sin(el))], 1)).astype(
        np.float32)
    runs = []
    for d in ("cpu", dev):
        msgs = {}
        node, clock = _node(d, msgs)
        for i in range(40):
            now = i / 100.0
            k = min(i // 5, len(poses) - 1)
            node.add_pose("cam", now, poses[k])
            node.add_pose("lidar", now, T_l)
            node.add_pose("base_link", now, T_l)
            if i % 5 == 0:
                node.add_depth_image(depths[k], CAM, "cam", now)
                node.add_color_image(colors[k], CAM, "cam", now)
            if i == 17:
                node.add_pointcloud(ring, "lidar", now)
            clock[0] = now
            node.tick()
        runs.append(msgs)
    a, b = runs
    for topic in NODE_TOPICS:
        assert a[topic], topic
        _assert_msgs_equal(a[topic], b[topic], topic)
    assert sum(len(m.blocks) for m in a["~/mesh"]) > 20


def test_node_depth_tick_makes_no_host_sync(dev):
    """A tick that integrates a depth frame (a CUDA tensor, with a host
    pose) and publishes nothing never waits on the device: neither the
    fused 2-D ESDF tick nor a plain one."""
    scene = default_test_scene()
    node, clock = _node(dev)
    poses = [orbit_pose(2 * np.pi * k / 8) for k in range(8)]
    depths = [render_depth(scene, CAM, T, device=dev) for T in poses]
    node.add_pose("cam", 0.0, poses[0])
    node.add_depth_image(depths[0], CAM, "cam", 0.0)
    node.tick()                       # warm-up: kernel loads
    torch.cuda.synchronize()
    fused = []
    fuse = node.multi_mapper.integrate_depth_with_esdf2d
    node.multi_mapper.integrate_depth_with_esdf2d = \
        lambda *a: fused.append(fuse(*a)) or fused[-1]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for k in range(1, 8):
            now = 0.05 * k
            node.add_pose("cam", now, poses[k])
            node.add_depth_image(depths[k], CAM, "cam", now)
            clock[0] = now
            node.tick()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert fused and all(fused) and len(fused) < 7
    assert node.multi_mapper.static_mapper.block_count() > 0


# The node's other documented modes: (mode, user overlay, NodeParams
# changes, whether the ring scan is fed, topics). An occupancy layer takes
# no scan and has no mesh or TSDF layer.
NODE_MODE_CASES = {
    "static_occupancy": ("static_occupancy", {}, {"use_lidar": False},
                         False, ("~/static_map_slice",
                                 "~/map_slice_occupancy_grid",
                                 "~/occupancy_layer", "~/esdf_layer")),
    "dynamic": ("dynamic", {}, {}, True,
                NODE_TOPICS + ("~/combined_map_slice", "~/freespace_layer")),
    "esdf_3d": ("static", {"esdf_mode": "3d"}, {}, True, NODE_TOPICS),
}
# The float channels a card run may move in the last bits (the card's
# fused multiply-adds); every other array is held bit for bit.
NODE_LOOSE = ("tsdf_distance", "tsdf_weight", "color_r", "color_g",
              "color_b", "color_weight", "occupancy_log_odds")


@pytest.mark.parametrize("mode", list(NODE_MODE_CASES))
def test_node_mode_cuda_equals_cpu(dev, mode):
    """The node in static_occupancy, dynamic (a sphere crossing the room
    from the fifth frame on) and 3-D ESDF mode ticks alike on the card and
    on the CPU over the same frames, poses, scan and clock: the same
    blocks in the same slots, TSDF or log-odds within 1e-5, every other
    array of both mappers equal, and the same message counts on every
    topic the mode publishes."""
    from isaac_ros_nvblox_tpu_torch.mapper.params import make_params
    from isaac_ros_nvblox_tpu_torch.models.scene import Scene, Sphere
    from isaac_ros_nvblox_tpu_torch.runtime.node import NodeParams, NvbloxNode
    name, overlay, node_kw, scan, topics = NODE_MODE_CASES[mode]
    scene = default_test_scene()
    poses = [orbit_pose(2 * np.pi * k / 16) for k in range(9)]
    frames = []
    for k, T in enumerate(poses):
        sc = scene if k < 4 else Scene(primitives=scene.primitives + (
            Sphere(center=(-0.8 + 0.3 * k, 0.6, 1.0), radius=0.25),))
        frames.append((render_depth(sc, CAM, T, device="cpu").numpy(),
                       render_color(sc, CAM, T, device="cpu").numpy()))
    T_l = np.eye(4, dtype=np.float32)
    T_l[:3, 3] = (0.3, -0.2, 1.2)
    lidar = Lidar.equal_vertical_fov(1800, 16, float(np.radians(30.0)),
                                     min_range_m=0.1)
    ring = _lidar_points(scene, lidar, T_l, "cpu").numpy()
    runs = []
    for d in ("cpu", dev):
        node = NvbloxNode(NodeParams(**node_kw),
                          make_params(name, dict(overlay,
                                                 block_capacity=4096)),
                          world=wg.WorldGridConfig(
                              dims=(48, 48, 24), capacity=4096,
                              origin_block=(-24, -24, -6)), device=d)
        clock = [0.0]
        node.clock = lambda: clock[0]
        counts = {t: 0 for t in topics}
        for topic in topics:
            node.bus.subscribe(topic, lambda msg, topic=topic:
                               counts.__setitem__(topic, counts[topic] + 1))
        for i in range(40):
            now = i / 100.0
            k = min(i // 5, len(poses) - 1)
            node.add_pose("cam", now, poses[k])
            node.add_pose("lidar", now, T_l)
            node.add_pose("base_link", now, T_l)
            if i % 5 == 0:
                node.add_depth_image(frames[k][0], CAM, "cam", now)
                node.add_color_image(frames[k][1], CAM, "cam", now)
            if i == 17 and scan:
                node.add_pointcloud(ring, "lidar", now)
            clock[0] = now
            node.tick()
        runs.append((node.multi_mapper.state_arrays(), counts))
    (a, ca), (b, cb) = runs
    assert a.keys() == b.keys()
    for k in a:
        if k.split("/")[-1] in NODE_LOOSE:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert int(a["static_mapper/alloc_count"]) > 50
    assert ca == cb
    assert {t for t, n in ca.items() if n} == set(topics), ca


# ------------------------------------------------ the offline fuser slice
def test_native_png_unfilter_on_the_card_host(dev):
    """The host PNG library builds and equals its numpy version where the
    card is; a Replica-size 16-bit depth PNG round-trips."""
    from isaac_ros_nvblox_tpu_torch import native
    from isaac_ros_nvblox_tpu_torch.io import image_codec as ic
    rng = np.random.default_rng(0)
    for bpp in (1, 2, 3, 4):
        H, row = 17, 11 * bpp
        raw = rng.integers(0, 256, (H, row + 1)).astype(np.uint8)
        raw[:, 0] = rng.integers(0, 5, H)
        np.testing.assert_array_equal(
            native.png_unfilter(raw.tobytes(), H, row, bpp),
            native.png_unfilter_plain(raw.tobytes(), H, row, bpp))
    depth = (np.add.outer(np.arange(680), np.arange(1200)) * 37
             + rng.integers(0, 50, (680, 1200))).astype(np.uint16)
    np.testing.assert_array_equal(ic.decode_png(ic.encode_png(depth)), depth)


def _fuser_frames(n=5, cam=CAM):
    from isaac_ros_nvblox_tpu_torch.datasets.synthetic import (
        SyntheticDataLoader)
    return list(SyntheticDataLoader(num_frames=n, camera=cam, device="cpu"))


def test_fuser_device_step_makes_no_host_sync(dev):
    """The device backend's frame step (host depth and color, TSDF and
    color fusion) never waits on the card between its ESDF and mesh
    turns."""
    from isaac_ros_nvblox_tpu_torch.datasets.fuser import Fuser, FuserConfig
    frames = _fuser_frames()
    fuser = Fuser(frames, FuserConfig(capacity=8192), device=dev)
    fuser.integrate_frame(frames[0])   # frame 0: the ESDF and mesh turns
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames[1:4]:
            fuser.integrate_frame(f)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tsdf_fuse"] == 3
    assert kernels.LAUNCHES["color_fuse"] == 3


def test_fuser_device_backend_cuda_equals_cpu(dev):
    from isaac_ros_nvblox_tpu_torch.datasets.fuser import Fuser, FuserConfig
    frames = _fuser_frames()
    runs = [Fuser(frames, FuserConfig(capacity=8192), device=d)
            for d in ("cpu", dev)]
    for f in runs:
        assert f.run() == 5
    a, b = (f.mapper.state_arrays() for f in runs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    la, lb = (f.mapper.mesh_layer.blocks for f in runs)
    assert la.keys() == lb.keys() and len(la) > 100
    for k, blk in la.items():
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(lb[k], f), getattr(blk, f))


def test_host_mapper_cuda_equals_cpu(dev):
    """The host-table Mapper on the card (tsdf_fuse for depth, the
    reference's plain functions for the rest) equals its CPU run."""
    from isaac_ros_nvblox_tpu_torch.mapper.mapper import Mapper
    frames = _fuser_frames(3)
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    maps = [Mapper(VOXEL, params=params, capacity=2048, device=d)
            for d in ("cpu", dev)]
    kernels.reset_launch_counts()
    for m in maps:
        for f in frames:
            m.integrate_depth(f.depth, f.T_L_C, CAM)
            m.integrate_color(f.color, f.T_L_C, CAM, depth=f.depth)
        m.update_esdf()
        m.update_mesh()
    assert kernels.LAUNCHES["tsdf_fuse"] == 3
    assert kernels.LAUNCHES["color_fuse"] == 0
    a, b = maps
    np.testing.assert_array_equal(a.table.block_indices, b.table.block_indices)
    for k in a.pool.channels:
        np.testing.assert_array_equal(a.pool[k].numpy(), b.pool[k].cpu()
                                      .numpy(), err_msg=k)
    assert a.mesh_layer.blocks.keys() == b.mesh_layer.blocks.keys()
    for k, blk in a.mesh_layer.blocks.items():
        for f in ("vertices", "colors", "triangles"):
            np.testing.assert_array_equal(getattr(b.mesh_layer.blocks[k], f),
                                          getattr(blk, f))


def _sharded_pair(dev_list, capacity=1024):
    from isaac_ros_nvblox_tpu_torch.parallel.sharded_mapper import (
        ShardedDeviceMapper, ShardedMapperConfig)
    from isaac_ros_nvblox_tpu_torch.parallel.spatial import make_spatial_mesh
    cfg = ShardedMapperConfig(
        n_shards=4, shard_grid=(2, 2), global_dims=(32, 32, 16),
        origin_block=(-16, -16, -4), capacity_per_shard=capacity,
        voxel_size_m=VOXEL, max_blocks_per_frame=1024, enable_color=True,
        enable_occupancy=True, enable_freespace=True)
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=3.0),
        esdf=EsdfIntegratorParams(max_esdf_distance_m=0.6))
    return [ShardedDeviceMapper(make_spatial_mesh(4, device=d), CAM, cfg,
                                params) for d in dev_list]


def test_sharded_mapper_cuda_equals_cpu(dev):
    """The 2 x 2 sharded mapper over two RGB-D frames, an ESDF update, a
    freespace update, the dynamic tick, lidar and a mesh update: every
    shard's state and channels, the 2-D slice and the mesh soup on the
    card equal the CPU run (kernels tsdf_fuse, color_fuse,
    occupancy_fuse, edt_pass1, edt_pass, dilate_dense, detect_dynamic,
    tsdf_lidar_fuse, marching_cubes)."""
    scene = default_test_scene()
    lidar = Lidar.equal_vertical_fov(256, 16, np.deg2rad(30.0),
                                     min_range_m=0.2, max_range_m=8.0)
    runs = _sharded_pair(("cpu", dev))
    kernels.reset_launch_counts()
    soups = []
    for m in runs:
        for k in range(2):
            T = orbit_pose(2 * np.pi * k / 8)
            depth = render_depth(scene, CAM, T, device="cpu")
            m.integrate_depth(depth, T)
            m.integrate_color(render_color(scene, CAM, T, device="cpu"),
                              depth, T)
            m.update_freespace(T, 400.0 * (k + 1))
        m.update_esdf()
        m.dynamic_tick(depth, T, 1200.0)
        m.integrate_lidar(torch.full((16, 256), 1.5), np.eye(4,
                                                             dtype=np.float32),
                          lidar)
        soups.append([tuple(None if t is None else t.float().cpu()
                            for t in out) for out in m.update_mesh_dirty()])
    for name in ("tsdf_fuse", "color_fuse", "occupancy_fuse", "edt_pass1",
                 "edt_pass", "dilate_dense", "detect_dynamic",
                 "tsdf_lidar_fuse", "marching_cubes"):
        assert kernels.LAUNCHES[name] > 0, name
    a, b = (m.state_arrays() for m in runs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (a["tsdf_weight"] > 0).sum() > 10000
    np.testing.assert_array_equal(runs[0].slice_esdf_2d(1.0),
                                  runs[1].slice_esdf_2d(1.0))
    for sa, sb in zip(*soups):
        for x, y in zip(sa, sb):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


def test_sharded_frame_steps_make_no_host_sync(dev):
    """With host poses, the sharded depth, occupancy, color, lidar and
    routed steps never wait on the card."""
    scene = default_test_scene()
    (m,) = _sharded_pair((dev,), capacity=4096)
    lidar = Lidar.equal_vertical_fov(256, 16, np.deg2rad(30.0),
                                     min_range_m=0.2, max_range_m=8.0)
    poses = [orbit_pose(2 * np.pi * k / 8) for k in range(4)]
    depths = [render_depth(scene, CAM, T, device=dev) for T in poses]
    colors = [render_color(scene, CAM, T, device=dev) for T in poses]
    rimg = torch.full((16, 256), 1.5, device=dev)
    host_depths = np.stack([d.cpu().numpy() for d in depths])

    def steps():
        for T, d, c in zip(poses, depths, colors):
            m.integrate_depth(d, T)
            m.integrate_depth_occupancy(d, T)
            m.integrate_color(c, d, T)
        m.integrate_lidar(rimg, np.eye(4, dtype=np.float32), lidar)
        m.integrate_frames_routed(host_depths, np.stack(poses))

    steps()                                  # warm-up: kernel loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        steps()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert sum(int(st.alloc_count) for st in m.state) > 1000


def test_fused_submap_cuda_equals_cpu(dev):
    """Submaps on the card: the fused map (host splat, device rows) equals
    the CPU run's; the ESDF on it equals too."""
    from isaac_ros_nvblox_tpu_torch.mapper.submaps import (SubmapCollection,
                                                           SubmapParams)
    scene = default_test_scene()
    fused = []
    for d in ("cpu", dev):
        col = SubmapCollection(
            lambda d=d: DeviceMapper(
                VOXEL, world=wg.WorldGridConfig(dims=(48, 48, 24),
                                                capacity=4096,
                                                origin_block=(-24, -24, -6)),
                enable_color=False, max_blocks_per_frame=1024, device=d),
            SubmapParams(max_translation_m=10.0, max_rotation_rad=0.5))
        for k in range(6):
            T = orbit_pose(2 * np.pi * k / 24)
            col.integrate_depth(render_depth(scene, CAM, T, device="cpu"),
                                T, CAM)
        col.add_loop_closure(0, col.num_submaps - 1, np.linalg.inv(
            col.T_W_S_est[0]) @ col.T_W_S_est[-1], weight=10.0)
        col.optimize(iters=5)
        f = col.fuse()
        f.update_esdf()
        fused.append(f.state_arrays())
    a, b = fused
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (a["tsdf_weight"] > 0).sum() > 10000


# ---------------------------------------------------------------------------
# The people-segmentation modes and the ground plane
# ---------------------------------------------------------------------------

def _human_frames(n=4):
    """A person (a 0.5 x 0.3 x 1.7 m box) in a room at 160 x 120, seen
    from 4 poses; its mask in a 80 x 60 camera 4 cm and 2 degrees off the
    depth camera (T_CM_CD), and in the depth camera: (depth, mask, color
    mask, color, pose) per frame, on the CPU."""
    from isaac_ros_nvblox_tpu_torch.models.scene import (Box, RoomBox, Scene,
                                                         Sphere)
    room = (RoomBox(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
            Sphere(center=(1.2, 0.8, 1.0), radius=0.5))
    full = Scene(primitives=room + (Box(center=(0.3, -1.85, 0.85),
                                        half_extents=(0.25, 0.15, 0.85)),))
    static = Scene(primitives=room)
    c, s = np.cos(np.deg2rad(2.0)), np.sin(np.deg2rad(2.0))
    T_CM_CD = np.eye(4, dtype=np.float32)
    T_CM_CD[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T_CM_CD[:3, 3] = (-0.04, 0.0, 0.0)
    mask_cam = CAM.scaled(0.5)

    def truth(cam, T):
        d = render_depth(full, cam, T, device="cpu")
        e = render_depth(static, cam, T, device="cpu")
        return d, ((d > 0) & (d < e - 0.1)).to(torch.uint8) * 255

    out = []
    for k in range(n):
        T = orbit_pose(np.deg2rad(70.0 + 10.0 * k), radius=1.5)
        depth, cmask = truth(CAM, T)
        _, mask = truth(mask_cam, (T @ np.linalg.inv(T_CM_CD)).astype(
            np.float32))
        out.append((depth, mask, cmask,
                    render_color(full, CAM, T, device="cpu"), T))
    return out, mask_cam, T_CM_CD


def _human_mapper(mode, d):
    from isaac_ros_nvblox_tpu_torch.mapper.params import make_params
    return MultiMapper(make_params(overlay={
        "mapping_type": mode, "block_capacity": 4096,
        "static_mapper": {"connected_mask_component_size_threshold": 125}}),
        world=wg.WorldGridConfig(dims=(48, 48, 24), capacity=4096,
                                 origin_block=(-24, -24, -6)), device=d)


@pytest.mark.parametrize("mode", ["human_with_static_tsdf",
                                  "human_with_static_occupancy"])
def test_human_modes_cuda_equal_cpu(dev, mode):
    """Masked frames with a separate mask camera (reprojection, the
    component filter, the masked static and dynamic integrations), the
    masked color, the dynamic decay and the 2-D ESDF on the card equal
    the plain path on the CPU in every array."""
    frames, mask_cam, T_CM_CD = _human_frames()
    out = []
    for d in ("cpu", dev):
        mm = _human_mapper(mode, d)
        for depth, mask, cmask, color, T in frames:
            mm.integrate_depth(depth, T, CAM, mask=mask, mask_camera=mask_cam,
                               T_CM_CD=T_CM_CD)
            mm.integrate_color(color, T, CAM, mask=cmask)
            mm.decay_dynamic()
        mm.update_esdf()
        out.append(mm.state_arrays())
    a, b = out
    assert a.keys() == b.keys()
    assert (a["dynamic_mapper/occupancy_log_odds"] > 0).sum() > 50
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_human_tick_makes_no_host_sync(dev):
    """A masked depth frame from the mask camera (reprojection, the
    component filter, both masked integrations) never waits on the
    device."""
    frames, mask_cam, T_CM_CD = _human_frames()
    mm = _human_mapper("human_with_static_tsdf", dev)
    depth, mask, _, _, T = frames[0]
    depth, mask = depth.to(dev), mask.to(dev)
    T_t = torch.as_tensor(T, device=dev)
    cmcd = torch.as_tensor(T_CM_CD, device=dev)
    mm.integrate_depth(depth, T_t, CAM, mask=mask, mask_camera=mask_cam,
                       T_CM_CD=cmcd)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            mm.integrate_depth(depth, T_t, CAM, mask=mask,
                               mask_camera=mask_cam, T_CM_CD=cmcd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert mm.dynamic_mapper.block_count() > 0


def test_ground_plane_cuda_equals_cpu(dev):
    """The ground plane of a floor seen from above (both mappers' forms)
    on the card: the floor (tests/test_multi_mapper.py:98-116's bounds),
    within 1e-5 of the CPU's estimate with the same draws; the host
    Mapper's candidates equal."""
    from isaac_ros_nvblox_tpu_torch.mapper.mapper import Mapper
    from isaac_ros_nvblox_tpu_torch.models.scene import Plane, Scene
    from isaac_ros_nvblox_tpu_torch.ops.ground_plane import (
        GroundPlaneEstimator)
    scene = Scene(primitives=(Plane(normal=(0, 0, 1), offset=0.0),))
    frames = []
    for k in range(2):
        T = orbit_pose(0.3 * k, radius=1.5, height=1.2, target=(0.5, 0, 0))
        frames.append((render_depth(scene, CAM, T, device="cpu"), T))
    planes, cands = [], []
    for d in ("cpu", dev):
        dm = DeviceMapper(VOXEL, world=wg.WorldGridConfig(
            dims=(48, 48, 24), capacity=2048, origin_block=(-24, -24, -6)),
            enable_color=False, max_blocks_per_frame=2048, device=d)
        hm = Mapper(VOXEL, capacity=4096, enable_color=False,
                    enable_esdf=False, device=d)
        for depth, T in frames:
            dm.integrate_depth(depth, T, CAM)
            hm.integrate_depth(depth, T, CAM)
        est = GroundPlaneEstimator()
        planes.append([est.estimate_device(dm), est.estimate(hm)])
        cands.append(est.last_candidates)
    for p_cpu, p_card in zip(*planes):
        assert p_card is not None and p_cpu is not None
        assert abs(p_card.height_at(0.5, 0.0)) < 0.08
        assert p_card.normal()[2] > 0.95
        np.testing.assert_allclose([p_card.a, p_card.b, p_card.c],
                                   [p_cpu.a, p_cpu.b, p_cpu.c], rtol=0,
                                   atol=1e-5)
    np.testing.assert_array_equal(cands[1], cands[0])


def _mask_case(name, rng):
    """(mask u8[H, W], threshold) of a mask-filter case at VGA."""
    m = np.zeros((480, 640), np.uint8)
    yy, xx = np.mgrid[:480, :640]

    def disk(cy, cx, r):
        m[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    if name == "wide":
        m[100:104, 10:630] = 1                    # 620 px wide
        for i in range(400):                      # a corner-joined line
            m[20 + i // 2, 100 + i] = 1
        return m, 2000
    if name in ("under", "over"):
        disk(100, 100, 25)                        # 1961 pixels
        disk(300, 400, 30)
        size = int(m[:200, :200].sum())
        return m, size + (name == "under")
    if name == "touching":
        m[50:90, 50:90] = 1
        m[90:130, 90:130] = 1                     # meets at one corner
        return m, 3000
    if name == "empty":
        return m, 2000
    if name == "full":
        return np.full((480, 640), 255, np.uint8), 2000
    if name == "people_and_blobs":
        m[120:440, 200:280] = 1                   # a person
        for _ in range(6):
            disk(rng.uniform(0, 480), rng.uniform(0, 640), rng.uniform(15, 40))
        return m, 2000
    if name == "noise":
        return (rng.random((480, 640)) < 0.45).astype(np.uint8), 40
    if name == "odd_shape":
        return (rng.random((157, 119)) < 0.6).astype(np.uint8), 25
    raise ValueError(name)


@pytest.mark.parametrize("name", ["wide", "under", "over", "touching",
                                  "empty", "full", "people_and_blobs",
                                  "noise", "odd_shape"])
def test_mask_components_matches_plain_and_scipy(dev, name):
    """Kernel mask_components: one call (four launches), the filtered mask
    bit for bit the plain version's and scipy's 8-connected labelling's."""
    from scipy import ndimage
    from isaac_ros_nvblox_tpu_torch.ops import masking
    mask, thr = _mask_case(name, np.random.default_rng(7))
    before = kernels.LAUNCHES["mask_components"]
    got = masking.remove_small_connected_components_exact(
        torch.from_numpy(mask).to(dev), thr)
    assert kernels.LAUNCHES["mask_components"] == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    labels, _ = ndimage.label(mask > 0, structure=np.ones((3, 3)))
    sizes = np.bincount(labels.reshape(-1))
    keep = sizes >= thr
    keep[0] = False
    want = keep[labels].astype(np.uint8)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    plain = masking.remove_small_connected_components_plain(
        torch.from_numpy(mask), thr)
    np.testing.assert_array_equal(plain.numpy(), want)


def test_human_mode_masked_step_makes_no_host_sync(dev):
    """The human mode's masked depth step on the card (mask upload,
    reprojection, kernel mask_components, the split and both fusions)
    reads nothing back, and its maps equal the CPU run's."""
    from isaac_ros_nvblox_tpu_torch.mapper.params import make_params
    scene = default_test_scene()
    frames = []
    for k in range(3):
        T = orbit_pose(0.4 * k, radius=1.5, height=1.2)
        depth = render_depth(scene, CAM, T, device="cpu").numpy()
        mask = np.zeros(depth.shape, np.uint8)
        mask[20:100, 50 + 10 * k:90 + 10 * k] = 1
        mask[5:8, 5:8] = 1                        # a blob under threshold
        frames.append((depth, mask, T))
    maps = []
    for d in ("cpu", dev):
        params = make_params(overlay={
            "mapping_type": "human_with_static_tsdf", "block_capacity": 4096,
            "static_mapper": {"connected_mask_component_size_threshold": 100}})
        mm = MultiMapper(params, world=wg.WorldGridConfig(
            dims=(48, 48, 24), capacity=4096, origin_block=(-24, -24, -6)),
            device=d)
        T_CM_CD = np.eye(4, dtype=np.float32)
        T_CM_CD[0, 3] = -0.015
        for i, (depth, mask, T) in enumerate(frames):
            if d != "cpu" and i == len(frames) - 1:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                mm.integrate_depth(depth, T, CAM, mask=mask, mask_camera=CAM,
                                   T_CM_CD=T_CM_CD)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        maps.append({k: np.asarray(v) for k, v in mm.state_arrays().items()})
    assert maps[0].keys() == maps[1].keys()
    for k in maps[0]:
        np.testing.assert_array_equal(maps[1][k], maps[0][k], err_msg=k)
