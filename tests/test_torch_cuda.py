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
                                                     orbit_pose, render_depth)
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
from isaac_ros_nvblox_tpu_torch.ops.esdf import EsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                 WeightingFunctionType,
                                                 integrate_tsdf)
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda
from isaac_ros_nvblox_tpu_torch.ops.view import (ViewCalculatorParams,
                                                 WorkspaceBoundsType)

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


@pytest.mark.parametrize("shape", [(24, 16, 40), (8, 400, 16), (500, 8, 8),
                                   (16, 24, 1)])
@pytest.mark.parametrize("band", [5, 17, 40])
def test_edt_passes_match_plain(dev, shape, band):
    g = torch.Generator(device="cpu").manual_seed(band + shape[0])
    seeds = torch.where(torch.rand(shape, generator=g) < 0.01,
                        torch.zeros(()), torch.full((), float(ed.INF)))
    seeds = seeds.to(dev)
    for axis in range(3):
        before = dict(kernels.LAUNCHES)
        p1 = ed.edt_pass1(seeds, axis, band)
        p = ed.edt_pass(p1, (axis + 1) % 3, band)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["edt_pass1"] == before["edt_pass1"] + 1
        assert kernels.LAUNCHES["edt_pass"] == before["edt_pass"] + 1
        assert torch.equal(p1, ed.edt_pass1_plain(seeds, axis, band))
        assert torch.equal(p, ed.edt_pass_plain(p1, (axis + 1) % 3, band))


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


def test_replay_makes_no_host_sync(dev):
    """Frame steps and ESDF updates of a replay never wait on the device
    (CUDA's sync debug mode turns any synchronizing call into an error)."""
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
    m.replay_frames(depths, poses, CAM)          # warm-up (kernel loads)
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
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        m.replay_frames(depths, poses, CAM, esdf_every=2, esdf_region=region)
        m.integrate_depth(depths[0], poses[0], CAM)
        bounded.integrate_depth(depths[1], poses[1], CAM, mask=mask,
                                mask_mode=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(m.state.overflow_count) == 0
    assert bool((m.channels["esdf_sq_dist"] < 1e11).any())
