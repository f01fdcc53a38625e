"""The plain reference against cases worked out by hand: a fronto-parallel
wall (TSDF and weight), a single lidar ring, one colored voxel, a known
EDT and slice, and one cube's triangle."""

import math

import numpy as np
import torch

from portbench.reference import esdf, mesh
from portbench.reference.fusion import (DenseMap, FusionParams, Pinhole,
                                        Spherical)

VS = 0.05
P = FusionParams(voxel_size_m=VS)          # 7 m, 4 voxels, cap 5, inv. sq.


def weight(z, sdf):
    """inverse_square_dropoff by hand: 1 / z^2, faded to 0 between 0.05 m
    and 0.2 m behind the surface."""
    return min(max((0.2 + sdf) / 0.15, 0.0), 1.0) / (z * z)


def voxel(dmap, i, j, k):
    o = dmap.origin
    return (float(dmap.d[i - o[0], j - o[1], k - o[2]]),
            float(dmap.w[i - o[0], j - o[1], k - o[2]]))


def test_fronto_parallel_wall():
    cam = Pinhole(40.0, 40.0, 31.5, 23.5, 64, 48)
    dmap = DenseMap((-16, -16, 0), (32, 32, 48), P)
    dmap.integrate_depth(torch.full((48, 64), 1.0), np.eye(4, dtype=np.float32),
                         cam)
    for k, z in ((10, 0.525), (19, 0.975), (23, 1.175)):
        sdf = 1.0 - z
        d, w = voxel(dmap, 0, 0, k)
        assert math.isclose(d, min(sdf, 0.2), abs_tol=1e-6)
        assert math.isclose(w, weight(z, sdf), rel_tol=1e-5)
    # 0.225 m behind the wall: beyond the truncation, not observed.
    assert voxel(dmap, 0, 0, 24) == (0.0, 0.0)
    # A second frame averages: the weight doubles, the distance stays.
    dmap.integrate_depth(torch.full((48, 64), 1.0), np.eye(4, dtype=np.float32),
                         cam)
    d, w = voxel(dmap, 0, 0, 19)
    assert math.isclose(d, 0.025, abs_tol=1e-6)
    assert math.isclose(w, 2 * weight(0.975, 0.025), rel_tol=1e-5)


def test_single_lidar_ring():
    lid = Spherical(360, 16, math.radians(30.0), 0.1, 100.0)
    el = math.radians(15.0 - 7.25 * 2.0)       # row 7, a quarter row in
    az = (np.arange(360) + 0.5) / 360 * 2 * np.pi - np.pi
    ring = 2.0 * np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                           np.full_like(az, np.sin(el))], -1)
    img = lid.range_image(torch.as_tensor(ring, dtype=torch.float32))
    assert torch.all(img[7] > 1.99) and int((img > 0).sum()) == 360
    dmap = DenseMap((-48, -48, -16), (96, 96, 32), P, color=False)
    dmap.integrate_scan(ring.astype(np.float32), np.zeros(360, np.float32),
                        np.eye(4, dtype=np.float32), None, lid)
    for i in (30, 41):
        c = np.array([(i + 0.5) * VS, 0.025, 0.025])
        r = float(np.linalg.norm(c))
        sdf = 2.0 - r
        d, w = voxel(dmap, i, 0, 0)
        assert math.isclose(d, min(sdf, 0.2), abs_tol=1e-5)
        assert math.isclose(w, weight(r, sdf), rel_tol=1e-4)
    # Off the ring's row: nothing there to fuse.
    assert voxel(dmap, 30, 0, 10) == (0.0, 0.0)


def test_one_colored_voxel():
    cam = Pinhole(40.0, 40.0, 31.5, 23.5, 64, 48)
    dmap = DenseMap((-16, -16, 0), (32, 32, 48), P)
    dmap.d[16, 16, 19] = 0.0
    dmap.w[16, 16, 19] = 1.0
    rgb = torch.zeros((48, 64, 3), dtype=torch.uint8)
    rgb[..., 0], rgb[..., 1], rgb[..., 2] = 10, 20, 30
    dmap.integrate_color(rgb, np.eye(4, dtype=np.float32), cam)
    got = [float(c[16, 16, 19]) for c in dmap.color]
    assert np.allclose(got[:3], [10.0, 20.0, 30.0], atol=1e-4)
    assert math.isclose(got[3], 1.0 / 0.975 ** 2, rel_tol=1e-5)
    assert int((dmap.color[3] > 0).sum()) == 1


def test_known_edt_and_slice():
    site = torch.zeros((21, 21, 21), dtype=torch.bool)
    site[10, 10, 10] = True
    sq = esdf.edt(site, band=4)
    assert float(sq[10, 10, 10]) == 0.0
    assert float(sq[10, 10, 13]) == 9.0
    assert float(sq[12, 12, 12]) == 12.0
    inf = float(np.float32(esdf.INF))
    assert float(sq[10, 10, 15]) == inf            # 25 > band^2
    assert float(sq[13, 13, 10]) == inf            # 18 > band^2
    # The slice: the band z in [0.1, 0.3] holds voxels 2..5 of 8; a site
    # column at x = 3 (z = 3), observed everywhere, one inside voxel.
    s3 = torch.zeros((8, 4, 8), dtype=torch.bool)
    s3[3, :, 3] = True
    inside = torch.zeros_like(s3)
    inside[0, 0, 4] = True
    obs = torch.ones_like(s3)
    zmask = esdf.z_band(0, 8, VS, 0.1, 0.3, "cpu")
    assert zmask.tolist() == [False, False, True, True, True, True, False,
                              False]
    img = esdf.slice_2d(s3, inside, obs, zmask, band=4, voxel_size_m=VS,
                        max_distance_m=2.0, unknown=1000.0)
    assert math.isclose(float(img[5, 1]), 2 * VS, rel_tol=1e-6)
    assert math.isclose(float(img[0, 0]), -3 * VS, rel_tol=1e-6)
    assert float(img[7, 2]) == float(np.float32(np.float32(4.0) * np.float32(VS)))


def test_one_cube_triangle():
    d = torch.ones((16, 16, 16))
    d[0, 0, 0] = -1.0
    w = torch.ones((16, 16, 16))
    got = mesh.mesh_blocks(d, w, None, np.zeros(3, np.int64),
                           np.array([[0, 0, 0]]), VS, 1e-4)
    verts, tris = got[(0, 0, 0)]
    keys = [(256, 128, 128), (128, 256, 128), (128, 128, 256)]
    packed = [int(mesh.pack(np.asarray(k))) for k in keys]
    assert set(verts) == set(packed)
    assert tris == {tuple(sorted(packed))}
    # The same mesh as a program's welded block (meters) matches; a vertex
    # moved by one step of its bfloat16 grid does not.
    v = np.asarray(keys, np.float64) / 256.0 * np.float32(VS)
    prog = mesh.program_block_mesh(v.astype(np.float32),
                                   np.full((3, 3), 190, np.uint8),
                                   np.array([[0, 1, 2]]), VS)
    assert mesh.mesh_off({(0, 0, 0): prog}, got) == (0, 4)
    v[0, 0] += 2.0 ** -7 * VS
    moved = mesh.program_block_mesh(v.astype(np.float32),
                                    np.full((3, 3), 190, np.uint8),
                                    np.array([[0, 1, 2]]), VS)
    off, total = mesh.mesh_off({(0, 0, 0): moved}, got)
    assert off == 4 and total == 6
