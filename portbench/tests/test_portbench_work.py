"""The byte counts behind roofline.* against counts by hand."""

from portbench import work
from portbench.reference.fuser import esdf_update_cells


def test_tsdf_fuse_bytes():
    # Two frames of 640 x 480 updating 10 and 20 blocks, one 1800 x 16 scan
    # updating 5: 35 blocks of 512 voxels, 16 B each, and each image once.
    w = {"depth_blocks": [10, 20], "scan_blocks": [5]}
    assert work.tsdf_fuse_bytes(w, 640 * 480, 1800 * 16) == (
        35 * 512 * 16 + 2 * 640 * 480 * 4 + 1800 * 16 * 4)


def test_edt_bytes():
    # 2-D: two solves of 128 x 64 cells, read and written once each.
    assert work.edt_bytes({"esdf2d_cells": [8192, 8192]}) == 2 * 8192 * 2 * 4
    # 3-D: the cells an update reads and writes, counted already.
    assert work.edt_bytes({"esdf_cells": [1000, 24]}) == 1024 * 4


def test_esdf_update_cells():
    aabb = ((0, 0, 0), (9, 9, 3))
    # Dirty block (5, 5, 1), band 5 blocks: written region [0, 9] x [0, 9]
    # x [0, 3] clipped to the map, read region the same.
    assert esdf_update_cells(aabb, ((5, 5, 1), (5, 5, 1)), 5, False) == \
        2 * 10 * 10 * 4 * 512
    # Band of one block: written 3 x 3 x 3, read 5 x 5 x 4.
    assert esdf_update_cells(aabb, ((5, 5, 1), (5, 5, 1)), 1, False) == \
        (27 + 5 * 5 * 4) * 512
    # The first update covers the map twice.
    assert esdf_update_cells(aabb, ((5, 5, 1), (5, 5, 1)), 1, True) == \
        2 * 400 * 512
