"""The people-segmentation cell (`node_segmentation.people`) on the CPU at
a test's size: the reference's pieces against cases worked out by hand,
the people overlay from two seeds, a whole run's line, and runs with the
timed path broken underneath, each of which must come out not correct."""

import math
import time

import numpy as np
import pytest
import torch

from conftest import SEED, tiny_cell
from portbench import harness, inputs, people
from portbench.reference import segmentation as seg
from portbench.reference.fusion import Pinhole

NAME = "node_segmentation.people"


def seg_cell():
    """The cell at kinds' test size (conftest.tiny_cell): the mask camera
    and the blobs scaled with the camera, the filter's threshold with its
    pixel count, and no block budget cut (the wide 80 x 60 view touches
    more blocks a frame than the full-size camera)."""
    cell = tiny_cell(NAME)
    c = cell.config
    k = c["camera"]["width"] / 640.0
    c["mask_camera"] = dict(c["camera"], T_CM_CD=c["mask_camera"]["T_CM_CD"])
    sp = c["params"]["mapper"]["static_mapper"]
    sp["connected_mask_component_size_threshold"] = int(round(2000 * k * k))
    c["params"]["mapper"]["dynamic_max_blocks_per_frame"] = 8192
    b = cell.traffic["blobs"]
    b["radius_px"] = [r * k for r in b["radius_px"]]
    return cell


def seg_run(cell, seconds=0.5):
    return harness.run(cell, SEED, seconds, False, "cpu", time.perf_counter(),
                       log=lambda msg: None)


# ------------------------------------------------------------ the reference
def test_filter_components_by_hand():
    m = np.zeros((2, 6, 7), np.uint8)
    m[0, 0, 0:5] = 1                 # 5 pixels in a row
    m[0, 2, 2] = m[0, 3, 3] = m[0, 4, 4] = 1   # 3, joined at corners only
    m[0, 5, 0] = 1                   # 1
    m[1] = 1                         # 42, the whole frame
    out = seg.filter_components(torch.from_numpy(m), 3).numpy()
    want = np.zeros_like(m)
    want[0, 0, 0:5] = 1
    want[0, 2, 2] = want[0, 3, 3] = want[0, 4, 4] = 1
    want[1] = 1
    np.testing.assert_array_equal(out, want)
    out = seg.filter_components(torch.from_numpy(m), 4).numpy()
    want[0, 2, 2] = want[0, 3, 3] = want[0, 4, 4] = 0
    np.testing.assert_array_equal(out, want)
    assert seg.filter_components(torch.from_numpy(m), 43).sum() == 0


def test_reproject_by_hand():
    """A mask camera 10 cm to the depth camera's +x sees a point at 2 m
    depth fx * 0.1 / 2 = 5 pixels (fx = 100) to the left of where the
    depth camera does."""
    cam = Pinhole(100.0, 100.0, 9.5, 4.5, 20, 10)
    depth = torch.full((1, 10, 20), 2.0)
    depth[0, :, 0] = 0.0                      # no depth: unmasked
    mask = torch.zeros((1, 10, 20), dtype=torch.uint8)
    mask[0, :, 3] = 1
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -0.1
    out = seg.reproject(depth, mask, T, cam, cam)[0].numpy()
    assert out[:, 8].all() and out.sum() == 10
    T[0, 3] = 0.0
    out = seg.reproject(depth, mask, T, cam, cam)[0].numpy()
    np.testing.assert_array_equal(out, mask[0].numpy())


def _column_map(config):
    """A human map of one 8 x 8 x 8-block column of blocks along the
    camera's axis (+x), and the camera looking along it."""
    hmap = seg.HumanMap(np.array([-8, -8, -8]), (48, 16, 16), config)
    cam = Pinhole(4.0, 4.0, 1.5, 1.5, 4, 4)
    T = np.array([[0, 0, 1, 0.0], [-1, 0, 0, 0.025], [0, -1, 0, 0.025],
                  [0, 0, 0, 1]], np.float32)      # x forward, at a centre
    return hmap, cam, T


def test_human_layer_rule_by_hand():
    """Free in front of the surface beyond the half width, occupied within
    it, untouched behind; one decay moves each toward 0 by its step, and a
    block whose voxels all reach 0 is cleared."""
    cfg = seg_cell().config
    hmap, cam, T = _column_map(cfg)
    depth = torch.full((4, 4), 1.0)
    hmap.integrate_depth(depth, T, cam)
    lo = hmap.lo[8:, 8, 8]              # voxel centres x = 0.025 + 0.05 i
    obs = hmap.obs[8:, 8, 8]
    x = 0.025 + 0.05 * np.arange(lo.shape[0])
    l_free, l_occ = math.log(0.3 / 0.7), math.log(0.7 / 0.3)
    free = x < 1.0 - 0.1 - 1e-6
    occ = np.abs(x - 1.0) <= 0.1 - 1e-6
    behind = x > 1.1 + 1e-6
    assert np.allclose(lo.numpy()[free], l_free, atol=1e-6)
    assert np.allclose(lo.numpy()[occ], l_occ, atol=1e-6)
    assert not obs.numpy()[behind].any() and (lo.numpy()[behind] == 0).all()
    assert obs.numpy()[free | occ].all()
    hmap.decay()
    step_occ, step_free = math.log(0.6 / 0.4), math.log(0.55 / 0.45)
    assert np.allclose(hmap.lo[8:, 8, 8].numpy()[occ], l_occ - step_occ,
                       atol=1e-6)
    assert np.allclose(hmap.lo[8:, 8, 8].numpy()[free], l_free + step_free,
                       atol=1e-6)
    for _ in range(8):
        hmap.decay()
    assert (hmap.lo == 0).all() and not hmap.obs.any()


def test_combine_by_hand():
    u = 1000.0
    a = torch.tensor([[u, 1.0, 2.0], [u, u, -0.5]])
    b = torch.tensor([[0.5, u, 3.0], [u, 0.25, u]])
    np.testing.assert_array_equal(
        seg.combine([a, b], u).numpy(),
        np.array([[0.5, 1.0, 2.0], [u, 0.25, -0.5]], np.float32))


# --------------------------------------------------------------- the people
def _lap(cell, seed):
    return inputs.make_lap(cell.config, cell.traffic, seed, "cpu")


def test_people_overlay_from_two_seeds():
    cell = seg_cell()
    laps = [_lap(cell, s) for s in (SEED, SEED + 1, SEED)]
    before = [lap.depths.copy() for lap in laps]
    pls = [people.overlay(lap, cell.config, cell.traffic, "cpu")
           for lap in laps]
    assert people.overlay(laps[0], cell.config, cell.traffic, "cpu") \
        is pls[0]
    np.testing.assert_array_equal(pls[0].masks, pls[2].masks)
    np.testing.assert_array_equal(laps[0].depths, laps[2].depths)
    assert (pls[0].masks != pls[1].masks).any()
    for lap, pl, d0 in zip(laps, pls, before):
        K = lap.depths.shape[0]
        assert pl.masks.shape == (K, 60, 80)
        assert pl.in_view_share >= 0.5
        changed = lap.depths != d0
        # A person only ever comes in front of the scene (the person's
        # true depth is nearer; its noisy one within a few millimetres).
        assert changed.any()
        assert ((lap.depths[changed] < d0[changed] + 0.01)
                | (d0[changed] == 0)).all()
        assert pl.blobs > 0
    # The people walk: their positions differ between the two seeds.
    spec = cell.traffic["people"]
    xy = people.positions(spec, np.array([0.0, 0.5]), np.array([0.0, 1.0]))
    assert np.allclose(xy[0, 0], spec["paths"][0]["from"])
    assert np.allclose(xy[1, 0], np.add(spec["paths"][0]["from"],
                                        [1.4, 0.0]))


# -------------------------------------------------------------- whole runs
def test_sound_run_is_correct():
    line = seg_run(seg_cell())
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {
        "tsdf_off_share", "color_off_share", "mesh_off_share",
        "slice_off_share", "mask_off_share", "human_off_share",
        "frames_not_integrated"}
    assert set(line["metrics"]) == {"frames_per_s", "peak_mem_mib",
                                    "setup_s"}


def _skip_filter(mask, size_threshold):
    return (mask > 0).to(torch.uint8)


def _four_connected(mask, size_threshold):
    from scipy import ndimage
    labels, _ = ndimage.label(mask.cpu().numpy() > 0)
    sizes = np.bincount(labels.reshape(-1))
    keep = sizes >= size_threshold
    keep[0] = False
    return torch.from_numpy(keep[labels].astype(np.uint8))


@pytest.mark.parametrize("fault", ["filter_skipped", "four_connected",
                                   "masked_into_static", "decay_skipped"])
def test_fault_is_not_correct(monkeypatch, fault):
    from isaac_ros_nvblox_tpu_torch.mapper import device_mapper, multi_mapper
    if fault == "filter_skipped":
        monkeypatch.setattr(multi_mapper,
                            "remove_small_connected_components_exact",
                            _skip_filter)
    elif fault == "four_connected":
        monkeypatch.setattr(multi_mapper,
                            "remove_small_connected_components_exact",
                            _four_connected)
    elif fault == "masked_into_static":
        orig = device_mapper._masked_depth

        def all_pixels(depth, mask, mask_mode):
            return depth if mask_mode == 1 else orig(depth, mask, mask_mode)
        monkeypatch.setattr(device_mapper, "_masked_depth", all_pixels)
    else:
        monkeypatch.setattr(multi_mapper.MultiMapper, "decay_dynamic",
                            lambda self: None)
    line = seg_run(seg_cell())
    assert line["correct"] is False, line["checks"]


def test_bfloat16_reference_is_not_correct():
    """The control (control.py): the reference in bfloat16 in the
    program's place fails every compared number."""
    from portbench import control
    cell = seg_cell()
    nums = control.control_numbers(
        cell, SEED, 41, cell.module.warm_up_steps(cell.config), "cpu")
    assert set(nums) == set(cell.limits)
    for key, value in nums.items():
        assert value is not None and value > cell.limits[key], (key, value)


def test_new_modules_hold_nothing_of_the_program():
    """The reference of the new kind imports torch and numpy only, and the
    people overlay nothing of the program."""
    import subprocess
    import sys
    from conftest import ROOT
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import portbench.reference.segmentation, portbench.people\n"
            "held = {m.split('.')[0] for m in sys.modules}\n"
            "assert not held & {'isaac_ros_nvblox_tpu_torch', "
            "'isaac_ros_nvblox_tpu', 'jax'}, held\n"
            "import portbench.kinds.node_segmentation\n"
            "from portbench import harness\n"
            "assert harness.forbidden_modules() == []\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_metric_readers():
    """The cell's three per-layer readers: nothing to read (a program
    without the spans or kernels, as the parent of their PR) gives None;
    spans and kernels give their means and the byte bound's share."""
    spans = {"mapper/mask/filter": (10, 0.0002),
             "mapper/human/integrate": (10, 0.007)}
    empty = {"spans": {}, "events": [], "peak": None, "work": {},
             "kernel_of": harness.kernel_of}
    for name in ("mask_filter_ms", "human_integrate_ms",
                 "roofline.mask_label"):
        assert harness.metric_reader(name)(empty) is None, name
    ctx = {"spans": spans, "kernel_of": harness.kernel_of,
           "peak": {"hbm_bytes_per_s": 3.35e12},
           "work": {"mask_label_bytes": 3_072_000},
           "events": [("(anonymous namespace)::mask_label_local_kernel("
                       "unsigned char const*, int*, int*, int, int)", 0.0,
                       5e-6),
                      ("(anonymous namespace)::mask_label_merge_kernel("
                       "unsigned char const*, int*, int, int)", 1e-5, 2e-5),
                      ("tsdf_fuse_kernel(float*)", 0.0, 1.0)]}
    assert abs(harness.metric_reader("mask_filter_ms")(ctx) - 0.2) < 1e-9
    assert abs(harness.metric_reader("human_integrate_ms")(ctx) - 7.0) < 1e-9
    share = harness.metric_reader("roofline.mask_label")(ctx)
    assert abs(share - 100.0 * 3_072_000 / 3.35e12 / 15e-6) < 1e-6
    assert 0 < share <= 100
    assert {"mask_label_local_kernel", "mask_label_merge_kernel",
            "mask_label_count_kernel", "mask_label_filter_kernel"} <= \
        harness.kernel_names(harness.ROOT / harness.PORT)
