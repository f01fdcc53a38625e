"""Port vs reference: the people-segmentation (human) modes with a mask
from a separate segmentation camera, and the node in that mode with the
ground-plane estimator (CPU).

The scene is chip_smoke.py's `human_frames` scene at a small size: the
bench room (bench.py:52-137) with a 0.5 x 0.3 x 1.7 m person standing on
the floor and walking along y = -1.85 m; depth at 160 x 120 (the VGA
camera scaled by 0.25) and the mask in its own camera (`scaled(0.5)`,
80 x 60) offset by `T_CM_CD` (4 cm of baseline, 2 degrees of yaw). The
mask is the person's geometric ground truth in the mask camera: pixels
where the scene with the person is nearer than the scene without it by
more than 2 voxels. The connected-component threshold is the
segmentation overlay's 2000 px scaled by the image area (125 px at
160 x 120), so that the person survives the filter as at VGA.

Both packages take the same numpy inputs. The static TSDF and the dynamic
occupancy must equal the reference's on >= 99.9% of voxels within 1e-5
(the slices' TSDF rule); the reprojected, filtered masks and the block
sets exactly. `tests/test_torch_accuracy.py --human` runs the same scene
at full size (the reference figures of chip_smoke.py's phase).
"""

import dataclasses

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import multi_mapper as jmm
from isaac_ros_nvblox_tpu.mapper import params as jp
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.runtime import node as jnode
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import multi_mapper as tmm
from isaac_ros_nvblox_tpu_torch.mapper import params as tp
from isaac_ros_nvblox_tpu_torch.models import camera as tc
from isaac_ros_nvblox_tpu_torch.models import scene as ts
from isaac_ros_nvblox_tpu_torch.runtime import node as tnode

torch.set_num_threads(2)

VOXEL = 0.05
VGA = dict(fx=500.0, fy=500.0, cx=319.5, cy=239.5, width=640, height=480)
# chip_smoke.py's human_frames scene: the bench room, its sphere and box,
# and a person (a box standing on the floor) walking along y = -1.85 m
# from x = -2.4 to 2.4 over the sequence.
ROOM = (dict(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
        dict(center=(1.2, 0.8, 1.0), radius=0.5),
        dict(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4)))
PERSON_HALF = (0.25, 0.15, 0.85)
PERSON_Y, PERSON_X0, PERSON_X1 = -1.85, -2.4, 2.4
# The segmentation camera: 4 cm to the side of the depth camera, turned
# 2 degrees about its vertical (camera y) axis.
MASK_BASELINE_M, MASK_YAW_RAD = 0.04, float(np.deg2rad(2.0))
SMALL_WORLD = dict(dims=(64, 64, 32), capacity=4096,
                   origin_block=(-32, -32, -8))
SMALL_CC_THRESHOLD = 125          # 2000 px * (160 * 120) / (640 * 480)


def _exact_mask_filter(mask, size_threshold, **_):
    """nvblox's mask filter on the host: the 8-connected components of
    `mask` with fewer than `size_threshold` pixels dropped, as a JAX
    array (the port's mapping path takes this rule, kernel
    mask_components)."""
    import jax.numpy as jnp
    from scipy import ndimage
    labels, _ = ndimage.label(np.asarray(mask) > 0,
                              structure=np.ones((3, 3)))
    sizes = np.bincount(labels.reshape(-1))
    keep = sizes >= size_threshold
    keep[0] = False
    return jnp.asarray(keep[labels].astype(np.uint8))


@pytest.fixture
def exact_jax_mask_filter(monkeypatch):
    """Within a test, the JAX package's multi-mapper filters its masks
    with nvblox's exact rule (as the port does) in place of its pooled,
    48-round approximation, so that a parity test holds both packages to
    one rule (tests/test_torch_node.py imports it too)."""
    monkeypatch.setattr(jmm, "remove_small_connected_components_device",
                        _exact_mask_filter)


def person_center(k: int, n: int):
    """The person's box centre at frame k of n."""
    t = k / max(n - 1, 1)
    return (PERSON_X0 + (PERSON_X1 - PERSON_X0) * t, PERSON_Y,
            PERSON_HALF[2])


def person_swept_box():
    """(lo, hi) of the box the person sweeps over the whole sequence."""
    lo = (PERSON_X0 - PERSON_HALF[0], PERSON_Y - PERSON_HALF[1], 0.0)
    hi = (PERSON_X1 + PERSON_HALF[0], PERSON_Y + PERSON_HALF[1],
          2 * PERSON_HALF[2])
    return np.asarray(lo, np.float32), np.asarray(hi, np.float32)


def t_cm_cd() -> np.ndarray:
    """T_CM_CD: depth-camera points into the mask camera's frame."""
    c, s = np.cos(MASK_YAW_RAD), np.sin(MASK_YAW_RAD)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[:3, 3] = (-MASK_BASELINE_M, 0.0, 0.0)
    return T


def scenes(mod, k: int, n: int):
    """(the room without the person, with the person at frame k) in the
    scene module `mod` (either package's models/scene.py)."""
    room = (mod.RoomBox(**ROOM[0]), mod.Sphere(**ROOM[1]), mod.Box(**ROOM[2]))
    person = mod.Box(center=person_center(k, n), half_extents=PERSON_HALF)
    return mod.Scene(primitives=room), mod.Scene(primitives=room + (person,))


def human_frame(render, mod, cam, mask_cam, T_L_C, k: int, n: int):
    """One frame's inputs: the depth with the person (f32[H, W]), the mask
    in the mask camera (u8, 255 = person) and the mask in the depth camera
    (for the color image), as numpy. `render(scene, camera, T)` gives a
    numpy depth image."""
    static, full = scenes(mod, k, n)
    T_L_CM = (T_L_C @ np.linalg.inv(t_cm_cd())).astype(np.float32)

    def truth(camera, T):
        d_full, d_static = render(full, camera, T), render(static, camera, T)
        return d_full, ((d_full > 0) & (d_full < d_static - 2 * VOXEL)
                        ).astype(np.uint8) * 255

    depth, color_mask = truth(cam, T_L_C)
    _, mask = truth(mask_cam, T_L_CM)
    return depth, mask, color_mask


def _port_render(scene, camera, T):
    return ts.render_depth(scene, camera, torch.from_numpy(T),
                           device="cpu").numpy()


SMALL_CAM = tc.Camera(**VGA).scaled(0.25)


@pytest.fixture(scope="module")
def small_frames():
    """6 frames from the +y side of the room (looking at the person's
    path), the person crossing the room."""
    n = 6
    out = []
    for k in range(n):
        T = ts.orbit_pose(np.deg2rad(55.0 + 14.0 * k), radius=1.5)
        depth, mask, cmask = human_frame(_port_render, ts, SMALL_CAM,
                                         SMALL_CAM.scaled(0.5), T, k, n)
        color = ts.render_color(scenes(ts, k, n)[1], SMALL_CAM,
                                torch.from_numpy(T), device="cpu").numpy()
        out.append((depth, mask, cmask, color, T))
    assert sum(int((m > 0).sum()) for _, m, *_ in out) > 500
    return out


def _multi_mappers(mode: str):
    out = []
    for mod, mmod, wmod, dev in ((jp, jmm, jwg, {}),
                                 (tp, tmm, twg, {"device": "cpu"})):
        params = mod.make_params(overlay={
            "mapping_type": mode, "block_capacity": SMALL_WORLD["capacity"],
            "static_mapper": {"connected_mask_component_size_threshold":
                              SMALL_CC_THRESHOLD}})
        out.append(mmod.MultiMapper(
            params, world=wmod.WorldGridConfig(**SMALL_WORLD), **dev))
    return out


def _close_share(a, b, tol=1e-5):
    return float(np.isclose(np.asarray(a, np.float64),
                            np.asarray(b, np.float64), rtol=0,
                            atol=tol).mean())


def _arrays(m, n):
    """The mapper's allocator and channels as numpy, rows < n."""
    st = {f: np.asarray(getattr(m.state, f)) for f in
          ("slot_grid", "block_index_of_slot", "alloc_count")}
    ch = {k: np.asarray(v if not isinstance(v, torch.Tensor) else v.numpy())
          [:n] for k, v in m.channels.items()}
    return st, ch


@pytest.mark.parametrize("mode", ["human_with_static_tsdf",
                                  "human_with_static_occupancy"])
def test_human_modes_match_reference(small_frames, mode,
                                     exact_jax_mask_filter):
    """chip_smoke.py's human_frames (a) and (b) at 160 x 120: each frame
    through `integrate_depth(depth, T, camera, mask, mask_camera,
    T_CM_CD)` (mask reprojection, the connected-component filter, the
    masked static and dynamic integrations) and `integrate_color` with
    the color-resolution mask; the dynamic layer's decay every 2nd frame;
    the ESDF of both mappers at the end."""
    jm, tm = _multi_mappers(mode)
    jcam = jc.Camera(**dataclasses.asdict(SMALL_CAM))
    jmask = jc.Camera(**dataclasses.asdict(SMALL_CAM.scaled(0.5)))
    tmask = SMALL_CAM.scaled(0.5)
    masks = []
    for k, (depth, mask, cmask, color, T) in enumerate(small_frames):
        for mm, cam, mcam in ((jm, jcam, jmask), (tm, SMALL_CAM, tmask)):
            mm.integrate_depth(depth, T, cam, mask=mask, mask_camera=mcam,
                               T_CM_CD=t_cm_cd())
            mm.integrate_color(color, T, cam, mask=cmask)
            if k % 2 == 1:
                mm.decay_dynamic()
        np.testing.assert_array_equal(tm.last_dynamic_mask,
                                      np.asarray(jm.last_dynamic_mask))
        masks.append(int((tm.last_dynamic_mask > 0).sum()))
    for mm in (jm, tm):
        mm.update_esdf()
    assert sum(masks) > 300
    for name in ("static_mapper", "dynamic_mapper"):
        j, t = getattr(jm, name), getattr(tm, name)
        assert t.block_count() == j.block_count() > 10, name
        n = int(t.state.alloc_count)
        (jst, jch), (tst, tch) = _arrays(j, n), _arrays(t, n)
        for f in jst:
            np.testing.assert_array_equal(tst[f], jst[f], err_msg=f)
        keys = (("tsdf_distance", "tsdf_weight")
                if "tsdf_distance" in tch else
                ("occupancy_log_odds", "occupancy_observed"))
        for k in keys:
            share = _close_share(tch[k], jch[k])
            assert share >= 0.999, (name, k, share)
    # The person went to the dynamic map (occupied voxels) and left no
    # surface in the static one beyond what the reference leaves.
    lo = tm.dynamic_mapper.channels["occupancy_log_odds"].numpy()
    jlo = np.asarray(jm.dynamic_mapper.channels["occupancy_log_odds"])
    assert (lo > 0).sum() > 50
    assert abs(int((lo > 0).sum()) - int((jlo > 0).sum())) <= max(
        1, 0.001 * (jlo > 0).sum())


@pytest.fixture(scope="module")
def node_frames():
    """chip_smoke.py's human_frames (c) at 160 x 120: 8 frames from the +y
    side (fed 50 ms apart, poses at 100 Hz)."""
    n = 8
    out = []
    for k in range(n):
        T = ts.orbit_pose(np.deg2rad(60.0 + 8.0 * k), radius=1.5)
        depth, mask, _ = human_frame(_port_render, ts, SMALL_CAM,
                                     SMALL_CAM.scaled(0.5), T, k, n)
        out.append((depth, mask, T))
    return out


def _human_node(nmod, mod, world_mod):
    params = dataclasses.replace(nmod.NodeParams(), use_segmentation=True,
                                 use_ground_plane_estimator=True,
                                 use_color=False, use_lidar=False)
    mparams = mod.make_params(overlay={
        "mapping_type": "human_with_static_tsdf",
        "block_capacity": SMALL_WORLD["capacity"],
        "static_mapper": {"connected_mask_component_size_threshold":
                          SMALL_CC_THRESHOLD}})
    kw = {} if nmod is jnode else {"device": "cpu"}
    node = nmod.NvbloxNode(params, mparams,
                           world=world_mod.WorldGridConfig(**SMALL_WORLD),
                           **kw)
    clock = [0.0]
    node.clock = lambda: clock[0]
    return node, clock


def test_human_node_with_ground_plane_matches_reference(
        node_frames, exact_jax_mask_filter):
    """The node in the segmentation mode with the ground-plane estimator:
    masked depth frames (the mask from the segmentation camera) every
    50 ms, ticks every 10 ms. A masked tick takes the unfused path (integrate,
    then the ground plane, the ESDF and the slice). Both nodes take the
    same frames: their maps agree by the TSDF rule, each ESDF tick
    publishes a plane (the floor: within 0.08 m at the origin, normal
    z > 0.95) within 1e-5 of the reference's, and the 2-D slices of the
    plane-relative band are equal cell for cell."""
    jcam = jc.Camera(**dataclasses.asdict(SMALL_CAM))
    jmask = jc.Camera(**dataclasses.asdict(SMALL_CAM.scaled(0.5)))
    runs = []
    for nmod, mod, wmod, cam, mcam in (
            (jnode, jp, jwg, jcam, jmask),
            (tnode, tp, twg, SMALL_CAM, SMALL_CAM.scaled(0.5))):
        node, clock = _human_node(nmod, mod, wmod)
        msgs = {"~/ground_plane": [], "~/static_map_slice": []}
        for topic, got in msgs.items():
            node.bus.subscribe(topic, got.append)
        n = len(node_frames)
        for i in range(5 * n + 1):
            now = i / 100.0
            k = min(i // 5, n - 1)
            node.add_pose("cam", now, node_frames[k][2])
            if i % 5 == 0 and i // 5 < n:
                depth, mask, _ = node_frames[k]
                node.add_depth_image(depth, cam, "cam", now, mask=mask,
                                     mask_camera=mcam, T_CM_CD=t_cm_cd())
            clock[0] = now
            node.tick()
        runs.append((node, msgs))
    (jn, jmsgs), (tn, tmsgs) = runs
    assert tn.depth_queue.dropped_count == jn.depth_queue.dropped_count == 0
    for name in ("static_mapper", "dynamic_mapper"):
        j = getattr(jn.multi_mapper, name)
        t = getattr(tn.multi_mapper, name)
        assert t.block_count() == j.block_count() > 0, name
        n = int(t.state.alloc_count)
        (jst, jch), (tst, tch) = _arrays(j, n), _arrays(t, n)
        for f in jst:
            np.testing.assert_array_equal(tst[f], jst[f], err_msg=f)
        for k in (("tsdf_distance", "tsdf_weight")
                  if "tsdf_distance" in tch else ("occupancy_log_odds",)):
            assert _close_share(tch[k], jch[k]) >= 0.999, (name, k)
    assert len(tmsgs["~/ground_plane"]) == len(jmsgs["~/ground_plane"]) >= 2
    for a, b in zip(tmsgs["~/ground_plane"], jmsgs["~/ground_plane"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    plane = tn.multi_mapper.ground_plane_estimator.last_plane
    assert abs(plane.height_at(0.0, 0.0)) < 0.08
    assert plane.normal()[2] > 0.95
    lo, hi = tn.multi_mapper.esdf_2d_band()
    assert abs(lo - (plane.c + 0.1)) < 1e-9 and abs(hi - lo - 0.2) < 1e-9
    assert len(tmsgs["~/static_map_slice"]) == len(
        jmsgs["~/static_map_slice"]) >= 2
    for a, b in zip(tmsgs["~/static_map_slice"], jmsgs["~/static_map_slice"]):
        assert (a.width, a.height, a.origin_x_m, a.origin_y_m) == (
            b.width, b.height, b.origin_x_m, b.origin_y_m)
        np.testing.assert_array_equal(a.data, np.asarray(b.data))
