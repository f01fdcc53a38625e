"""The port's submap layer (mapper/submaps.py) and `allocate_from_mask`
against the reference's on the CPU, and the cases of the reference's
tests/test_submaps.py rerun on the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu.core import world_grid as jwg
from isaac_ros_nvblox_tpu.mapper import submaps as jsub
from isaac_ros_nvblox_tpu.mapper.device_mapper import DeviceMapper as JMapper
from isaac_ros_nvblox_tpu.models import camera as jc
from isaac_ros_nvblox_tpu.models import scene as js
from isaac_ros_nvblox_tpu_torch.core import world_grid as twg
from isaac_ros_nvblox_tpu_torch.mapper import device_io
from isaac_ros_nvblox_tpu_torch.mapper import submaps as tsub
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
from isaac_ros_nvblox_tpu_torch.mapper.submaps import (SubmapCollection,
                                                       SubmapParams, se3_exp,
                                                       se3_log, so3_exp,
                                                       so3_log)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.scene import (Scene, Sphere,
                                                     orbit_pose, render_depth)
from isaac_ros_nvblox_tpu_torch.parallel.distributed import allgather_submaps

torch.set_num_threads(2)
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
CAM = Camera(**CAM_ARGS)
SCENE = Scene(primitives=(Sphere(center=(0.0, 0.0, 1.0), radius=0.5),))
WORLD = dict(dims=(24, 24, 16), capacity=4096, origin_block=(-12, -12, -4))
STATE = ("slot_grid", "block_index_of_slot", "alloc_count", "overflow_count",
         "origin_block", "free_stack", "free_count")


def _make_mapper():
    return DeviceMapper(voxel_size_m=0.05,
                        world=twg.WorldGridConfig(**WORLD),
                        enable_color=False, enable_esdf=False,
                        max_blocks_per_frame=1024, device="cpu")


def _make_jax_mapper():
    return JMapper(voxel_size_m=0.05, world=jwg.WorldGridConfig(**WORLD),
                   enable_color=False, enable_esdf=False,
                   max_blocks_per_frame=1024)


def _square_loop():
    """The reference test's square loop: ground truth and drifted
    estimates (each hop's translation stretched 10%)."""
    gt = []
    for x, y, th in [(0, 0, 0), (2, 0, np.pi / 2), (2, 2, np.pi),
                     (0, 2, -np.pi / 2)]:
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(th), np.sin(th)
        T[:2, :2] = [[c, -s], [s, c]]
        T[0, 3], T[1, 3] = x, y
        gt.append(T)
    est = [gt[0]]
    for k in range(1, 4):
        rel = (np.linalg.inv(gt[k - 1]) @ gt[k]).copy()
        rel[:3, 3] *= 1.10
        est.append((est[-1] @ rel).astype(np.float32))
    return gt, est


def _loop_graph(module, gt, est):
    g = module.PoseGraph()
    for k in range(1, 4):
        g.add_between(k - 1, k, np.linalg.inv(est[k - 1]) @ est[k],
                      weight=1.0)
    g.add_between(0, 3, np.linalg.inv(gt[0]) @ gt[3], weight=100.0)
    return g


# ------------------------------------------------------- against the JAX
def test_so3_se3_match_reference():
    """exp and log within 1e-6 of the reference's, at random increments
    and at the small-angle branch (w = 0, |w| = 1e-7)."""
    rng = np.random.RandomState(0)
    xis = [(rng.randn(6) * 0.3).astype(np.float32) for _ in range(8)]
    xis += [np.zeros(6, np.float32),
            np.asarray([1e-7, 0, 0, 0.1, 0.2, 0.3], np.float32)]
    for xi in xis:
        T = se3_exp(xi).numpy()
        np.testing.assert_allclose(T, np.asarray(jsub.se3_exp(
            jnp.asarray(xi))), rtol=0, atol=1e-6)
        np.testing.assert_allclose(se3_log(T).numpy(), np.asarray(
            jsub.se3_log(jnp.asarray(T))), rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            so3_log(so3_exp(xi[:3])).numpy(),
            np.asarray(jsub.so3_log(jsub.so3_exp(jnp.asarray(xi[:3])))),
            rtol=0, atol=1e-6)


def test_pose_graph_matches_reference():
    """The square loop's optimized poses within 1e-4 of the reference's;
    residual norms within 1e-4 relative."""
    gt, est = _square_loop()
    jg, tg = _loop_graph(jsub, gt, est), _loop_graph(tsub, gt, est)
    opt_j, opt_t = jg.optimize(est, iters=30), tg.optimize(est, iters=30)
    for a, b in zip(opt_t, opt_j):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg.residual_norm(opt_t),
                               jg.residual_norm(opt_j), rtol=1e-4, atol=1e-9)


def _drift_frames():
    """The reference test's slow orbit with 15 cm of injected drift after
    the first 4-frame window: (depth, T_est) with depth rendered by the
    reference."""
    jcam = jc.Camera(**CAM_ARGS)
    jscene = js.Scene(primitives=(js.Sphere(center=(0.0, 0.0, 1.0),
                                            radius=0.5),))
    drift = np.eye(4, dtype=np.float32)
    drift[0, 3] = 0.15
    out = []
    for k in range(8):
        T_true = np.asarray(js.orbit_pose(2 * np.pi * k / 48)).astype(
            np.float32)
        T_est = T_true if k < 4 else (drift @ T_true).astype(np.float32)
        out.append((np.asarray(js.render_depth(jscene, jcam,
                                               jnp.asarray(T_true))), T_est))
    return out, drift


@pytest.fixture(scope="module")
def drifted():
    """Both packages' collections over the drifted frames, a ground-truth
    loop closure added and optimized."""
    frames, drift = _drift_frames()
    params = dict(max_translation_m=10.0, max_rotation_rad=0.5)
    jcol = jsub.SubmapCollection(_make_jax_mapper,
                                 jsub.SubmapParams(**params))
    tcol = SubmapCollection(_make_mapper, SubmapParams(**params))
    jcam = jc.Camera(**CAM_ARGS)
    for depth, T in frames:
        jcol.integrate_depth(depth, T, jcam)
        tcol.integrate_depth(depth, T, CAM)
    for col in (jcol, tcol):
        T0, T1e = col.T_W_S_est
        T1_true = np.linalg.inv(drift) @ T1e
        col.add_loop_closure(0, 1, np.linalg.inv(T0) @ T1_true, weight=100.0)
        col.optimize(iters=25)
    return jcol, tcol


def test_keyframes_and_anchors_match_reference(drifted):
    """The same spawns, anchors and odometry factors; the optimized
    anchors within 1e-4."""
    jcol, tcol = drifted
    assert tcol.num_submaps == jcol.num_submaps == 2
    for a, b in zip(tcol.T_W_S_est, jcol.T_W_S_est):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(tcol.graph.factors) == len(jcol.graph.factors)
    for f, g in zip(tcol.graph.factors, jcol.graph.factors):
        assert (f.i, f.j, f.weight) == (g.i, g.j, g.weight)
        np.testing.assert_array_equal(f.T_i_j, g.T_i_j)
    for a, b in zip(tcol.T_W_S_opt, jcol.T_W_S_opt):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)


def test_fuse_matches_reference(drifted):
    """With the reference's submap maps and optimized anchors loaded, the
    port's fuse gives the reference's fused map: the same world, slots and
    blocks, TSDF and weights bit for bit (the float64 host splat in the
    same order)."""
    jcol, tcol = drifted
    col = SubmapCollection(_make_mapper, tcol.params)
    for m_j, T in zip(jcol.mappers, jcol.T_W_S_opt):
        m = _make_mapper()
        m.load_state_arrays({**{k: np.asarray(getattr(m_j.state, k))
                                for k in STATE},
                             **{k: np.asarray(v)
                                for k, v in m_j.channels.items()}})
        col.mappers.append(m)
        col.T_W_S_opt.append(np.asarray(T))
    for use_opt in (True, False):
        col.T_W_S_est = [np.asarray(T) for T in jcol.T_W_S_est]
        ft = col.fuse(use_optimized=use_opt)
        fj = jcol.fuse(use_optimized=use_opt)
        np.testing.assert_array_equal(ft.state.origin_block.numpy(),
                                      np.asarray(fj.state.origin_block))
        n = fj.block_count()
        assert ft.block_count() == n > 40
        for k in ("slot_grid", "block_index_of_slot", "alloc_count"):
            np.testing.assert_array_equal(
                getattr(ft.state, k).numpy(), np.asarray(getattr(fj.state, k)))
        for k in ("tsdf_distance", "tsdf_weight"):
            np.testing.assert_array_equal(ft.channels[k].numpy(),
                                          np.asarray(fj.channels[k]))
        np.testing.assert_array_equal(ft.dirty.numpy(), np.asarray(fj.dirty))


def test_allocate_from_mask_matches_reference():
    """Same slots, slot grid, alloc_count and overflow_count as the
    reference's, with a partly freed pool (recycling first) and a mask
    that overflows the pool and reaches outside the grid."""
    rng = np.random.RandomState(3)
    cfg = dict(dims=(10, 9, 8), capacity=96, origin_block=(-5, -4, -2))
    mask = rng.rand(12, 12, 12) < 0.12
    origin = np.asarray([-6, -5, -3], np.int32)
    js_ = jwg.create_world_grid(jwg.WorldGridConfig(**cfg))
    ts = twg.create_world_grid(twg.WorldGridConfig(**cfg), "cpu")
    first = rng.rand(12, 12, 12) < 0.04
    js_ = jwg.allocate_from_mask(js_, jnp.asarray(first), jnp.asarray(origin))
    ts = twg.allocate_from_mask(ts, torch.as_tensor(first),
                                torch.as_tensor(origin))
    free = np.asarray([3, 0, 7, 2], np.int32)
    js_ = jwg.free_slots(js_, jnp.asarray(free))
    ts = twg.free_slots(ts, torch.as_tensor(free))
    js_ = jwg.allocate_from_mask(js_, jnp.asarray(mask), jnp.asarray(origin))
    ts = twg.allocate_from_mask(ts, torch.as_tensor(mask),
                                torch.as_tensor(origin))
    for k in STATE:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js_, k)), err_msg=k)
    assert int(ts.overflow_count) > 0 and int(ts.free_count) == 0


# ------------------------------------- the reference's cases on the port
def test_se3_log_exp_roundtrip():
    rng = np.random.RandomState(0)
    for _ in range(5):
        xi = (rng.randn(6) * 0.3).astype(np.float32)
        back = se3_log(se3_exp(xi)).numpy()
        np.testing.assert_allclose(back, xi, atol=2e-2)  # first-order v


def test_pose_graph_closes_loop():
    """A drifted 4-node chain with a ground-truth loop closure: the
    closure residual drops, node 3 moves near its true pose."""
    gt, est = _square_loop()
    g = _loop_graph(tsub, gt, est)
    before = g.residual_norm(est)
    opt = g.optimize(est, iters=30)
    assert g.residual_norm(opt) < before * 0.05
    err3 = np.linalg.norm(opt[3][:3, 3] - gt[3][:3, 3])
    assert err3 < 0.25 * np.linalg.norm(est[3][:3, 3] - gt[3][:3, 3])


def test_keyframe_policy_spawns_submaps():
    col = SubmapCollection(_make_mapper, SubmapParams(max_translation_m=0.5))
    depth = render_depth(SCENE, CAM, orbit_pose(0.0), device="cpu")
    for k in range(4):
        Tk = np.asarray(orbit_pose(0.0)).astype(np.float32)
        Tk[0, 3] += 0.3 * k
        col.integrate_depth(depth, Tk, CAM)
    assert col.num_submaps >= 2
    assert len(col.graph.factors) == col.num_submaps - 1


def test_submap_fusion_corrects_drift():
    """Two submaps of the same sphere, the second's anchor drifted 15 cm:
    the optimized anchors recover the drift, the submaps agree in their
    overlap after optimization, and the fused map meshes."""
    col = SubmapCollection(_make_mapper, SubmapParams(
        max_translation_m=10.0, max_rotation_rad=0.5))
    drift = np.eye(4, dtype=np.float32)
    drift[0, 3] = 0.15
    for k in range(8):
        T_true = np.asarray(orbit_pose(2 * np.pi * k / 48)).astype(np.float32)
        T_est = T_true if k < 4 else (drift @ T_true).astype(np.float32)
        col.integrate_depth(render_depth(SCENE, CAM, T_true, device="cpu"),
                            T_est, CAM)
    assert col.num_submaps == 2
    T0, T1e = col.T_W_S_est
    col.add_loop_closure(0, 1, np.linalg.inv(T0) @ (np.linalg.inv(drift)
                                                    @ T1e), weight=100.0)
    col.optimize(iters=25)
    err = np.linalg.norm(col.T_W_S_opt[1][:3, 3]
                         - (np.linalg.inv(drift) @ col.T_W_S_est[1])[:3, 3])
    assert err < 0.02
    world = twg.WorldGridConfig(**WORLD)

    def rows(use_optimized, k):
        f = col.fuse(world=world, use_optimized=use_optimized, indices=[k])
        sg = f.state.slot_grid.numpy()
        d, w = f.channels["tsdf_distance"].numpy(), \
            f.channels["tsdf_weight"].numpy()
        dd = np.zeros((24, 24, 16, 512), np.float32)
        ww = np.zeros_like(dd)
        cells = np.argwhere(sg >= 0)
        slots = sg[cells[:, 0], cells[:, 1], cells[:, 2]]
        dd[cells[:, 0], cells[:, 1], cells[:, 2]] = d[slots]
        ww[cells[:, 0], cells[:, 1], cells[:, 2]] = w[slots]
        return dd, ww

    def consistency(use_optimized):
        d0, w0 = rows(use_optimized, 0)
        d1, w1 = rows(use_optimized, 1)
        overlap = (w0 > 0.5) & (w1 > 0.5)
        assert overlap.sum() > 500
        return float(np.mean(np.abs(d0[overlap] - d1[overlap])))

    c_bad, c_good = consistency(False), consistency(True)
    assert c_good < 0.4 * c_bad, (c_good, c_bad)
    assert c_good < 0.05
    fused = col.fuse(use_optimized=True)
    device_io.update_mesh_layer(fused)
    assert len(fused.mesh_layer.as_arrays()[2]) > 50
    fused.update_esdf()
    assert float((fused.channels["esdf_sq_dist"] < 1e11).float().sum()) > 0


def test_allgather_submaps_single_process_identity():
    """allgather_submaps in one process reproduces the collection: the
    same anchors, TSDF mass and block counts, and the odometry chain
    rebuilt from the gathered anchors (two processes: test_torch_
    distributed.py)."""
    col = SubmapCollection(_make_mapper, SubmapParams(max_translation_m=0.4,
                                                      max_rotation_rad=3.0))
    for k in range(3):
        T = orbit_pose(2 * np.pi * k / 6, radius=1.0, height=1.0)
        col.integrate_depth(render_depth(SCENE, CAM, T, device="cpu"), T,
                            CAM)
    n = col.num_submaps
    assert n >= 2
    g = allgather_submaps(col)
    assert g.num_submaps == n
    assert len(g.graph.factors) == n - 1
    for k in range(n):
        np.testing.assert_allclose(g.T_W_S_est[k], col.T_W_S_est[k],
                                   atol=1e-6)
        assert abs(float(g.mappers[k].channels["tsdf_weight"].sum())
                   - float(col.mappers[k].channels["tsdf_weight"].sum())) \
            < 1e-3
        assert g.mappers[k].block_count() == col.mappers[k].block_count()
    for k, f in enumerate(g.graph.factors):
        ref = np.linalg.inv(np.asarray(col.T_W_S_est[k], np.float64)) \
            @ np.asarray(col.T_W_S_est[k + 1], np.float64)
        np.testing.assert_allclose(f.T_i_j, ref.astype(np.float32),
                                   atol=1e-5)
    g.optimize(iters=3)
    assert g.fuse().block_count() > 0
