#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (isaac_ros_nvblox_tpu_torch) on one
NVIDIA GPU.

Drives the port's paths at the benchmark's size: a 6 x 4.4 x 3 m room with
a sphere and a box, a 16-frame VGA (640x480) orbit replayed 4x, 0.05 m
voxels, a 64x64x32-block world with 16384 pool slots.

  * main_path: depth frames -> TSDF -> ESDF through
    `DeviceMapper.replay_frames` (kernels tsdf_fuse, edt_pass1, edt_pass).
  * pipeline: the same frames with colors at the reference's operational
    cadence (bench.py:237-244): TSDF every frame, TSDF + color in one pass
    every 8th (kernel tsdf_color_fuse), ESDF every 4th, mesh every 8th
    (kernel marching_cubes); plus the mesh and color marginals of
    bench.py:229-235.
  * color_frames: `DeviceMapper.integrate_color` with an unaligned
    (half-resolution) occlusion depth (kernel color_fuse).
  * mesh_accuracy: the benchmark's accuracy run (bench.py:582-619), the
    mesh scored against the cluttered two-room scene's analytic SDF.
  * occupancy_frames: the static_occupancy mode on the main path's frames:
    `integrate_depth` into a log-odds layer every frame (kernel
    occupancy_fuse), `decay` every 8th, `update_esdf` from occupied voxels
    every 4th (kernels edt_pass1, edt_pass).
  * lidar_scans: the node's 1800 x 16 lidar in the cluttered two-room
    scene, 64 scans through `integrate_pointcloud` (kernel
    tsdf_lidar_fuse), ESDF every 4th, then `clear_outside_radius` and
    `clear_tsdf_inside_shapes`.
  * dynamic_frames: the dynamic mapping mode (`MultiMapper`). Timed: the
    bench's dynamics row (bench.py:246-293), the main path's frames 25 ms
    apart through `replay_frames_dynamic` (kernels detect_dynamic,
    tsdf_fuse, occupancy_fuse, dilate_dense). Scored: the scene of
    tools/dynamics_quality.py, an intruder sphere crossing confident
    freespace, detected (`detect_dynamic`) and integrated (`integrate_depth`).
  * publish_frames: the node's default `MultiMapper` (static TSDF,
    EsdfMode.K2D) at the node's cadences over the main path's frames with
    host poses: depth every frame, the fused 2-D ESDF tick
    (`integrate_depth_with_esdf2d`, kernels tsdf_fuse, edt_pass1, edt_pass)
    and the slice publish every 4th, `update_mesh` (kernel marching_cubes,
    the native host mesh helpers) every 8th; the 2-D field held against
    scipy's EDT on every cell, the passes on its grid (path esdf_2d), the
    3-D ESDF service on a 2 m box, save -> load into a second mapper, the
    PLY writers; then the dynamic scene's MultiMapper in K2D (kernels
    detect_dynamic, tsdf_fuse, occupancy_fuse, dilate_dense, edt_pass1,
    edt_pass), its two slices combined. Its launch counts (`publish` in
    `launches_by_path`) add the two parts.
  * node_ticks: the online node (`NvbloxNode`, the node's and the
    mapper's defaults) ticking every 10 ms for 1.6 s of simulated time:
    the orbit's frames as 64 host depth and color images at 40 Hz, poses
    at 100 Hz, a moving 1800 x 16 lidar scan every 100 ms with per-point
    times (motion compensation); subscribers to the mesh (and its
    adapter), the 2-D slice, its occupancy grid, the TSDF layer, the
    back-projected depth and a costmap layer. Tick wall (mean, p50, p99),
    device time per simulated second, idle share, bytes copied to the
    host per publish kind, message counts, queue drops, the node's
    Timing table; the admitted frames all integrated, the final 2-D field
    against scipy, the map's score against the reference's CPU run; then
    the services (save_map -> load_map into a second node,
    get_esdf_and_gradients, save_ply, shutdown) and a dynamic-mode node
    on the 8 intruder frames, its two slices combined (kernels
    detect_dynamic, occupancy_fuse, dilate_dense). Launch counts `node`.
  * fuser: the offline fuser at the width of the dataset users replay,
    Replica's default 1200 x 680 camera: (a) 64 frames of the bench room
    rendered by `SyntheticDataLoader` through `Fuser(FuserConfig())` on
    the card (kernels tsdf_fuse and color_fuse every frame, edt_pass1 /
    edt_pass and marching_cubes every 4th frame and at the end), timed,
    traced and scored against the reference's CPU run
    (`tests/test_torch_accuracy.py --fuser`) and the mesh against the
    analytic surface; (b) its first 4 frames on the CPU (plain versions)
    and on the card, every map array and mesh block equal; (c) 16 frames
    written as Replica files (PNG depth with zlib, JPEG color through the
    host's codec) and read back exactly, their TSDF equal to a fuse of the
    quantized depth, orbit poses and camera from memory; (d) the host-table
    `Mapper` backend on those files, the device backend's blocks and
    TSDF; (e) the example pipeline for 4 frames, every artifact written.
    Launch counts `fuser`.

It builds every CUDA kernel from `isaac_ros_nvblox_tpu_torch/csrc/`, checks
that each path went through its kernels (launch counts set to 0 just before
the path runs and read just after), holds each kernel against its plain
PyTorch version on the path's own inputs, times both, and scores the maps
against the scenes' analytic SDFs.

Output, one JSON object per line: the card, each path's figures, one line
per kernel check (printed once every path has run, each with the kernel's
launches on every path, `launches_by_path`; the marching_cubes line also
times the same batch with every row padding, `ms_all_padding`, and three
torch fills of its outputs, `fill_ms`, the dilate_dense line a clone of
its grid, `copy_ms`; the lines of the fusion kernels (tsdf_fuse,
tsdf_lidar_fuse, occupancy_fuse, tsdf_color_fuse, color_fuse) time the
batch's real entries alone and its first real entry alone,
`ms_real_entries` and `ms_one_entry`, the occupancy_fuse line also the
batch that the dynamic path's frame builds, `ms_dynamic_batch`, with its
bound `bound_ms_dynamic_batch`, the color_fuse line an all-zero occlusion
depth, `ms_no_occlusion`; the detect_dynamic line times an all-zero depth
image, `ms_zero_depth`, and subsample 2, `ms_subsample2`; the lines of
occupancy_fuse, tsdf_color_fuse, color_fuse, detect_dynamic, dilate_dense
and marching_cubes give ptxas's registers, shared memory and spills with
the CTAs per SM they allow, `ptxas`; the color_frames line gives the
busiest device activities of a frame, `top_per_frame`, and the device
time of the color wrapper's `has_depth` ops, `has_depth_device_ms`), the
`kernels` summary, then the card's name and power limit as nvidia-smi
gives them, and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failed check exits non-zero before the last line. Without a CUDA device
it exits non-zero at once.

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# CTA sizes of the marching_cubes, dilate_dense, occupancy_fuse and
# detect_dynamic kernels (csrc/), for the CTAs-per-SM figure of their ptxas
# rows.
MC_THREADS = 256
DILATE_THREADS = 128
OCC_THREADS = 512
FUSE_THREADS = 512        # tsdf_color_fuse, color_fuse
DETECT_THREADS = 256

# Accuracy limits against the analytic scene. The TSDF limit is the
# benchmark's. The TSDF kernel computes what the reference's XLA TSDF path
# computes, and on that path the reference itself reaches an ESDF error of
# 0.0487 m (tests/test_torch_accuracy.py, run as a script), so the ESDF
# limit sits just above it. (The benchmark's 0.0305 m came from the
# reference's Pallas kernel, whose decimated depth sampling marks more
# floor sites; the same script scores that path at 0.030 m.)
TSDF_MAE_LIMIT_M = 0.035
ESDF_MAE_LIMIT_M = 0.05
# Mesh accuracy limits, derived from the reference's own CPU run of the
# same configuration (its XLA TSDF path, which the port mirrors;
# `tests/test_torch_accuracy.py --mesh`): surface error 0.00149 m,
# precision 1.0, completeness 0.9014, F-score 0.9481. The limits leave room
# for the card's render of the frames (within 1e-5 m of the reference's
# on all but 0.1% of the pixels) and nothing more.
MESH_ERR_LIMIT_M = 0.002
MESH_PRECISION_MIN = 0.999
MESH_COMPLETENESS_MIN = 0.89
MESH_FSCORE_MIN = 0.94
# Occupancy and lidar limits, from the reference's own CPU run of the same
# two configurations (its XLA integrators, which the port mirrors;
# `tests/test_torch_accuracy.py --occupancy` and `--lidar`): occupancy
# ESDF error 0.0531 m with every occupied voxel near the surface (share
# 1.0); lidar TSDF error 0.0209 m (9799 blocks; beams a quarter row off
# the range image's row boundaries, as `lidar_rays` traces them). The
# limits leave room for the card's own render of the frames and scans,
# no more.
OCC_ESDF_MAE_LIMIT_M = 0.055
OCC_NEAR_SHARE_MIN = 0.999
LIDAR_TSDF_MAE_LIMIT_M = 0.022
# Dynamics limits, from the reference's own CPU run of the scored sequence
# (its XLA path; `tests/test_torch_accuracy.py --dynamics`): 315 011
# high-confidence freespace voxels after the 64 build frames; on each of
# the 8 intruder frames it detects exactly the ground-truth pixels (TPR 1.0,
# FPR 0.0); 1382 occupied voxels in the dynamic map after the 8 frames.
# Agreement allowed (the card renders its own frames): the voxel count
# within 0.1%, detected pixels within 0.5% per frame, mean TPR at most
# 0.005 below the reference's, occupied voxels within 1%.
DYN_REF_HC_VOXELS = 315011
DYN_REF_DETECTED = (5728, 4719, 8683, 33738, 24602, 13306, 7118, 4691)
DYN_REF_MEAN_TPR = 1.0
DYN_REF_OCCUPIED = 1382
DYN_HC_TOL, DYN_DETECTED_TOL, DYN_TPR_TOL, DYN_OCCUPIED_TOL = (
    0.001, 0.005, 0.005, 0.01)
# The publish path: the node's cadences on its 40 Hz depth stream
# (runtime/node.py:58-66): the fused 2-D ESDF tick and the slice publish at
# 10 Hz, the mesh at 5 Hz; the slice's occupancy grid at the node's free
# threshold and unknown value (runtime/node.py:89-92). The dynamic part's
# height band holds the intruder (its centre at 1.0 m, radius 0.25 m).
PUBLISH_ESDF_EVERY = 4
PUBLISH_MESH_EVERY = 8
FREE_THRESHOLD_M = 0.2
UNKNOWN_VALUE = 1000.0
DYN_BAND_M = (0.75, 1.25)


# Launch counts of each path's run (set to 0 just before it, read just
# after), by path name.
PATH_LAUNCHES = {}
# The kernel_check lines, printed once every path has run, each with its
# kernel's launches on every path (`launches_by_path`).
CHECKS = []


def fail(msg: str) -> None:
    flush_checks()
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def flush_checks() -> None:
    """Print the kernel_check lines held so far, each with its kernel's
    launch counts on the paths that have run."""
    for row in CHECKS:
        row["launches_by_path"] = {
            path: counts[row["name"]] for path, counts in PATH_LAUNCHES.items()
            if counts.get(row["name"], 0) > 0}
        emit(row)
    CHECKS.clear()


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 21) -> float:
    """Median time of one call of `fn` in ms over `reps` calls (a CUDA
    event pair around each call), after one warm-up call. It includes the
    host's enqueue time wherever the device waits on the host."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def trace(fn, reps: int):
    """Device activities (kernels, copies) of `reps` calls of `fn` after a
    warm-up call, from torch.profiler: ([(name, microseconds)], wall
    seconds of the traced calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return ([(e.name, e.time_range.elapsed_us()) for e in prof.events()
             if "CUDA" in str(e.device_type)], wall)


def kernel_ms(fn, match: str, reps: int = 21):
    """Device time of one launch of the kernel whose name holds `match`:
    the median over `reps` calls from the profiler's trace, or, where
    three traces hold none (a trace now and then loses the kernel records
    of a short run), the event-timed call (which then includes the
    wrapper's host time). Returns (ms, how)."""
    for _ in range(3):
        durs = [us for name, us in trace(fn, reps)[0] if match in name]
        if durs:
            return float(np.median(durs)) / 1e3, "profiler"
    return cuda_ms(fn, reps), "events"


def plain_device_ms(fn, reps: int = 21):
    """Device time of all the kernels one call of `fn` launches (profiler),
    or None where the trace holds no device activity."""
    evs = trace(fn, reps)[0]
    return sum(us for _, us in evs) / reps / 1e3 if evs else None


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_rows(lib_name: str, threads: int, match: str = ""):
    """Registers, shared memory and spills of each kernel in
    `csrc/<lib_name>.cu` whose mangled name holds `match` (a template
    instantiation), as ptxas reports them (`kernels.resources`), with the
    CTAs of `threads` an H100 SM holds by those figures (65 536 registers
    allotted per warp in units of 256, 2 048 threads, 32 CTAs, 228 KB of
    shared memory with 1 KB reserved per CTA)."""
    from isaac_ros_nvblox_tpu_torch import kernels
    rows = []
    for fn, r in kernels.resources(lib_name).items():
        if match not in fn:
            continue
        warps = -(-threads // 32)
        per_warp = -(-r["registers"] * 32 // 256) * 256
        ctas = min(65536 // max(per_warp * warps, 1), 2048 // threads, 32,
                   233472 // (r["smem"] + 1024))
        rows.append({"kernel": fn, "threads": threads, **r,
                     "ctas_per_sm": ctas})
    return rows


def top_kernels(evs, n_frames: int, k: int = 8):
    """The k device activities of a trace with the most time: name, count
    and ms, per frame."""
    by_name = {}
    for name, us in evs:
        c_us = by_name.setdefault(name[:80], [0, 0.0])
        c_us[0] += 1
        c_us[1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:k]
    return [{"name": n, "count_per_frame": c / n_frames,
             "ms_per_frame": us / 1e3 / n_frames} for n, (c, us) in top]


def device_ms(fn, reps: int = 1):
    """(device busy ms per call of `fn`, wall s of the traced calls)."""
    evs, wall = trace(fn, reps)
    return sum(us for _, us in evs) / reps / 1e3, wall


def in_view_voxels(slots, bidx, T_L_C, camera, voxel, cap) -> int:
    """Voxels of the batch's real blocks whose centers project into the
    camera's image (the voxels a projective kernel must read)."""
    import torch
    from isaac_ros_nvblox_tpu_torch.core.types import (
        Transform, voxel_centers_for_blocks)
    real = (slots >= 0) & (slots < cap)
    p = Transform.apply(Transform.inverse(T_L_C),
                        voxel_centers_for_blocks(bidx, voxel))
    _, ok = camera.project(p)
    return int((ok & real[:, None]).sum())


def tsdf_reads_writes(uv, z, ok, image, params, voxel) -> tuple:
    """(voxels read, voxels written) of one TSDF fusion batch, given each
    voxel's pixel `uv`, depth or range `z` and view mask `ok` (already
    limited to the batch's real entries): the in-view voxels, whose pool
    rows the kernel reads, and those that ops/tsdf.py's `update` lets it
    write. A write at capped weight may leave the bits as they were, so a
    change of the pool undercounts the writes."""
    import torch
    from isaac_ros_nvblox_tpu_torch.models.camera import sample_image_nearest
    measured = sample_image_nearest(image, uv)
    update = (ok & (measured > 0.0) & torch.isfinite(measured)
              & (z <= params.max_integration_distance_m)
              & (measured - z >= -params.truncation_m(voxel)))
    return int(ok.sum()), int(update.sum())


def changed(new, old):
    """bool[cap, 512]: voxels where any of the channels changed (an update
    at capped weight still moves the running averages)."""
    out = new[0] != old[0]
    for a, b in zip(new[1:], old[1:]):
        out = out | (a != b)
    return out


def rows_untouched(new, old, rows) -> bool:
    """Whether every pool row outside `rows` (i64 or i32 slot indices) is
    the same in each of the channels `new` as in `old`."""
    import torch
    outside = torch.ones(new[0].shape[0], dtype=torch.bool,
                         device=new[0].device)
    outside[rows.long()] = False
    return all(bool(torch.equal(a[outside], b[outside]))
               for a, b in zip(new, old))


def bucket_of(worst: int) -> int:
    """The benchmark's batch rule (bench.py:118-130): the smallest bucket
    that holds the worst frame's touched-block count with 64 blocks of
    slack."""
    for bucket in (512, 1024, 2048, 4096, 8192):
        if worst <= bucket - 64:
            return bucket
    return 16384


def lidar_rays(lidar, row_offset: float = 0.25) -> np.ndarray:
    """The lidar's beams, `f32[rows * cols, 3]` unit directions in the
    sensor frame: `Lidar.unproject`'s column centres, with every row
    lowered by a quarter row. `unproject` puts a beam on a row boundary of
    the range image (an integral v), where the last bit of atan2, which
    differs between the card and the CPU, picks the row a return fills;
    the offset keeps every return a quarter row from a boundary. Made in
    numpy, so that the card and the reference trace the same rays."""
    A, E = lidar.num_azimuth_divisions, lidar.num_elevation_divisions
    az = (np.arange(A) + 0.5) / A * (2 * np.pi) - np.pi
    rads_per_row = lidar.elevation_range_rad / max(E - 1, 1)
    el = (lidar.max_angle_above_zero_elevation_rad
          - (np.arange(E) + row_offset) * rads_per_row)
    el, az = np.meshgrid(el, az, indexing="ij")
    return np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.sin(el)], -1).reshape(-1, 3).astype(np.float32)


def lidar_scan(scene, lidar, T_L_S, device, num_steps: int = 96):
    """Sphere-trace `scene` along the lidar's beams (`lidar_rays`) from the
    pose T_L_S (f32[4, 4]): points `f32[rows * cols, 3]` in the sensor
    frame, (0, 0, 0) (out of range, so dropped) where a ray hits nothing
    within the lidar's max range."""
    import torch
    from isaac_ros_nvblox_tpu_torch.core.types import Transform
    T = torch.as_tensor(T_L_S, dtype=torch.float32, device=device)
    dirs_S = torch.as_tensor(lidar_rays(lidar), device=device)
    dirs_L = Transform.rotate(T, dirs_S)
    t = torch.full((dirs_S.shape[0],), 1e-3, device=device)
    for _ in range(num_steps):
        d = scene.sdf(dirs_L * t[:, None] + T[:3, 3])
        t = torch.clamp_max(t + torch.where(d > 1e-4, d, torch.zeros_like(d)),
                            2.0 * lidar.max_valid_range_m)
    hit = ((scene.sdf(dirs_L * t[:, None] + T[:3, 3]) < 1e-3)
           & (t < lidar.max_valid_range_m))
    return torch.where(hit[:, None], dirs_S * t[:, None],
                       torch.zeros_like(dirs_S))


def orbit_lidar_poses(n_per_room: int = 32):
    """A level sensor at 1.3 m on the benchmark's accuracy ellipses
    (bench.py:609-613: room centres x = -3 and 3 m, radii 1.6 x 1.4 m),
    heading along the ellipse."""
    poses = []
    for cx in (-3.0, 3.0):
        for k in range(n_per_room):
            a = 2 * np.pi * k / n_per_room
            yaw = np.arctan2(1.4 * np.cos(a), -1.6 * np.sin(a))
            T = np.eye(4, dtype=np.float32)
            c, s = np.cos(yaw), np.sin(yaw)
            T[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
            T[:3, 3] = (cx + 1.6 * np.cos(a), 1.4 * np.sin(a), 1.3)
            poses.append(T)
    return poses


def esdf_aabb_blocks(m):
    """Blocks per axis of the AABB that `update_esdf` solves over in a
    whole-map update (the mapper's host-side touched-block AABB)."""
    return [int(h - l + 1) for l, h in zip(m._aabb_lo, m._aabb_hi)]


def timed_run(run, n_steps: int):
    """Run the path once with the launch counts set to 0 just before and
    read just after (host wall ms per step, ending in a synchronize), then
    once more under the profiler (device ms per step, idle share). `run`
    builds a fresh mapper each time and returns it. Returns (the first
    run's mapper, its launch counts, the figures)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from isaac_ros_nvblox_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    evs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if "CUDA" in str(e.device_type)]
    busy = sum(us for _, us in evs) / 1e3
    return out, launches, {
        "ms_per_step": wall * 1e3 / n_steps,
        "device_ms_per_step": busy / n_steps,
        "device_idle_share": 1 - busy / 1e3 / traced_wall,
        "traced_ms_per_step": traced_wall * 1e3 / n_steps,
        "device_activities_per_step": len(evs) / n_steps,
        "device_to_host_copies": sum(1 for n, _ in evs if "DtoH" in n),
        "top_per_step": top_kernels(evs, n_steps, 6)}


def edt_check(state, is_site, esdf_sq, origin_t, dims_b, band: int,
              path: str):
    """edt_pass1 and edt_pass against their plain versions on a path's
    ESDF region (origin `origin_t`, `dims_b` blocks), seeded from its map's
    sites `is_site`: the three passes in the mapper's order (shortest axis
    first), each with the block mask the solve gives it (`needed_masks`),
    each fed the plain chain's previous output, each held bit for bit. The
    plain chain gathered back to the slots must equal the path's ESDF
    channel `esdf_sq` on every slot. Emits one kernel_check line per pass
    and returns them by kernel name."""
    import torch
    from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
    in_region, row = ed.region_rows(state.block_index_of_slot,
                                    state.alloc_count, origin_t, dims_b)
    seeds = ed.seed_grid(is_site, in_region, row, dims_b)
    axes = ed.pass_order(seeds.shape)
    masks = ed.needed_masks(row, dims_b, band)
    nvox = seeds.numel()
    n_sites = int((seeds == 0).sum())
    if n_sites == 0:
        fail(f"the {path} ESDF region holds no site")
    hb = (band + 7) // 8
    edt_rows = {}
    inp = seeds
    for i, (axis, need) in enumerate(zip(axes, masks)):
        name, match = (("edt_pass1", "edt_sweep") if i == 0
                       else ("edt_pass", "edt_minplus"))
        fk = getattr(ed, name)
        fp = getattr(ed, name + "_plain")
        got = fk(inp, axis, band, need)
        ref = fp(inp, axis, band, need)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, ref))
        max_err = float((got - ref).abs().max())
        ms, how = kernel_ms(lambda: fk(inp, axis, band, need), match)
        # Least work: every output written once; the input of the blocks
        # within the band of a needed block along the line read once; per
        # needed voxel the two sweeps (pass 1), or 3 operations for each
        # offset k with k^2 below the output, which an exact method must
        # examine (the banded passes).
        in_blocks = int(ed.dilate_blocks(need, axis, hb).sum())
        n_need = int(need.sum()) * 512
        if i == 0:
            n_ops = 5.0 * n_need
        else:
            fin = ref < float(ed.INF)
            reach = (torch.ceil(torch.sqrt(ref[fin])) - 1).clamp(0, band)
            n_ops = 3.0 * float(reach.sum())
            del fin, reach
        b_ms, b_by = bound_ms(nvox * 4 + in_blocks * 512 * 4, n_ops)
        row_i = {"phase": "kernel_check", "name": name, "path": path,
                 "axis": axis, "grid": list(seeds.shape),
                 "sites": n_sites, "band": band,
                 "pruned_share": 1 - n_need / nvox,
                 "input_share": in_blocks * 512 / nvox,
                 "bit_exact": exact, "max_abs_err": max_err,
                 "ms": ms, "ms_timing": how,
                 "ms_call": cuda_ms(lambda: fk(inp, axis, band, need)),
                 "plain_ms": cuda_ms(lambda: fp(inp, axis, band, need)),
                 "plain_device_ms": plain_device_ms(
                     lambda: fp(inp, axis, band, need)),
                 "bound_ms": b_ms, "bound_by": b_by}
        CHECKS.append(row_i)
        if not exact:
            fail(f"{name} along axis {axis} is not bit-exact on the {path} "
                 f"region")
        if how != "profiler":
            fail(f"the profiler's trace holds no {match} kernel for {name}")
        edt_rows.setdefault(name, []).append(row_i)
        del got
        inp = ref
    sq_plain = ed.gather_slots(inp, in_region, row, band)
    if not torch.equal(sq_plain, esdf_sq):
        fail(f"the {path} ESDF channel differs from the plain passes' solve")
    return edt_rows


def whole_map_region(m, dev):
    """(origin i32[3] on `dev`, dims in blocks) of the region a whole-map
    `update_esdf` solves: the mapper's touched-block AABB, each extent
    rounded up to its coarse bucket."""
    import torch
    from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import (
        _bucket_blocks_coarse)
    dims_b = tuple(_bucket_blocks_coarse(n) for n in esdf_aabb_blocks(m))
    return (torch.as_tensor(np.asarray(m._aabb_lo), dtype=torch.int32,
                            device=dev), dims_b)


def occupancy_phase(dev, smi, camera, scene, depths_r, poses_np, voxel,
                    world):
    """The static_occupancy mode's path: every frame integrate_depth
    (kernel occupancy_fuse), ESDF from occupied voxels every 4th, decay
    every 8th (the node's 40 / 10 / 5 Hz). Returns its kernels row."""
    import torch
    from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
    from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks
    from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
    from isaac_ros_nvblox_tpu_torch.mapper.params import (MapperParams,
                                                          ProjectiveLayerType)
    from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
    from isaac_ros_nvblox_tpu_torch.ops import view as view_ops
    from isaac_ros_nvblox_tpu_torch.ops.occupancy import integrate_occupancy
    from isaac_ros_nvblox_tpu_torch.ops.occupancy_cuda import (
        integrate_occupancy_cuda)

    params = MapperParams()
    occ = params.occupancy
    n_steps = depths_r.shape[0]
    n_orbit = len(poses_np)
    grid_kw = dict(camera=camera, voxel_size_m=voxel,
                   max_distance_m=occ.max_integration_distance_m,
                   truncation_m=occ.occupied_region_half_width_m)
    worst = max(int(view_ops.touched_block_grid(
        depths_r[k], torch.as_tensor(poses_np[k], device=dev),
        **grid_kw)[0].sum()) for k in range(n_orbit))
    max_blocks = bucket_of(worst)

    def run():
        m = DeviceMapper(voxel, params=params, world=world,
                         projective_layer=ProjectiveLayerType.OCCUPANCY,
                         max_blocks_per_frame=max_blocks, device=dev)
        for k in range(n_steps):
            m.integrate_depth(depths_r[k], poses_np[k % n_orbit], camera)
            if (k + 1) % 8 == 0:
                m.decay()
            if (k + 1) % 4 == 0:
                m.update_esdf()
        return m

    run()                                   # warm-up
    m, launches, times = timed_run(run, n_steps)
    PATH_LAUNCHES["occupancy_frames"] = launches
    for name in ("occupancy_fuse", "edt_pass1", "edt_pass"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the occupancy path")
    n_occ = launches["occupancy_fuse"]
    overflow = int(m.state.overflow_count)
    n_blocks = m.block_count()
    n_alloc = int(m.state.alloc_count)

    # Accuracy against the analytic scene, on the live slots.
    live = wg.live_slot_mask(m.state)[:n_alloc]
    ch = m.channels
    bidx = m.state.block_index_of_slot[:n_alloc]
    gt = scene.sdf(voxel_centers_for_blocks(torch.where(
        live[:, None], bidx, torch.zeros_like(bidx)), voxel))
    sq = ch["esdf_sq_dist"][:n_alloc]
    inside = ch["esdf_is_inside"][:n_alloc]
    lo = ch["occupancy_log_odds"][:n_alloc]
    obs = ch["occupancy_observed"][:n_alloc] > 0
    if not (bool(torch.isfinite(lo).all()) and bool(torch.isfinite(gt).all())):
        fail("occupancy rows or the scene SDF are not finite")
    est = torch.clamp_max(torch.sqrt(torch.clamp_max(sq, esdf_ops.INF_SQ))
                          * voxel, 2.0)
    est = torch.where(inside, -est, est)
    emask = live[:, None] & (gt > 3 * voxel) & (gt < 1.0) & (sq < 1e11)
    esdf_mae = float((est - gt).abs()[emask].mean())
    occupied = live[:, None] & obs & (lo > 0)
    near = gt.abs() <= occ.occupied_region_half_width_m + voxel * np.sqrt(
        3.0) / 2
    occ_share = float((occupied & near).sum()) / max(int(occupied.sum()), 1)
    row = {"phase": "occupancy_frames", "frames": n_steps, "esdf_every": 4,
           "decay_every": 8, "max_blocks_per_frame": max_blocks,
           **times, "launches": launches,
           "allocated_blocks": n_blocks, "alloc_high_water": n_alloc,
           "esdf_aabb_blocks": esdf_aabb_blocks(m),
           "blocks_freed_by_decay": int(m.removed_count),
           "overflow_count": overflow, "esdf_mae_m": esdf_mae,
           "esdf_voxels_scored": int(emask.sum()),
           "occupied_voxels": int(occupied.sum()),
           "occupied_near_surface_share": occ_share,
           "limits": {"esdf_mae_m": OCC_ESDF_MAE_LIMIT_M,
                      "occupied_near_surface_share": OCC_NEAR_SHARE_MIN},
           "nvidia_smi": smi}
    emit(row)
    if n_occ != n_steps:
        fail(f"occupancy_fuse launched {n_occ} times in a run of "
             f"{n_steps} frames")
    if overflow != 0:
        fail(f"occupancy path overflow_count {overflow} != 0")
    if not esdf_mae <= OCC_ESDF_MAE_LIMIT_M:
        fail(f"occupancy esdf_mae_m {esdf_mae} > {OCC_ESDF_MAE_LIMIT_M}")
    if not occ_share >= OCC_NEAR_SHARE_MIN:
        fail(f"occupied_near_surface_share {occ_share} < "
             f"{OCC_NEAR_SHARE_MIN}")

    # edt_pass1 / edt_pass on the run's last ESDF region, seeded from the
    # occupied voxels: the whole map, since the decay just before that
    # update touched every allocated block.
    site, _, _ = esdf_ops.esdf_sites_from_occupancy(
        ch["occupancy_log_odds"], ch["occupancy_observed"] > 0,
        occupied_log_odds_threshold=float(
            params.esdf.occupied_log_odds_threshold))
    edt_check(m.state, site, ch["esdf_sq_dist"], *whole_map_region(m, dev),
              m.esdf_band_vox, "occupancy_frames")
    del site

    # occupancy_fuse against its plain version on frame 0's batch of the
    # built map.
    st = wg.WorldGridState(**{k: v.clone() for k, v in vars(m.state).items()})
    T0 = torch.as_tensor(poses_np[0], device=dev)
    grid, origin = view_ops.touched_block_grid(depths_r[0], T0, **grid_kw)
    st, slots, bidx0, _ = wg.allocate_and_batch(st, grid, origin,
                                                max_blocks=max_blocks)
    kw = dict(camera=camera, voxel_size_m=voxel, params=occ)
    base = (ch["occupancy_log_odds"].clone(), ch["occupancy_observed"].clone())
    got = [b.clone() for b in base]
    want = [b.clone() for b in base]
    args = (slots, bidx0, depths_r[0], T0)
    integrate_occupancy_cuda(*got, *args, **kw)
    integrate_occupancy(*want, *args, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    max_err = float((got[0] - want[0]).abs().max())
    cap = m.capacity
    n_valid = int((slots < cap).sum())
    n_view = in_view_voxels(slots, bidx0, T0, camera, voxel, cap)
    n_upd = int(changed(want, base).sum())

    def run_k(sel=slice(None)):
        integrate_occupancy_cuda(*got, slots[sel], bidx0[sel], *args[2:], **kw)

    ms, how = kernel_ms(run_k, "occupancy_fuse_kernel")
    # The batch's real entries alone (what its padding costs), and its
    # first real entry alone (a launch and one block's chain of loads).
    real_idx = torch.nonzero((slots >= 0) & (slots < cap)).squeeze(1)
    ms_real, _ = kernel_ms(lambda: run_k(real_idx), "occupancy_fuse_kernel")
    ms_one, _ = kernel_ms(lambda: run_k(real_idx[:1]),
                          "occupancy_fuse_kernel")
    plain = cuda_ms(lambda: integrate_occupancy(*want, *args, **kw))
    plain_dev = plain_device_ms(lambda: integrate_occupancy(*want, *args,
                                                            **kw))
    H, W = depths_r.shape[1:]
    # Each in-view voxel reads its log-odds and observed byte (5 B), an
    # updated one writes them back; the depth image (f32) is read once.
    b_ms, b_by = bound_ms(n_view * 5 + n_upd * 5 + H * W * 4
                          + slots.numel() * 16, n_view * 40)
    check = {"phase": "kernel_check", "name": "occupancy_fuse",
             "batch_blocks": n_valid, "in_view_voxels": n_view,
             "updated_voxels": n_upd, "bit_exact": exact,
             "max_abs_err": max_err, "ms": ms, "ms_timing": how,
             "ms_real_entries": ms_real, "ms_one_entry": ms_one,
             "plain_ms": plain, "plain_device_ms": plain_dev,
             "bound_ms": b_ms, "bound_by": b_by,
             "ptxas": ptxas_rows("occupancy_fuse", OCC_THREADS),
             "launches": n_occ}
    CHECKS.append(check)
    if not exact or n_upd == 0:
        fail(f"occupancy_fuse differs from its plain version: {check}")
    del m, st, got, want, base
    torch.cuda.empty_cache()
    return {"name": "occupancy_fuse", "route": "cuda",
            "source": "isaac_ros_nvblox_tpu_torch/csrc/occupancy_fuse.cu",
            "replaces": "isaac_ros_nvblox_tpu/ops/occupancy_pallas.py:37",
            "launches": n_occ, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def lidar_phase(dev, smi, voxel, world):
    """The 3D-lidar path: every scan integrate_pointcloud (kernel
    tsdf_lidar_fuse), ESDF every 4th, then clearing outside a radius and
    inside a sphere. Returns its kernels row."""
    import torch
    from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
    from isaac_ros_nvblox_tpu_torch.core.types import (
        Transform, voxel_centers_for_blocks)
    from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
    from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
    from isaac_ros_nvblox_tpu_torch.models.lidar import (
        Lidar, pointcloud_to_range_image)
    from isaac_ros_nvblox_tpu_torch.models.scene import (
        cluttered_multi_room_scene)
    from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
    from isaac_ros_nvblox_tpu_torch.ops import view as view_ops
    from isaac_ros_nvblox_tpu_torch.ops.lidar_cuda import (
        integrate_tsdf_lidar_cuda)
    from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                     integrate_tsdf_lidar)

    # The node's lidar (runtime/node.py:75-81, nvblox node_params.hpp).
    lidar = Lidar.equal_vertical_fov(1800, 16, float(np.radians(30.0)),
                                     min_range_m=0.1)
    scene = cluttered_multi_room_scene()
    poses_np = orbit_lidar_poses(32)
    n_steps = len(poses_np)
    points = torch.stack([lidar_scan(scene, lidar, T, dev)
                          for T in poses_np])
    hit_share = float((points.abs().sum(-1) > 0).float().mean())
    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=7.0))
    proj = params.projective
    poses_t = [torch.as_tensor(T, device=dev) for T in poses_np]
    images = [pointcloud_to_range_image(points[k], lidar)
              for k in range(n_steps)]
    grid_kw = dict(lidar=lidar, voxel_size_m=voxel,
                   max_distance_m=proj.max_integration_distance_m,
                   truncation_m=proj.truncation_m(voxel))
    worst = max(int(view_ops.touched_block_grid_lidar(
        images[k], poses_t[k], **grid_kw)[0].sum()) for k in range(n_steps))
    max_blocks = bucket_of(worst)

    def run():
        m = DeviceMapper(voxel, params=params, world=world,
                         enable_color=False,
                         max_blocks_per_frame=max_blocks, device=dev)
        for k in range(n_steps):
            m.integrate_pointcloud(points[k], poses_np[k], lidar)
            if (k + 1) % 4 == 0:
                m.update_esdf()
        return m

    run()                                   # warm-up
    m, launches, times = timed_run(run, n_steps)
    PATH_LAUNCHES["lidar_scans"] = launches
    for name in ("tsdf_lidar_fuse", "edt_pass1", "edt_pass"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the lidar path")
    n_lidar = launches["tsdf_lidar_fuse"]
    overflow = int(m.state.overflow_count)
    n_blocks = m.block_count()
    n_alloc = int(m.state.alloc_count)
    ch = m.channels
    bidx = m.state.block_index_of_slot[:n_alloc]
    gt = scene.sdf(voxel_centers_for_blocks(bidx, voxel))
    tsdf = ch["tsdf_distance"][:n_alloc]
    w = ch["tsdf_weight"][:n_alloc]
    near = (gt.abs() < 0.1) & (w > 0.5)
    tsdf_mae = float((tsdf - gt).abs()[near].mean())
    finite = bool(torch.isfinite(tsdf).all()) and bool(torch.isfinite(w).all())

    # edt_pass1 / edt_pass on the largest region the path solves: a
    # whole-map update of the finished map (the run's first update solved
    # the whole map of its time, later ones the last scans' range cubes).
    m.update_esdf(full=True)
    site, _, _ = esdf_ops.esdf_sites_from_tsdf(
        ch["tsdf_distance"], ch["tsdf_weight"], voxel_size_m=voxel,
        max_site_distance_vox=params.esdf.max_site_distance_vox,
        min_weight=params.esdf.min_weight)
    edt_check(m.state, site, ch["esdf_sq_dist"], *whole_map_region(m, dev),
              m.esdf_band_vox, "lidar_scans")
    del site

    # Clearing at the end of the run: outside 5 m of the last pose, and
    # inside one sphere (around room B's small sphere, 1.5 m from the last
    # pose).
    removed0 = int(m.removed_count)
    live0 = n_blocks
    torch.cuda.synchronize()
    t = time.perf_counter()
    m.clear_outside_radius(poses_np[-1][:3, 3], 5.0)
    torch.cuda.synchronize()
    t_radius = time.perf_counter() - t
    w_before = int((m.channels["tsdf_weight"] > 0).sum())
    t = time.perf_counter()
    m.clear_tsdf_inside_shapes(spheres=[((3.8, 1.0, 0.3), 0.5)])
    torch.cuda.synchronize()
    t_shapes = time.perf_counter() - t
    freed = int(m.removed_count) - removed0
    unobserved = w_before - int((m.channels["tsdf_weight"] > 0).sum())
    row = {"phase": "lidar_scans", "scans": n_steps,
           "lidar": [lidar.num_azimuth_divisions,
                     lidar.num_elevation_divisions],
           "ray_hit_share": hit_share, "esdf_every": 4,
           "max_blocks_per_frame": max_blocks, **times,
           "launches": launches,
           "allocated_blocks": live0, "alloc_high_water": n_alloc,
           "esdf_aabb_blocks": esdf_aabb_blocks(m),
           "overflow_count": overflow, "tsdf_mae_m": tsdf_mae,
           "tsdf_voxels_scored": int(near.sum()),
           "blocks_freed_by_clear_outside_radius": freed,
           "blocks_after_clearing": m.block_count(),
           "voxels_unobserved_by_sphere": unobserved,
           "clear_outside_radius_ms": t_radius * 1e3,
           "clear_tsdf_inside_shapes_ms": t_shapes * 1e3,
           "limits": {"tsdf_mae_m": LIDAR_TSDF_MAE_LIMIT_M},
           "nvidia_smi": smi}
    emit(row)
    if n_lidar != n_steps:
        fail(f"tsdf_lidar_fuse launched {n_lidar} times in a run of "
             f"{n_steps} scans")
    if overflow != 0:
        fail(f"lidar path overflow_count {overflow} != 0")
    if not finite:
        fail("lidar TSDF rows are not finite")
    if not tsdf_mae <= LIDAR_TSDF_MAE_LIMIT_M:
        fail(f"lidar tsdf_mae_m {tsdf_mae} > {LIDAR_TSDF_MAE_LIMIT_M}")
    if freed <= 0 or unobserved <= 0:
        fail(f"clearing freed {freed} blocks, unobserved {unobserved} voxels")

    # tsdf_lidar_fuse against its plain version on scan 0's batch of the
    # built map (a 360-degree scan: the batch straddles the +-pi seam).
    st = wg.WorldGridState(**{k: v.clone() for k, v in vars(m.state).items()})
    grid, origin = view_ops.touched_block_grid_lidar(images[0], poses_t[0],
                                                     **grid_kw)
    st, slots, bidx0, _ = wg.allocate_and_batch(st, grid, origin,
                                                max_blocks=max_blocks)
    kw = dict(lidar=lidar, voxel_size_m=voxel, params=proj)
    base = (ch["tsdf_distance"].clone(), ch["tsdf_weight"].clone())
    got = [b.clone() for b in base]
    want = [b.clone() for b in base]
    args = (slots, bidx0, images[0], poses_t[0])
    integrate_tsdf_lidar_cuda(*got, *args, **kw)
    integrate_tsdf_lidar(*want, *args, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(got, want))
    max_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    cap = m.capacity
    real = (slots >= 0) & (slots < cap)
    untouched = rows_untouched(got, base, slots[real])
    p_S = Transform.apply(Transform.inverse(poses_t[0]),
                          voxel_centers_for_blocks(bidx0, voxel))
    uv, r_vox, ok = lidar.project(p_S)
    ok = ok & real[:, None]
    n_view, n_upd = tsdf_reads_writes(uv, r_vox, ok, images[0], proj, voxel)
    A = lidar.num_azimuth_divisions
    # In-view voxels within 8 columns (1.6 degrees) on either side of the
    # +-pi seam.
    seam = int((ok & ((uv[..., 0] < 8.0) | (uv[..., 0] > A - 8.0))).sum())
    n_changed = int(changed(want, base).sum())
    if not exact:
        # Name the voxels that differ, for the record.
        diff = changed(got, want)
        emit({"phase": "kernel_check_detail", "name": "tsdf_lidar_fuse",
              "differing_voxels": int(diff.sum())})
    def run_k(sel=slice(None)):
        integrate_tsdf_lidar_cuda(*got, slots[sel], bidx0[sel], *args[2:],
                                  **kw)

    ms, how = kernel_ms(run_k, "tsdf_lidar_fuse_kernel")
    # The batch's real entries alone, and its first real entry alone.
    real_idx = torch.nonzero(real).squeeze(1)
    ms_real, _ = kernel_ms(lambda: run_k(real_idx), "tsdf_lidar_fuse_kernel")
    ms_one, _ = kernel_ms(lambda: run_k(real_idx[:1]),
                          "tsdf_lidar_fuse_kernel")
    plain = cuda_ms(lambda: integrate_tsdf_lidar(*want, *args, **kw))
    plain_dev = plain_device_ms(lambda: integrate_tsdf_lidar(*want, *args,
                                                             **kw))
    E = lidar.num_elevation_divisions
    # Each in-view voxel reads its distance and weight (8 B), an updated
    # one writes them back; the range image (f32) is read once, the
    # batch's slots and block indices and the pose once. Two atan2 and two
    # roots per in-view voxel: ~150 operations.
    b_ms, b_by = bound_ms(n_view * 8 + n_upd * 8 + E * A * 4
                          + slots.numel() * 16 + 64, n_view * 150)
    check = {"phase": "kernel_check", "name": "tsdf_lidar_fuse",
             "batch_blocks": int(real.sum()), "in_view_voxels": n_view,
             "seam_voxels": seam, "updated_voxels": n_upd,
             "changed_voxels": n_changed,
             "bit_exact": exact, "rows_untouched": untouched,
             "max_abs_err": max_err, "ms": ms, "ms_timing": how,
             "ms_real_entries": ms_real, "ms_one_entry": ms_one,
             "plain_ms": plain,
             "plain_device_ms": plain_dev, "bound_ms": b_ms,
             "bound_by": b_by, "launches": n_lidar}
    CHECKS.append(check)
    if not exact or not untouched or n_changed == 0 or seam == 0:
        fail(f"tsdf_lidar_fuse differs from its plain version: {check}")
    del m, st, got, want, base, points
    torch.cuda.empty_cache()
    return {"name": "tsdf_lidar_fuse", "route": "cuda",
            "source": "isaac_ros_nvblox_tpu_torch/csrc/tsdf_lidar_fuse.cu",
            "replaces": "isaac_ros_nvblox_tpu/ops/lidar_pallas.py:36",
            "launches": n_lidar, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def intruder_center(k: int):
    """The intruder of tools/dynamics_quality.py:80-91: a 0.25 m sphere
    flying across the room, its centre on frame k of 8."""
    t = k / 7.0
    return (-1.6 + 3.2 * t, 1.4 - 2.2 * t, 1.0)


def detect_reads(state, p_L, depth_s, voxel: float, max_depth: float):
    """(distinct slot_grid cells, distinct high_confidence bytes) the
    detection's evaluated pixels read: a pixel with 0 < z <= max depth
    whose endpoint lies in the world grid reads its cell's slot, and one
    whose block is allocated its voxel's byte."""
    import torch
    from isaac_ros_nvblox_tpu_torch.core.types import recip32
    g = torch.floor(p_L * recip32(voxel)).clamp(-2.0 ** 30, 2.0 ** 30).to(
        torch.int32)
    b = torch.div(g, 8, rounding_mode="floor")
    cell = b - state.origin_block
    D = state.slot_grid.shape
    z = depth_s.reshape(-1)
    ok = (z > 0) & (z <= max_depth)
    for a in range(3):
        ok &= (cell[:, a] >= 0) & (cell[:, a] < D[a])
    lin = ((cell[:, 0] * D[1] + cell[:, 1]) * D[2] + cell[:, 2])[ok].long()
    slot = state.slot_grid.reshape(-1)[lin].long()
    l = (g - b * 8)[ok].long()
    byte = (slot * 512 + (l[:, 0] * 8 + l[:, 1]) * 8 + l[:, 2])[slot >= 0]
    return int(torch.unique(lin).numel()), int(torch.unique(byte).numel())


def dynamics_phase(dev, smi, camera, depths_r, poses_r, max_blocks: int,
                   voxel: float, world):
    """The dynamic mapping mode. (a) Timed, the bench's dynamics row: the
    main path's 64 frames 25 ms apart through `replay_frames_dynamic`, the
    first replay without a freespace region, then replays over the
    allocated AABB with slot bucket 4096; against plain `replay_frames` of
    the same frames. (b) Scored, tools/dynamics_quality.py's scene: the
    map built from the room and box, then 8 intruder frames detected and
    integrated. Holds dilate_dense and detect_dynamic against their plain
    versions, and occupancy_fuse on the batch the dynamic path's frame
    builds (fields added to its kernel_check line). Returns the scored
    MultiMapper with its intruder frames [(depth, pose tensor, pose)],
    and the kernels rows of dilate_dense and detect_dynamic."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from isaac_ros_nvblox_tpu_torch import kernels
    from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
    from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as dm
    from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
    from isaac_ros_nvblox_tpu_torch.mapper.multi_mapper import MultiMapper
    from isaac_ros_nvblox_tpu_torch.mapper.params import (MapperParams,
                                                          MappingType,
                                                          MultiMapperParams)
    from isaac_ros_nvblox_tpu_torch.models.scene import (Box, RoomBox, Scene,
                                                         Sphere, orbit_pose,
                                                         render_depth)
    from isaac_ros_nvblox_tpu_torch.ops import halo
    from isaac_ros_nvblox_tpu_torch.ops import view as view_ops
    from isaac_ros_nvblox_tpu_torch.ops.detect import detect_dynamic_plain
    from isaac_ros_nvblox_tpu_torch.ops.detect_cuda import detect_dynamic
    from isaac_ros_nvblox_tpu_torch.ops.occupancy import integrate_occupancy
    from isaac_ros_nvblox_tpu_torch.ops.occupancy_cuda import (
        integrate_occupancy_cuda)
    from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams

    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=5.0))
    static = dataclasses.replace(params,
                                 remove_small_connected_components=False)
    max_depth = 5.0

    def multi(mb):
        return MultiMapper(MultiMapperParams(
            mapping_type=MappingType.DYNAMIC, block_capacity=16384,
            max_blocks_per_frame=mb, static_mapper=static), world=world,
            device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    # ---- (a) timed: the bench's dynamics row ------------------------------
    n_steps = depths_r.shape[0]
    slot_bucket = 4096
    mm = multi(max_blocks)
    sm = mm.static_mapper
    clock = [0.0]

    def dyn_pass(region=None):
        times = clock[0] + 25.0 * torch.arange(n_steps, device=dev,
                                               dtype=torch.float32)
        clock[0] += 25.0 * n_steps
        mm.replay_frames_dynamic(depths_r, poses_r, times, camera,
                                 region=region,
                                 slot_bucket=slot_bucket if region else 0)

    dyn_pass()                       # warm-up: no region, view-batch form
    sm._refresh_region_from_device()
    region = sm.esdf_region(margin_blocks=0, mult=1)

    def fast():
        dyn_pass(region)

    fast()                           # warm-up of the full-pool form
    plain = DeviceMapper(voxel, params=params, world=world,
                         max_blocks_per_frame=max_blocks, device=dev)
    plain.replay_frames(depths_r, poses_r, camera)
    kernels.reset_launch_counts()
    t_first = timed(fast)
    launches = dict(kernels.LAUNCHES)
    PATH_LAUNCHES["dynamic_frames"] = launches
    t_plain, t_dyn = [], []
    for _ in range(3):
        t_plain.append(timed(lambda: plain.replay_frames(depths_r, poses_r,
                                                         camera)))
        t_dyn.append(timed(fast))
    diffs = sorted(d - p for d, p in zip(t_dyn, t_plain))
    evs, wall = trace(fast, 1)
    sm.check_slot_bucket()
    busy = sum(us for _, us in evs) / 1e3
    overflow = [int(sm.state.overflow_count),
                int(mm.dynamic_mapper.state.overflow_count)]
    row = {"phase": "dynamic_frames", "part": "timed", "frames": n_steps,
           "frame_spacing_ms": 25.0, "max_blocks_per_frame": max_blocks,
           "dynamic_max_blocks_per_frame":
               mm.dynamic_mapper.max_blocks_per_frame,
           "slot_bucket": slot_bucket,
           "freespace_region_origin": [int(v) for v in region[0]],
           "freespace_region_dims_blocks": [int(v) for v in region[1]],
           "ms_per_frame": float(np.median(t_dyn)) / n_steps * 1e3,
           "dynamics_ms": diffs[len(diffs) // 2] / n_steps * 1e3,
           "plain_replay_ms_per_frame": float(np.median(t_plain))
           / n_steps * 1e3,
           "replay_s_dynamic": [t_first] + t_dyn, "replay_s_plain": t_plain,
           "device_ms_per_frame": busy / n_steps,
           "device_idle_share": 1 - busy / 1e3 / wall,
           "device_activities_per_frame": len(evs) / n_steps,
           "device_to_host_copies": sum(1 for n, _ in evs if "DtoH" in n),
           "top_per_frame": top_kernels(evs, n_steps, 8),
           "launches": launches, "allocated_blocks": sm.block_count(),
           "alloc_high_water": int(sm.state.alloc_count),
           "dynamic_blocks": mm.dynamic_mapper.block_count(),
           "overflow_count": overflow, "nvidia_smi": smi}
    emit(row)
    for name in ("detect_dynamic", "tsdf_fuse", "occupancy_fuse",
                 "dilate_dense"):
        if launches[name] != n_steps:
            fail(f"{name} launched {launches[name]} times in a dynamic "
                 f"replay of {n_steps} frames")
    if overflow != [0, 0]:
        fail(f"dynamic_frames overflow_count {overflow} != 0")

    # occupancy_fuse on the batch that frame 0 of the replay builds on the
    # built map: the dynamic mapper's view batch of the foreground-masked
    # depth (mask_mode 2), dynamic_max_blocks_per_frame entries.
    dmap = mm.dynamic_mapper
    docc = dmap.params.occupancy
    mask0 = detect_dynamic(
        sm.state, sm.channels["freespace_high_confidence"], depths_r[0],
        poses_r[0], camera=camera, voxel_size_m=voxel, max_depth_m=max_depth,
        subsample=int(mm.params.dynamic_detection_subsample))
    fg = dm._masked_depth(depths_r[0], mask0, 2)
    dst = wg.WorldGridState(**{k: v.clone()
                               for k, v in vars(dmap.state).items()})
    _, dslots, dbidx = dm._allocate_view(
        dst, view_ops.touched_block_grid(
            fg, poses_r[0], camera=camera, voxel_size_m=voxel,
            max_distance_m=float(docc.max_integration_distance_m),
            truncation_m=float(docc.occupied_region_half_width_m)),
        voxel_size_m=voxel, max_blocks=dmap.max_blocks_per_frame)
    dkw = dict(camera=camera, voxel_size_m=voxel, params=docc)
    dargs = (dslots, dbidx, fg, poses_r[0])
    dbase = (dmap.channels["occupancy_log_odds"].clone(),
             dmap.channels["occupancy_observed"].clone())
    dgot = [b.clone() for b in dbase]
    dwant = [b.clone() for b in dbase]
    integrate_occupancy_cuda(*dgot, *dargs, **dkw)
    integrate_occupancy(*dwant, *dargs, **dkw)
    torch.cuda.synchronize()
    dexact = all(torch.equal(a, b) for a, b in zip(dgot, dwant))
    # Its bound, counted as the occupancy path's batch counts it.
    d_view = in_view_voxels(dslots, dbidx, poses_r[0], camera, voxel,
                            dmap.capacity)
    d_upd = int(changed(dwant, dbase).sum())
    b_dyn, b_dyn_by = bound_ms(d_view * 5 + d_upd * 5 + fg.numel() * 4
                               + dslots.numel() * 16, d_view * 40)
    ms_dyn, _ = kernel_ms(lambda: integrate_occupancy_cuda(*dgot, *dargs,
                                                           **dkw),
                          "occupancy_fuse_kernel")
    occ_check = next(c for c in CHECKS if c["name"] == "occupancy_fuse")
    occ_check.update({
        "ms_dynamic_batch": ms_dyn,
        "bound_ms_dynamic_batch": b_dyn,
        "bound_by_dynamic_batch": b_dyn_by,
        "dynamic_batch_in_view_voxels": d_view,
        "dynamic_batch_updated_voxels": d_upd,
        "dynamic_batch_entries": int(dslots.numel()),
        "dynamic_batch_real_entries": int(
            ((dslots >= 0) & (dslots < dmap.capacity)).sum()),
        "dynamic_batch_dynamic_pixels": int((mask0 > 0).sum()),
        "dynamic_batch_bit_exact": dexact})
    if not dexact:
        fail(f"occupancy_fuse differs from its plain version on the dynamic "
             f"path's batch: {occ_check}")
    del dst, dbase, dgot, dwant

    # dilate_dense on the replay's own region: the occupancy indicator of
    # the built map over the freespace region, as the path assembles it.
    fs = static.freespace
    ch = sm.channels
    occ = ((ch["tsdf_distance"][:slot_bucket]
            < fs.max_tsdf_distance_for_occupancy_m)
           & (ch["tsdf_weight"][:slot_bucket] > 1e-6)).float()
    dims = tuple(int(d) for d in region[1])
    dense, _, _ = halo.assemble_dense_grid(
        occ, sm.state.block_index_of_slot[:slot_bucket], sm.state.alloc_count,
        torch.as_tensor(np.asarray(region[0]), dtype=torch.int32,
                        device=dev), dims)

    def voxels(g):
        """A dense grid as one [1, 1, 8Cx, 8Cy, 8Cz] voxel volume."""
        cx, cy, cz = g.shape[:3]
        return g.view(cx, cy, cz, 8, 8, 8).permute(0, 3, 1, 4, 2, 5).reshape(
            1, 1, 8 * cx, 8 * cy, 8 * cz)

    got = halo.dilate_dense_grid(dense)
    want = halo.dilate_dense_grid_plain(dense)
    vol = voxels(dense).contiguous()
    lib = F.max_pool3d(vol, 3, stride=1, padding=1)
    torch.cuda.synchronize()
    exact9 = bool(torch.equal(got, want))
    lib_equal = bool(torch.equal(lib, voxels(got)))
    err9 = float((got - want).abs().max())
    g = torch.Generator(device="cpu").manual_seed(9)
    shapes = []
    for shape in ((1, 5, 3), (4, 3, 1), (7, 5, 9), (1, 1, 1), dims):
        r = torch.rand(shape + (512,), generator=g)
        grid = torch.where(r < 0.05, torch.rand(shape + (512,), generator=g)
                           * 7.0, 0.0).to(dev)
        a, b = halo.dilate_dense_grid(grid), halo.dilate_dense_grid_plain(grid)
        c = F.max_pool3d(voxels(grid).contiguous(), 3, stride=1, padding=1)
        torch.cuda.synchronize()
        shapes.append({"dims": list(shape), "bit_exact": bool(torch.equal(a, b)),
                       "equals_max_pool3d": bool(torch.equal(c, voxels(a)))})
        err9 = max(err9, float((a - b).abs().max()))
    ms9, how9 = kernel_ms(lambda: halo.dilate_dense_grid(dense),
                          "dilate_dense_kernel")
    plain9 = cuda_ms(lambda: halo.dilate_dense_grid_plain(dense))
    plain9_dev = plain_device_ms(lambda: halo.dilate_dense_grid_plain(dense))
    lib9 = plain_device_ms(lambda: F.max_pool3d(vol, 3, stride=1, padding=1))
    lib9_call = cuda_ms(lambda: F.max_pool3d(vol, 3, stride=1, padding=1))
    copy9 = plain_device_ms(lambda: dense.clone())
    nvox = dense.numel()
    # The dense grid is read once and written once (f32); 26 comparisons
    # a voxel.
    b9, b9_by = bound_ms(2 * nvox * 4, 26 * nvox)
    check9 = {"phase": "kernel_check", "name": "dilate_dense",
              "grid_blocks": list(dims), "voxels": nvox,
              "occupied_voxels": int(dense.sum()),
              "dilated_voxels": int(want.sum()), "bit_exact": exact9,
              "equals_max_pool3d": lib_equal, "edge_shapes": shapes,
              "max_abs_err": err9, "ms": ms9, "ms_timing": how9,
              "plain_ms": plain9, "plain_device_ms": plain9_dev,
              "library_ms": lib9, "library_ms_call": lib9_call,
              "library": "F.max_pool3d(kernel 3, stride 1, padding 1) on "
                         "[1, 1, 8Cx, 8Cy, 8Cz], permutes not timed",
              "bound_ms": b9, "bound_by": b9_by, "copy_ms": copy9,
              "ptxas": ptxas_rows("dilate", DILATE_THREADS),
              "launches": launches["dilate_dense"]}
    CHECKS.append(check9)
    if not (exact9 and lib_equal and int(want.sum()) > int(dense.sum()) > 0
            and all(s["bit_exact"] and s["equals_max_pool3d"]
                    for s in shapes)):
        fail(f"dilate_dense differs from its plain version: {check9}")
    del mm, plain, dense, got, want, vol, lib
    torch.cuda.empty_cache()

    # ---- (b) scored: tools/dynamics_quality.py's scene ---------------------
    room = Scene(primitives=(
        RoomBox(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
        Box(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4))))
    n_orbit = 16
    poses16 = [orbit_pose(2 * np.pi * k / n_orbit, radius=1.5)
               for k in range(n_orbit)]
    pt = torch.stack([torch.as_tensor(T, device=dev) for T in poses16])
    d16 = torch.stack([render_depth(room, camera, pt[k], device=dev)
                       for k in range(n_orbit)])
    dr, pr = torch.cat([d16] * 4), torch.cat([pt] * 4)
    times = 300.0 * torch.arange(4 * n_orbit, device=dev, dtype=torch.float32)
    sc = multi(2048)
    s2 = sc.static_mapper
    sc.replay_frames_dynamic(dr[:n_orbit], pr[:n_orbit], times[:n_orbit],
                             camera)
    s2._refresh_region_from_device()
    region2 = s2.esdf_region(margin_blocks=0, mult=1)
    sc.replay_frames_dynamic(dr[n_orbit:], pr[n_orbit:], times[n_orbit:],
                             camera, region=region2)
    hc = s2.channels["freespace_high_confidence"]
    n_hc = int(hc.sum())
    frames, intr = [], []
    for k in range(8):
        scene = Scene(primitives=room.primitives + (
            Sphere(center=intruder_center(k), radius=0.25),))
        d_static = render_depth(room, camera, pt[k], device=dev)
        d_intr = render_depth(scene, camera, pt[k], device=dev)
        gt = (d_intr < d_static - 2 * voxel) & (d_intr > 0) & (
            d_intr <= max_depth)
        mask = sc.detect_dynamic(d_intr, pt[k], camera) > 0
        n_gt = max(int(gt.sum()), 1)
        frames.append({"gt_pixels": int(gt.sum()),
                       "detected": int(mask.sum()),
                       "tpr": int((mask & gt).sum()) / n_gt,
                       "fpr": int((mask & ~gt).sum())
                       / max(int((~gt).sum()), 1)})
        intr.append((d_intr, pt[k], poses16[k]))

    # detect_dynamic on each intruder frame of the built map, subsample 1
    # and 2, against its plain version.
    det_kw = dict(camera=camera, voxel_size_m=voxel, max_depth_m=max_depth)
    exact10, err10 = True, 0.0
    for d_intr, T_t, _ in intr:
        for s in (1, 2):
            a = detect_dynamic(s2.state, hc, d_intr, T_t, subsample=s,
                               **det_kw)
            b = detect_dynamic_plain(s2.state, hc, d_intr, T_t, subsample=s,
                                     **det_kw)[0].to(torch.uint8)
            torch.cuda.synchronize()
            exact10 &= bool(torch.equal(a, b))
            err10 = max(err10, float((a.float() - b.float()).abs().max()))
    big = int(np.argmax([f["gt_pixels"] for f in frames]))
    d_big, T_big, _ = intr[big]
    H, W = d_big.shape
    _, p_L = detect_dynamic_plain(s2.state, hc, d_big, T_big, **det_kw)
    n_cells, n_bytes = detect_reads(s2.state, p_L, d_big, voxel, max_depth)
    ms10, how10 = kernel_ms(lambda: detect_dynamic(s2.state, hc, d_big, T_big,
                                                   **det_kw),
                            "detect_dynamic_kernel")
    # The floor (every pixel fails the depth test) and subsample 2.
    d_zero = torch.zeros_like(d_big)
    got0 = detect_dynamic(s2.state, hc, d_zero, T_big, **det_kw)
    want0 = detect_dynamic_plain(s2.state, hc, d_zero, T_big, **det_kw)[0]
    torch.cuda.synchronize()
    exact10 &= bool(torch.equal(got0, want0.to(torch.uint8)))
    ms10_zero, _ = kernel_ms(lambda: detect_dynamic(s2.state, hc, d_zero,
                                                    T_big, **det_kw),
                             "detect_dynamic_kernel")
    ms10_s2, _ = kernel_ms(lambda: detect_dynamic(s2.state, hc, d_big, T_big,
                                                  subsample=2, **det_kw),
                           "detect_dynamic_kernel")
    plain10 = cuda_ms(lambda: detect_dynamic_plain(s2.state, hc, d_big, T_big,
                                                   **det_kw))
    plain10_dev = plain_device_ms(lambda: detect_dynamic_plain(
        s2.state, hc, d_big, T_big, **det_kw))
    # Each pixel reads its depth (f32) and writes its mask byte; the
    # endpoints read the distinct slot_grid entries (i32) and
    # high_confidence bytes they land in. About 30 operations a pixel.
    b10, b10_by = bound_ms(H * W * 5 + n_cells * 4 + n_bytes, 30 * H * W)

    # The 8 frames through the eager tick, 300 ms steps on.
    for k, (d_intr, _, T) in enumerate(intr):
        sc.integrate_depth(d_intr, T, camera, time_ms=300.0 * (64 + k))
    n_occ = int((sc.dynamic_mapper.channels["occupancy_log_odds"] > 0).sum())
    overflow2 = [int(s2.state.overflow_count),
                 int(sc.dynamic_mapper.state.overflow_count)]
    mean_tpr = float(np.mean([f["tpr"] for f in frames]))
    scored = {"phase": "dynamic_frames", "part": "scored",
              "frames_built": 4 * n_orbit, "frame_spacing_ms": 300.0,
              "freespace_region_origin": [int(v) for v in region2[0]],
              "freespace_region_dims_blocks": [int(v) for v in region2[1]],
              "allocated_blocks": s2.block_count(),
              "high_confidence_voxels": n_hc, "intruder_frames": frames,
              "mean_tpr": mean_tpr,
              "mean_fpr": float(np.mean([f["fpr"] for f in frames])),
              "dynamic_occupied_voxels": n_occ, "overflow_count": overflow2,
              "reference": {"high_confidence_voxels": DYN_REF_HC_VOXELS,
                            "detected": list(DYN_REF_DETECTED),
                            "mean_tpr": DYN_REF_MEAN_TPR,
                            "dynamic_occupied_voxels": DYN_REF_OCCUPIED},
              "tolerances": {"high_confidence_voxels": DYN_HC_TOL,
                             "detected": DYN_DETECTED_TOL,
                             "mean_tpr": DYN_TPR_TOL,
                             "dynamic_occupied_voxels": DYN_OCCUPIED_TOL},
              "nvidia_smi": smi}
    emit(scored)
    check10 = {"phase": "kernel_check", "name": "detect_dynamic",
               "frames": len(intr), "subsamples": [1, 2],
               "bit_exact": exact10, "max_abs_err": err10,
               "timed_frame": big, "image": [H, W],
               "slot_cells_read": n_cells, "high_confidence_bytes_read":
               n_bytes, "ms": ms10, "ms_timing": how10,
               "ms_zero_depth": ms10_zero, "ms_subsample2": ms10_s2,
               "ptxas": ptxas_rows("detect_dynamic", DETECT_THREADS),
               "plain_ms": plain10,
               "plain_device_ms": plain10_dev, "bound_ms": b10,
               "bound_by": b10_by, "library_ms": None,
               "library": "none: no torch call back-projects and looks up "
                          "the voxel",
               "launches": launches["detect_dynamic"]}
    CHECKS.append(check10)
    if not exact10:
        fail(f"detect_dynamic differs from its plain version: {check10}")
    if overflow2 != [0, 0]:
        fail(f"dynamic_frames scored overflow_count {overflow2} != 0")
    if abs(n_hc - DYN_REF_HC_VOXELS) > DYN_HC_TOL * DYN_REF_HC_VOXELS:
        fail(f"high-confidence voxels {n_hc}, reference {DYN_REF_HC_VOXELS}")
    for f, ref in zip(frames, DYN_REF_DETECTED):
        if abs(f["detected"] - ref) > DYN_DETECTED_TOL * ref:
            fail(f"detected pixels {f['detected']}, reference {ref}")
    if mean_tpr < DYN_REF_MEAN_TPR - DYN_TPR_TOL:
        fail(f"mean TPR {mean_tpr}, reference {DYN_REF_MEAN_TPR}")
    if abs(n_occ - DYN_REF_OCCUPIED) > DYN_OCCUPIED_TOL * DYN_REF_OCCUPIED:
        fail(f"dynamic occupied voxels {n_occ}, reference "
             f"{DYN_REF_OCCUPIED}")
    del hc
    torch.cuda.empty_cache()
    return (sc, intr), [{"name": "dilate_dense", "route": "cuda",
             "source": "isaac_ros_nvblox_tpu_torch/csrc/dilate.cu",
             "replaces": "isaac_ros_nvblox_tpu/ops/halo.py:201",
             "launches": launches["dilate_dense"], "max_abs_err": err9,
             "ms": ms9, "plain_ms": plain9, "bound_ms": b9, "bound_by": b9_by,
             "library_ms": lib9},
            {"name": "detect_dynamic", "route": "cuda",
             "source": "isaac_ros_nvblox_tpu_torch/csrc/detect_dynamic.cu",
             "replaces": "isaac_ros_nvblox_tpu/ops/detect_pallas.py:72",
             "launches": launches["detect_dynamic"], "max_abs_err": err10,
             "ms": ms10, "plain_ms": plain10, "bound_ms": b10,
             "bound_by": b10_by, "library_ms": None}]


def site_columns_2d(m, band_m):
    """bool[X, Y]: the site columns of the mapper's 2-D frame, computed on
    the host from its TSDF channels with numpy alone (float32 as the
    reference computes it): a voxel is a site where its weight >=
    min_weight and |d| <= max_site_distance_vox * voxel, and counts where
    its centre's z, (bz*8 + lz + 0.5) * voxel, lies in the band; a column
    is a site where any of its voxels is."""
    ep = m.params.esdf
    (ox, oy), sq2d = m.esdf_2d[0], m.esdf_2d[1]
    X, Y = sq2d.shape
    n = int(m.state.alloc_count)
    bidx = m.state.block_index_of_slot[:n].cpu().numpy()
    d = m.channels["tsdf_distance"][:n].cpu().numpy()
    w = m.channels["tsdf_weight"][:n].cpu().numpy()
    vs = np.float32(m.voxel_size_m)
    site = ((w >= np.float32(ep.min_weight))
            & (np.abs(d) <= np.float32(ep.max_site_distance_vox) * vs))
    lz = (np.arange(512) % 8).astype(np.float32)
    z = (bidx[:, 2:3].astype(np.float32) * 8 + lz + np.float32(0.5)) * vs
    site &= (z >= np.float32(band_m[0])) & (z <= np.float32(band_m[1]))
    col = site.reshape(n, 8, 8, 8).any(-1)
    cx, cy = bidx[:, 0] - ox, bidx[:, 1] - oy
    ok = (cx >= 0) & (cx < X // 8) & (cy >= 0) & (cy < Y // 8)
    seeds = np.zeros((X // 8, Y // 8, 8, 8), bool)
    np.logical_or.at(seeds, (cx[ok], cy[ok]), col[ok])
    return seeds.transpose(0, 2, 1, 3).reshape(X, Y)


def sq2d_scipy(seeds, band: int) -> np.ndarray:
    """Squared distance to the nearest site column: scipy's exact EDT with
    its nearest-site indices, squared in integers; INF (1e12) beyond
    band^2."""
    from scipy import ndimage
    _, idx = ndimage.distance_transform_edt(~seeds, return_indices=True)
    d2 = ((idx - np.indices(seeds.shape)) ** 2).sum(0)
    return np.where(d2 <= band * band, d2.astype(np.float32),
                    np.float32(1e12))


def edt2d_check(site, band: int):
    """edt_pass1 (along x) and edt_pass (along y) against their plain
    versions on the 2-D solve's own grid, f32[X, Y, 1] seeded from the
    collapsed site columns `site` (bool[X, Y] on the card), each pass fed
    the plain chain's previous output and held bit for bit. Emits one
    kernel_check line per pass (path esdf_2d); returns the plain chain's
    output. The passes commute, so each line also times its kernel along
    the other axis (`ms_other_axis`: edt_pass1 along y, contiguous lines;
    edt_pass along x), and the edt_pass line says whether that order's
    chain gives the same field (`other_order_bit_exact`)."""
    import torch
    from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
    inp = torch.where(site, 0.0, float(ed.INF))[..., None].contiguous()
    seeds = inp
    other = ed.edt_pass1(seeds, 1, band)
    nvox = inp.numel()
    n_sites = int(site.sum())
    for axis, name, match in ((0, "edt_pass1", "edt_sweep"),
                              (1, "edt_pass", "edt_minplus")):
        fk = getattr(ed, name)
        fp = getattr(ed, name + "_plain")
        got = fk(inp, axis, band)
        ref = fp(inp, axis, band)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, ref))
        max_err = float((got - ref).abs().max())
        ms, how = kernel_ms(lambda: fk(inp, axis, band), match)
        # Least work: the grid read once and written once; per voxel the
        # two sweeps (pass 1), or 3 operations for each offset k with k^2
        # below the output (the banded pass).
        if axis == 0:
            n_ops = 5.0 * nvox
        else:
            fin = ref < float(ed.INF)
            n_ops = 3.0 * float((torch.ceil(torch.sqrt(ref[fin])) - 1).clamp(
                0, band).sum())
        b_ms, b_by = bound_ms(2 * nvox * 4, n_ops)
        o_in = seeds if axis == 0 else other
        ms_other, _ = kernel_ms(lambda: fk(o_in, 1 - axis, band), match)
        row = {
            "phase": "kernel_check", "name": name, "path": "esdf_2d",
            "axis": axis, "grid": list(inp.shape), "sites": n_sites,
            "band": band, "pruned_share": 0.0, "bit_exact": exact,
            "max_abs_err": max_err, "ms": ms, "ms_timing": how,
            "ms_call": cuda_ms(lambda: fk(inp, axis, band)),
            "ms_other_axis": ms_other,
            "plain_ms": cuda_ms(lambda: fp(inp, axis, band)),
            "plain_device_ms": plain_device_ms(lambda: fp(inp, axis, band)),
            "bound_ms": b_ms, "bound_by": b_by}
        if axis == 1:
            row["other_order_bit_exact"] = bool(torch.equal(
                ed.edt_pass(other, 0, band), ref))
        CHECKS.append(row)
        if not exact:
            fail(f"{name} along axis {axis} is not bit-exact on the 2-D "
                 f"region")
        if how != "profiler":
            fail(f"the profiler's trace holds no {match} kernel for {name} "
                 f"on the 2-D region")
        inp = ref
    return inp[..., 0]


def align_slice(img, spec, ref_spec, unknown: float):
    """A 2-D slice image moved into another slice's frame (same voxel
    size): the overlap copied, the rest unknown."""
    out = np.full((ref_spec.height, ref_spec.width), unknown, np.float32)
    vs = ref_spec.voxel_size_m
    dx = int(round((spec.origin_x_m - ref_spec.origin_x_m) / vs))
    dy = int(round((spec.origin_y_m - ref_spec.origin_y_m) / vs))
    x0, y0 = max(dx, 0), max(dy, 0)
    x1 = min(dx + spec.width, ref_spec.width)
    y1 = min(dy + spec.height, ref_spec.height)
    if x1 > x0 and y1 > y0:
        out[y0:y1, x0:x1] = img[y0 - dy:y1 - dy, x0 - dx:x1 - dx]
    return out


def same_blocks(a, b) -> bool:
    """Whether two mappers hold the same live blocks with equal rows in
    every channel, compared by block key (slot orders differ)."""
    import torch
    from isaac_ros_nvblox_tpu_torch.core import world_grid as wg

    def sorted_slots(m):
        slots = torch.nonzero(wg.live_slot_mask(m.state)).squeeze(1)
        keys = m.state.block_index_of_slot[slots].cpu().numpy()
        order = np.lexsort(keys.T[::-1])
        return slots[torch.as_tensor(order, device=slots.device)], \
            keys[order]

    sa, ka = sorted_slots(a)
    sb, kb = sorted_slots(b)
    if ka.shape != kb.shape or not (ka == kb).all():
        return False
    return a.channels.keys() == b.channels.keys() and all(
        torch.equal(a.channels[k][sa], b.channels[k][sb])
        for k in a.channels)


def publish_phase(dev, smi, camera, poses_np, depths_r, voxel, world,
                  scored):
    """The publish path: the node's default MultiMapper (static TSDF,
    EsdfMode.K2D) at its cadences over the main path's 64 frames with host
    poses: depth every frame; every 4th frame the fused tick
    (`integrate_depth_with_esdf2d`, kernels tsdf_fuse, edt_pass1,
    edt_pass), `update_esdf` and the slice publish (`slice_esdf_2d_device`
    + `occupancy_grid_from_slice`); every 8th `update_mesh` (kernel
    marching_cubes). Then the map's services: the 2-D field against scipy,
    the passes on its grid, the backlog drained, a 3-D `update_esdf` and
    `esdf_and_gradients_device` on a 2 m box, save -> load into a second
    mapper, the three PLY writers. Last the dynamic part on `scored`
    (dynamics_phase's MultiMapper and intruder frames): frames through the
    dynamic tick, `update_esdf` (both layers' 2-D fields), the two slices
    combined."""
    import tempfile
    from pathlib import Path
    import torch
    from isaac_ros_nvblox_tpu_torch import kernels
    from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
    from isaac_ros_nvblox_tpu_torch.io.ply import (
        write_mesh_ply, write_pointcloud_ply, write_voxel_layer_ply_device)
    from isaac_ros_nvblox_tpu_torch.mapper import device_io
    from isaac_ros_nvblox_tpu_torch.mapper import device_mapper as dm
    from isaac_ros_nvblox_tpu_torch.mapper.multi_mapper import MultiMapper
    from isaac_ros_nvblox_tpu_torch.mapper.params import (
        EsdfMode, EsdfSliceParams, MappingType, MultiMapperParams)
    from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
    from isaac_ros_nvblox_tpu_torch.ops.esdf_slicer import (
        combine_distance_images, occupancy_grid_from_slice)

    params = MultiMapperParams()
    if (params.mapping_type, params.esdf_mode, params.voxel_size_m,
            params.block_capacity) != (MappingType.STATIC_TSDF, EsdfMode.K2D,
                                       voxel, world.capacity):
        fail(f"the default MultiMapperParams changed: {params}")
    n_steps = depths_r.shape[0]
    n_orbit = len(poses_np)
    slice_kw = dict(max_distance_m=float(
        params.static_mapper.esdf.max_esdf_distance_m),
        unknown_value=UNKNOWN_VALUE)

    def publish_slice(m):
        spec, img = device_io.slice_esdf_2d_device(m, **slice_kw)
        return spec, img, occupancy_grid_from_slice(img, FREE_THRESHOLD_M,
                                                    UNKNOWN_VALUE)

    def run():
        mm = MultiMapper(params, world=world, device=dev)
        for k in range(n_steps):
            T = poses_np[k % n_orbit]
            if (k + 1) % PUBLISH_ESDF_EVERY == 0:
                if not mm.integrate_depth_with_esdf2d(
                        depths_r[k], T, camera, *mm.esdf_2d_band()):
                    fail("the fused 2-D tick declined a host pose")
                mm.update_esdf()      # the node's call: nothing left to do
                publish_slice(mm.static_mapper)
            else:
                mm.integrate_depth(depths_r[k], T, camera)
            if (k + 1) % PUBLISH_MESH_EVERY == 0:
                mm.update_mesh()
        return mm

    run()                                   # warm-up
    mm, launches, times = timed_run(run, n_steps)
    sm = mm.static_mapper
    want = {"tsdf_fuse": n_steps,
            "edt_pass1": n_steps // PUBLISH_ESDF_EVERY,
            "edt_pass": n_steps // PUBLISH_ESDF_EVERY,
            "marching_cubes": n_steps // PUBLISH_MESH_EVERY}
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times on the publish "
                 f"path, {n} expected")
    band_m = mm.esdf_2d_band()
    band = sm.esdf_band_vox
    frame = sm._esdf2d_frame
    sq2d = sm.esdf_2d[1]
    X, Y = sq2d.shape

    # The 2-D field against scipy on every cell of the region, the site
    # columns collapsed on the host.
    seeds = site_columns_2d(sm, band_m)
    if not seeds.any():
        fail("the 2-D region holds no site column")
    brute = sq2d_scipy(seeds, band)
    got = sq2d.cpu().numpy()
    n_diff = int((got != brute).sum())
    # The passes against their plain versions on the field's own grid,
    # seeded by the port's collapse (which must equal the host's).
    is_site, _, _ = dm._esdf_sites(*sm._esdf_layers(), voxel_size_m=voxel,
                                   esdf_params=sm.params.esdf,
                                   sites_from="tsdf")
    site = ed.collapse_2d_mask(
        is_site, dm._voxel_z_band_mask(sm.state, *band_m, voxel_size_m=voxel),
        sm.state.block_index_of_slot, sm.state.alloc_count,
        torch.as_tensor(frame[:2], dtype=torch.int32, device=dev),
        dims_b=frame[2])
    del is_site
    collapse_equal = bool((site.cpu().numpy() == seeds).all())
    chain = edt2d_check(site, band)
    chain_equal = bool(torch.equal(torch.where(
        chain <= float(band * band), chain, float(ed.INF)), sq2d))

    # Device time of one 2-D solve and of one fused tick (frame 0 again,
    # after every check of the run's map).
    def solve():
        sm.update_esdf_2d(*band_m, full=True)

    solve_dev = plain_device_ms(solve, 5)
    solve_ms = cuda_ms(solve, 5)
    solve_top = top_kernels(trace(solve, 5)[0], 5, 8)

    # The slice publish: wall per call (ending in its host copy) and the
    # bytes it copies.
    spec, img, grid = publish_slice(sm)
    slice_ms = cuda_ms(lambda: publish_slice(sm))
    slice_known = float((img != UNKNOWN_VALUE).mean())
    occ_counts = {str(v): int((grid == v).sum()) for v in (-1, 0, 100)}

    # The mesh backlog drained by further publishes, then one publish of
    # every live block (the first publish of a loaded map), timed.
    drains = 0
    while bool(sm.mesh_pending.any() or sm.dirty.any()) and drains < 16:
        mm.update_mesh()
        drains += 1
    pending = int(sm.mesh_pending.sum())
    v, c, tri = sm.mesh_layer.as_arrays()
    n_tris, n_mesh_blocks = int(tri.shape[0]), len(sm.mesh_layer.blocks)
    mesh_ms, mesh_bytes = [], []

    def mesh_all():
        sm.dirty.copy_(wg.live_slot_mask(sm.state))
        mm.update_mesh()

    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_all()
        mesh_ms.append((time.perf_counter() - t0) * 1e3)
        mesh_bytes.append(sm.last_mesh_host_bytes)
    mesh_top = top_kernels(trace(mesh_all, 1)[0], 1, 6)
    overflow = int(sm.state.overflow_count)

    # The services: a 3-D ESDF, the dense grid and its gradients on a 2 m
    # box, save -> load, PLY.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm.update_esdf()
    torch.cuda.synchronize()
    esdf3d_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dense, grads, d_origin = device_io.esdf_and_gradients_device(
        sm, (-1.0, -1.0, 0.2), (1.0, 1.0, 2.2))
    dense_ms = (time.perf_counter() - t0) * 1e3
    dense_ok = (dense.shape == (40, 40, 40) and grads.shape == (40, 40, 40, 3)
                and bool(np.isfinite(dense).all())
                and bool(np.isfinite(grads).all()))
    dense_known = float((dense != UNKNOWN_VALUE).mean())
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        device_io.save_map_device(sm, tmp / "map.nvblx")
        save_ms = (time.perf_counter() - t0) * 1e3
        map_mib = (tmp / "map.nvblx").stat().st_size / 2 ** 20
        second = MultiMapper(params, world=world, device=dev).static_mapper
        t0 = time.perf_counter()
        n_loaded = device_io.load_map_device(second, tmp / "map.nvblx")
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        round_trip = same_blocks(sm, second) and n_loaded == sm.block_count()
        del second
        ply = {}
        t0 = time.perf_counter()
        write_mesh_ply(tmp / "mesh.ply", v, tri, c)
        ply["mesh_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        write_pointcloud_ply(tmp / "vertices.ply", v)
        ply["pointcloud_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ply["tsdf_points"] = write_voxel_layer_ply_device(tmp / "tsdf.ply",
                                                          sm, "tsdf")
        ply["esdf_points"] = write_voxel_layer_ply_device(tmp / "esdf.ply",
                                                          sm, "esdf")
        ply["voxel_layers_ms"] = (time.perf_counter() - t0) * 1e3
        ply["mib"] = {f.name: f.stat().st_size / 2 ** 20
                      for f in sorted(tmp.glob("*.ply"))}
    ply_ok = (ply["tsdf_points"] > 0 and ply["esdf_points"] > 0
              and all(s > 0 for s in ply["mib"].values()))

    # The fused tick's device time, last: it integrates frame 0 once more.
    tick = lambda: mm.integrate_depth_with_esdf2d(  # noqa: E731
        depths_r[0], poses_np[0], camera, *band_m)
    tick_ms = cuda_ms(tick, 5)
    tick_dev = plain_device_ms(tick, 5)

    emit({"phase": "publish_frames", "frames": n_steps,
          "config": "MultiMapperParams() (static_tsdf, esdf_mode 2d, "
                    "0.05 m, 16384 slots); bench world and room",
          "esdf_2d_every": PUBLISH_ESDF_EVERY,
          "mesh_every": PUBLISH_MESH_EVERY, "band_m": list(band_m),
          "band_vox": band, **times, "launches": launches,
          "region_2d_origin_blocks": list(frame[:2]),
          "region_2d_dims_blocks": list(frame[2]), "region_2d_cells": [X, Y],
          "site_columns": int(seeds.sum()),
          "cells_differing_from_scipy": n_diff,
          "collapse_equals_host": collapse_equal,
          "plain_chain_equals_field": chain_equal,
          "solve_2d_device_ms": solve_dev, "solve_2d_ms": solve_ms,
          "solve_2d_top": solve_top,
          "fused_tick_device_ms": tick_dev, "fused_tick_ms": tick_ms,
          "slice_publish_ms": slice_ms, "slice_bytes_to_host": img.nbytes,
          "slice_shape": [spec.height, spec.width],
          "slice_known_share": slice_known, "occupancy_grid": occ_counts,
          "mesh_drain_publishes": drains, "mesh_pending": pending,
          "mesh_blocks": n_mesh_blocks, "mesh_triangles": n_tris,
          "update_mesh_all_blocks_ms": mesh_ms,
          "update_mesh_bytes_to_host": mesh_bytes,
          "update_mesh_all_blocks_top": mesh_top,
          "esdf3d_update_ms": esdf3d_ms, "esdf_and_gradients_ms": dense_ms,
          "dense_grid_known_share": dense_known, "save_ms": save_ms,
          "load_ms": load_ms, "map_mib": map_mib, "blocks_loaded": n_loaded,
          "round_trip_exact": round_trip, "ply": ply,
          "allocated_blocks": sm.block_count(), "overflow_count": overflow,
          "nvidia_smi": smi})
    if n_diff:
        fail(f"the 2-D field differs from scipy's EDT on {n_diff} cells")
    if not (collapse_equal and chain_equal):
        fail("the 2-D collapse or the plain chain disagrees with the field")
    if overflow != 0:
        fail(f"publish overflow_count {overflow} != 0")
    if pending != 0 or n_tris <= 1000:
        fail(f"mesh layer: {n_tris} triangles, mesh_pending {pending}")
    if not (dense_ok and dense_known > 0.05):
        fail("esdf_and_gradients_device gave a wrong or empty grid")
    if not round_trip:
        fail("the save -> load round trip changed the map")
    if not ply_ok:
        fail(f"a PLY writer wrote nothing: {ply}")
    if not slice_known > 0.05:
        fail(f"the 2-D slice is mostly unknown ({slice_known})")
    del mm, sm
    torch.cuda.empty_cache()

    # ---- the dynamic part: the scored intruder scene in K2D --------------
    sc, intr = scored
    s2, d2 = sc.static_mapper, sc.dynamic_mapper
    if sc.params.esdf_mode != EsdfMode.K2D:
        fail("the dynamic MultiMapper is not in EsdfMode.K2D")
    sc.params.static_mapper.esdf_slice = EsdfSliceParams(
        esdf_slice_min_height=DYN_BAND_M[0],
        esdf_slice_max_height=DYN_BAND_M[1])
    # Known region: the freespace step takes its full-pool form.
    s2._refresh_region_from_device()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for k, (d_intr, _, T) in enumerate(intr[:4]):
        sc.integrate_depth(d_intr, T, camera, time_ms=300.0 * (72 + k))
    sc.update_esdf()
    torch.cuda.synchronize()
    dyn_ms = (time.perf_counter() - t0) * 1e3
    dyn_launches = dict(kernels.LAUNCHES)
    PATH_LAUNCHES["publish"] = {k: launches[k] + dyn_launches[k]
                                for k in launches}
    s_spec, s_img = device_io.slice_esdf_2d_device(s2, **slice_kw)
    d_spec, d_img = device_io.slice_esdf_2d_device(d2, **slice_kw)
    combined = combine_distance_images(
        [s_img, align_slice(d_img, d_spec, s_spec, UNKNOWN_VALUE)],
        UNKNOWN_VALUE)
    dgrid = occupancy_grid_from_slice(combined, FREE_THRESHOLD_M,
                                      UNKNOWN_VALUE)
    d_known = int((d_img != UNKNOWN_VALUE).sum())
    d_occupied = int((d2.esdf_2d[1] == 0).sum())
    emit({"phase": "publish_frames", "part": "dynamic",
          "frames": 4, "band_m": list(DYN_BAND_M), "ms": dyn_ms,
          "launches": dyn_launches,
          "static_slice": [s_spec.height, s_spec.width],
          "dynamic_slice": [d_spec.height, d_spec.width],
          "dynamic_known_cells": d_known,
          "dynamic_site_cells": d_occupied,
          "combined_known_share": float((combined != UNKNOWN_VALUE).mean()),
          "combined_occupancy_grid": {str(v): int((dgrid == v).sum())
                                      for v in (-1, 0, 100)},
          "nvidia_smi": smi})
    for name in ("detect_dynamic", "tsdf_fuse", "occupancy_fuse",
                 "dilate_dense", "edt_pass1", "edt_pass"):
        if dyn_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the dynamic publish "
                 f"part")
    if not (d_known > 0 and bool(np.isfinite(d_img).all())
            and bool(np.isfinite(combined).all())):
        fail("the dynamic 2-D slice is unknown everywhere or not finite")
    del sc, s2, d2
    torch.cuda.empty_cache()


NODE_TICK_MS = 10          # NodeParams.tick_period_ms
NODE_TICKS = 161           # 0 to 1.6 s of simulated time
NODE_FRAME_MS = 25         # the replayed orbit's depth and color at 40 Hz
NODE_SCAN_MS = 100         # the lidar at 10 Hz
# The Transformer snaps a lookup to a queued pose within 50 ms; on this
# orbit (a turn every 0.4 s) a 25 ms frame would take a pose 5 ms away,
# 4.5 degrees off. 1 ms makes every stamp between two 100 Hz poses
# interpolate.
NODE_POSE_TOLERANCE_S = 0.001
NODE_TOPICS = ("~/mesh", "~/mesh_serialized", "~/static_map_slice",
               "~/map_slice_occupancy_grid", "~/tsdf_layer",
               "~/back_projected_depth")
# The node's map, from the reference's own CPU run of the same inputs (its
# node over the same frames, scans, poses and clock, its XLA integrators,
# which the port mirrors; `tests/test_torch_accuracy.py --node`): TSDF
# error 0.034859 m over 2887 blocks, 11 167 known cells in the last 2-D
# slice (384 x 384). The port's CPU run of the same inputs gives
# 0.034859 m and 2887 blocks. The limits leave room for the card's own
# render of the frames and scans, no more: the error within 3%, the block
# and known-cell counts within 1%.
NODE_REF = {"tsdf_mae_m": 0.034859, "allocated_blocks": 2887,
            "last_slice_known_cells": 11167}
NODE_TSDF_MAE_LIMIT_M = 0.036
NODE_COUNT_TOL = 0.01


def node_lidar_pose(t_s: float) -> np.ndarray:
    """The lidar's pose at t_s: level, heading +x, at 2.2 m, moving along
    x at 0.5 m/s from (-0.4, -1.5)."""
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (-0.4 + 0.5 * t_s, -1.5, 2.2)
    return T


def node_scan(scene, lidar, stamp_s: float, device):
    """One 1800 x 16 scan starting at stamp_s while the sensor moves
    (`node_lidar_pose`): each column traced from the sensor's position at
    its own time, points in the sensor frame (the rotation is fixed), and
    the per-point times relative to the scan start (column c at
    c * 100 ms / 1800)."""
    import torch
    dirs = torch.as_tensor(lidar_rays(lidar), device=device)
    A = lidar.num_azimuth_divisions
    rel = np.tile(np.arange(A) * (NODE_SCAN_MS / 1e3 / A),
                  lidar.num_elevation_divisions)
    origins = torch.as_tensor(np.stack([node_lidar_pose(stamp_s + r)[:3, 3]
                                        for r in rel[:A]]), device=device)
    origins = origins.repeat(lidar.num_elevation_divisions, 1)
    t = torch.full((dirs.shape[0],), 1e-3, device=device)
    for _ in range(96):
        d = scene.sdf(dirs * t[:, None] + origins)
        t = torch.clamp_max(t + torch.where(d > 1e-4, d, torch.zeros_like(d)),
                            2.0 * lidar.max_valid_range_m)
    hit = ((scene.sdf(dirs * t[:, None] + origins) < 1e-3)
           & (t < lidar.max_valid_range_m))
    pts = torch.where(hit[:, None], dirs * t[:, None], torch.zeros_like(dirs))
    return pts.cpu().numpy(), rel


def gate_admits(arrivals_ms, rate_hz: float) -> int:
    """How many of the frames arriving at these tick times (ms) a node
    rate gate of rate_hz lets through (RateGate.should_process)."""
    last, n = None, 0
    for ms in arrivals_ms:
        if last is None or ms - last >= 1000.0 / rate_hz - 1e-6:
            last, n = ms, n + 1
    return n


def node_phase(dev, smi, camera, scene, voxel, world, depths, intr):
    """The online node (`NvbloxNode` with the node's and the mapper's
    defaults) ticking every 10 ms for 1.6 s of simulated time: the main
    path's 16-frame orbit replayed as 64 depth and 64 color frames 25 ms
    apart, host images as a camera delivers them; camera and lidar poses
    at 100 Hz; an 1800 x 16 scan every 100 ms with per-point times, so
    motion compensation runs. Subscribers: the mesh (with the mesh layer
    adapter), the 2-D slice, its occupancy grid, the TSDF layer, the
    back-projected depth and a costmap layer. Then the services, and a
    short dynamic-mode node on the scored intruder frames. Launch counts
    `node`."""
    import tempfile
    from pathlib import Path
    import torch
    from isaac_ros_nvblox_tpu_torch import kernels
    from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks
    from isaac_ros_nvblox_tpu_torch.mapper.params import (MultiMapperParams,
                                                          make_params)
    from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
    from isaac_ros_nvblox_tpu_torch.models.scene import (orbit_pose,
                                                         render_color)
    from isaac_ros_nvblox_tpu_torch.runtime.adapters import MeshLayerAdapter
    from isaac_ros_nvblox_tpu_torch.runtime.costmap import (
        NvbloxCostmapLayer)
    from isaac_ros_nvblox_tpu_torch.runtime.node import (NodeParams,
                                                         NvbloxNode)
    from isaac_ros_nvblox_tpu_torch.utils.timing import Rates, Timing

    n_orbit = depths.shape[0]
    depth_np = [d.cpu().numpy() for d in depths]
    color_np = [render_color(scene, camera, orbit_pose(
        2 * np.pi * k / n_orbit, radius=1.5), device=dev).cpu().numpy()
        for k in range(n_orbit)]
    n_frames = 4 * n_orbit
    p = NodeParams()
    lidar = Lidar.equal_vertical_fov(p.lidar_width, p.lidar_height,
                                     p.lidar_vertical_fov_rad,
                                     min_range_m=p.lidar_min_valid_range_m)
    n_scans = (NODE_TICKS - 1) * NODE_TICK_MS // NODE_SCAN_MS
    scans = [node_scan(scene, lidar, m * NODE_SCAN_MS / 1e3, dev)
             for m in range(n_scans)]

    def make_node(params=None, mapper_params=None):
        node = NvbloxNode(params or NodeParams(),
                          mapper_params or MultiMapperParams(), world=world,
                          device=dev)
        node.transformer.timestamp_tolerance_s = NODE_POSE_TOLERANCE_S
        clock = [0.0]
        node.clock = lambda: clock[0]
        return node, clock

    def run():
        node, clock = make_node()
        counts = {t: 0 for t in NODE_TOPICS}
        host_bytes = {}

        def counter(topic, kind=None):
            def cb(msg):
                counts[topic] += 1
                if kind:
                    host_bytes.setdefault(kind, []).append(
                        node.last_host_bytes[kind])
            return cb

        MeshLayerAdapter(node.bus)
        costmap = NvbloxCostmapLayer(node.bus)
        slices = []
        node.bus.subscribe("~/static_map_slice", slices.append)
        for topic, kind in zip(NODE_TOPICS, ("mesh", None, "slice", None,
                                             "layers",
                                             "back_projected_depth")):
            node.bus.subscribe(topic, counter(topic, kind))
        Timing.reset()
        Rates.reset()
        tick_ms = []
        next_frame = 0
        for i in range(NODE_TICKS):
            ms = i * NODE_TICK_MS
            now = ms / 1e3
            node.add_pose("cam", now, orbit_pose(
                2 * np.pi * (ms / NODE_FRAME_MS) / n_orbit, radius=1.5))
            node.add_pose("lidar", now, node_lidar_pose(now))
            node.add_pose("base_link", now, node_lidar_pose(now))
            while next_frame < n_frames \
                    and next_frame * NODE_FRAME_MS <= ms:
                k = next_frame
                stamp = k * NODE_FRAME_MS / 1e3
                node.add_depth_image(depth_np[k % n_orbit], camera, "cam",
                                     stamp)
                node.add_color_image(color_np[k % n_orbit], camera, "cam",
                                     stamp)
                next_frame += 1
            if ms >= NODE_SCAN_MS and ms % NODE_SCAN_MS == 0:
                m = ms // NODE_SCAN_MS - 1
                node.add_pointcloud(scans[m][0], "lidar",
                                    m * NODE_SCAN_MS / 1e3,
                                    timestamps_s=scans[m][1])
            clock[0] = now
            t0 = time.perf_counter()
            node.tick()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
        return node, {"counts": counts, "host_bytes": host_bytes,
                      "tick_ms": tick_ms, "costmap": costmap.has_data,
                      "timing": Timing.to_string(),
                      "last_slice_known_cells": int(
                          (slices[-1].data != slices[-1].unknown_value).sum()),
                      "integrated": Timing.get("node/depth/integrate").count,
                      "colors": Timing.get("node/color/integrate").count,
                      "scans": Timing.get("node/lidar/integrate").count}

    run()                                   # warm-up
    (node, st), launches, times = timed_run(run, NODE_TICKS)
    mm = node.multi_mapper
    sm = mm.static_mapper
    sim_s = (NODE_TICKS - 1) * NODE_TICK_MS / 1e3
    arrivals = [-(-k * NODE_FRAME_MS // NODE_TICK_MS) * NODE_TICK_MS
                for k in range(n_frames)]
    admitted = gate_admits(arrivals, node.params.integrate_depth_rate_hz)
    overflow = int(sm.state.overflow_count)
    drops = {q.name: q.dropped_count for q in (
        node.depth_queue, node.color_queue, node.pointcloud_queue)}

    # The map against the analytic scene (the benchmark's definition).
    n_alloc = int(sm.state.alloc_count)
    gt = scene.sdf(voxel_centers_for_blocks(
        sm.state.block_index_of_slot[:n_alloc], voxel))
    w = sm.channels["tsdf_weight"][:n_alloc]
    near = (gt.abs() < 0.1) & (w > 0.5)
    tsdf_mae = float((sm.channels["tsdf_distance"][:n_alloc]
                      - gt).abs()[near].mean())

    # The final 2-D field (solved on the last tick, after its scan)
    # against scipy on every cell.
    band_m = mm.esdf_2d_band()
    seeds = site_columns_2d(sm, band_m)
    brute = sq2d_scipy(seeds, sm.esdf_band_vox)
    n_diff = int((sm.esdf_2d[1].cpu().numpy() != brute).sum())
    stale = sm._dirty2d_lo is not None

    # The services, each through the node's service queue.
    svc = {}
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        node.save_map(tmp / "map.nvblx")
        svc["save_map_ms"] = (time.perf_counter() - t0) * 1e3
        second, _ = make_node()
        t0 = time.perf_counter()
        second.load_map(tmp / "map.nvblx")
        torch.cuda.synchronize()
        svc["load_map_ms"] = (time.perf_counter() - t0) * 1e3
        s2 = second.multi_mapper.static_mapper
        round_trip = (same_blocks(sm, s2)
                      and s2.block_count() == sm.block_count())
        del second, s2
        t0 = time.perf_counter()
        resp = node.get_esdf_and_gradients((-1.0, -1.0, 0.2),
                                           (1.0, 1.0, 2.2))
        svc["esdf_and_gradients_ms"] = (time.perf_counter() - t0) * 1e3
        esdf_ok = (resp.success and resp.esdf.shape == (40, 40, 40)
                   and resp.gradients.shape == (40, 40, 40, 3)
                   and bool(np.isfinite(resp.esdf).all())
                   and float((resp.esdf != node.params
                              .esdf_and_gradients_unobserved_value).mean())
                   > 0.05)
        # After the 3-D solve of the service above, so that esdf.ply holds
        # the field.
        t0 = time.perf_counter()
        node.save_ply(tmp / "ply")
        svc["save_ply_ms"] = (time.perf_counter() - t0) * 1e3
        ply = {f.name: f.stat().st_size for f in
               sorted((tmp / "ply").glob("*.ply"))}
        t0 = time.perf_counter()
        node.shutdown(tmp / "shutdown")
        svc["shutdown_ms"] = (time.perf_counter() - t0) * 1e3
        shut = sorted(f.name for f in (tmp / "shutdown").iterdir())
    ticks = np.asarray(st["tick_ms"])
    row = {"phase": "node_ticks", "ticks": NODE_TICKS,
           "simulated_s": sim_s,
           "config": "NvbloxNode(NodeParams(), MultiMapperParams()): static "
                     "tsdf, esdf 2d, 0.05 m, 16384 slots, the node's rates; "
                     "bench world and room; 640x480 depth + color at 40 Hz, "
                     "1800x16 lidar at 10 Hz, poses at 100 Hz",
           "pose_tolerance_s": NODE_POSE_TOLERANCE_S,
           "tick_wall_ms": {"mean": float(ticks.mean()),
                            "p50": float(np.percentile(ticks, 50)),
                            "p99": float(np.percentile(ticks, 99)),
                            "max": float(ticks.max())},
           **times,
           "device_ms_per_simulated_s":
               times["device_ms_per_step"] * NODE_TICKS / sim_s,
           "host_bytes_per_publish": {
               k: {"mean": float(np.mean(v)), "max": int(np.max(v)),
                   "publishes": len(v)}
               for k, v in st["host_bytes"].items()},
           "messages": st["counts"], "queue_drops": drops,
           "depth_frames_admitted": admitted,
           "depth_frames_integrated": st["integrated"],
           "color_frames_integrated": st["colors"],
           "scans_integrated": st["scans"], "launches": launches,
           "allocated_blocks": sm.block_count(), "overflow_count": overflow,
           "tsdf_mae_m": tsdf_mae,
           "last_slice_known_cells": st["last_slice_known_cells"],
           "reference": NODE_REF,
           "limits": {"tsdf_mae_m": NODE_TSDF_MAE_LIMIT_M,
                      "count_tolerance": NODE_COUNT_TOL},
           "site_columns": int(seeds.sum()),
           "cells_differing_from_scipy": n_diff, "field_stale": stale,
           "services": svc, "round_trip_exact": round_trip, "ply_bytes": ply,
           "shutdown_files": shut, "nvidia_smi": smi}
    emit(row)
    print(st["timing"], flush=True)
    if st["integrated"] != admitted or launches["tsdf_fuse"] != admitted:
        fail(f"{admitted} depth frames admitted, {st['integrated']} "
             f"integrated, {launches['tsdf_fuse']} tsdf_fuse launches")
    if overflow != 0:
        fail(f"node overflow_count {overflow} != 0")
    if min(st["counts"].values()) == 0 or not st["costmap"]:
        fail(f"a subscribed topic was never published: {st['counts']}")
    for name in ("tsdf_fuse", "edt_pass1", "edt_pass", "color_fuse",
                 "marching_cubes", "tsdf_lidar_fuse"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the node path")
    if st["scans"] != n_scans:
        fail(f"{st['scans']} of {n_scans} scans integrated")
    if n_diff or stale or not seeds.any():
        fail(f"the node's 2-D field differs from scipy's EDT on {n_diff} "
             f"cells (stale {stale})")
    if not tsdf_mae <= NODE_TSDF_MAE_LIMIT_M:
        fail(f"node tsdf_mae_m {tsdf_mae} > {NODE_TSDF_MAE_LIMIT_M}")
    for key, got in (("allocated_blocks", sm.block_count()),
                     ("last_slice_known_cells",
                      st["last_slice_known_cells"])):
        if abs(got - NODE_REF[key]) > NODE_COUNT_TOL * NODE_REF[key]:
            fail(f"node {key} {got}, the reference's {NODE_REF[key]}")
    if not round_trip:
        fail("the node's save_map -> load_map round trip changed the map")
    if len(ply) != 3 or min(ply.values()) <= 1000:
        fail(f"save_ply wrote {ply}")
    if not esdf_ok:
        fail("get_esdf_and_gradients gave a wrong or empty grid")
    if shut != ["map.png", "map.yaml"]:
        fail(f"shutdown wrote {shut}")
    del node, mm, sm
    torch.cuda.empty_cache()

    # ---- the dynamic mode: 8 intruder frames through the node ------------
    # The node combines the two 2-D slices only where the frames agree;
    # the dynamic mapper's default 4 m integration distance gives it a
    # smaller frame than the static mapper's 7 m, so it takes the static
    # distance here.
    dyn_params = make_params(mode="dynamic", overlay={
        "dynamic_mapper.projective.max_integration_distance_m": float(
            MultiMapperParams().static_mapper.projective
            .max_integration_distance_m)})
    dnode, dclock = make_node(mapper_params=dyn_params)
    dcounts = {"~/static_map_slice": 0, "~/combined_map_slice": 0}
    for topic in dcounts:
        dnode.bus.subscribe(topic, lambda msg, topic=topic:
                            dcounts.__setitem__(topic, dcounts[topic] + 1))
    frames = [(d.cpu().numpy(), T) for d, _, T in intr]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for k, (d_np, T) in enumerate(frames):
        stamp = k * NODE_FRAME_MS / 1e3
        dnode.add_pose("cam", stamp, T)
        dnode.add_depth_image(d_np, camera, "cam", stamp)
        dclock[0] = stamp
        dnode.tick()
    torch.cuda.synchronize()
    dyn_ms = (time.perf_counter() - t0) * 1e3
    dyn_launches = dict(kernels.LAUNCHES)
    PATH_LAUNCHES["node"] = {k: launches[k] + dyn_launches[k]
                             for k in launches}
    dyn = dnode.multi_mapper.dynamic_mapper
    emit({"phase": "node_ticks", "part": "dynamic", "frames": len(frames),
          "ms": dyn_ms, "launches": dyn_launches, "messages": dcounts,
          "static_frame_2d": list(dnode.multi_mapper.static_mapper
                                  ._esdf2d_frame[:3]),
          "dynamic_frame_2d": list(dyn._esdf2d_frame[:3]),
          "dynamic_blocks": dyn.block_count(),
          "overflow_count": int(dnode.multi_mapper.static_mapper.state
                                .overflow_count), "nvidia_smi": smi})
    for name in ("detect_dynamic", "occupancy_fuse", "dilate_dense"):
        if dyn_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the dynamic node")
    if dcounts["~/combined_map_slice"] == 0:
        fail(f"the dynamic node published no combined slice: {dcounts}")
    del dnode, dyn
    torch.cuda.empty_cache()


# ---- the offline fuser ---------------------------------------------------
# Replica's default camera (datasets/replica.py, the vMAP export nvblox's
# replica loader reads) and the frames of the timed fuser run.
REPLICA_CAMERA = dict(fx=600.0, fy=600.0, cx=599.5, cy=339.5, width=1200,
                      height=680)
FUSER_FRAMES = 64
FUSER_CPU_FRAMES = 4
REPLICA_FILES = 16
# The reference's figures for (a) (its XLA TSDF path and numpy EDT on the
# CPU: `tests/test_torch_accuracy.py --fuser`). The map's ESDF is held to
# them; `esdf_split` (map_errors) shows where its error lies.
FUSER_REF = {"allocated_blocks": 3079, "tsdf_mae_m": 0.021876488,
             "esdf_mae_m": 0.105891190}


def mesh_surface_errors(mesh_layer, scene):
    """(mean, p90) |SDF| of the mesh vertices against the analytic scene
    (tests/test_dataset_replay.py:51-86)."""
    import torch
    v, _, _ = mesh_layer.as_arrays()
    sdf = np.abs(scene.sdf(torch.from_numpy(v)).numpy())
    return float(sdf.mean()), float(np.percentile(sdf, 90))


def map_errors(m, scene, voxel, rows=None):
    """`tsdf_mae_m` and `esdf_mae_m` (PERF.md §2) of a DeviceMapper, or of
    a host-table Mapper's `rows` (its allocated slots), and the ESDF error
    split: its median and p90, its mean over the scored voxels a ray
    passed (TSDF weight > 0) and over the others, and the mean parts where
    the map's distance is too long (a nearer surface never seen) and too
    short."""
    import torch
    from isaac_ros_nvblox_tpu_torch.core.types import voxel_centers_for_blocks
    from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
    if rows is None:
        n = m.block_count()
        bidx = m.state.block_index_of_slot[:n]
        ch = {k: v[:n] for k, v in m.channels.items()}
    else:
        bidx = torch.as_tensor(m.table.block_indices[rows], device=m.device)
        s = torch.as_tensor(rows.astype(np.int64), device=m.device)
        ch = {k: v[s] for k, v in m.pool.channels.items()}
    gt = scene.sdf(voxel_centers_for_blocks(bidx, voxel))
    near = (gt.abs() < 0.1) & (ch["tsdf_weight"] > 0.5)
    tsdf_mae = float((ch["tsdf_distance"] - gt).abs()[near].mean())
    sq = ch["esdf_sq_dist"]
    est = torch.clamp_max(torch.sqrt(torch.clamp_max(sq, esdf_ops.INF_SQ))
                          * voxel, 2.0)
    est = torch.where(ch["esdf_is_inside"], -est, est)
    emask = (gt > 3 * voxel) & (gt < 1.0) & (sq < 1e11)
    err = (est - gt)[emask]
    seen = (ch["tsdf_weight"] > 0)[emask]
    q = torch.quantile(err.abs().double(), torch.tensor(
        [0.5, 0.9], dtype=torch.float64, device=err.device))
    split = {"median_m": float(q[0]), "p90_m": float(q[1]),
             "voxels": int(err.numel()),
             "observed_mae_m": float(err[seen].abs().mean()),
             "observed_voxels": int(seen.sum()),
             "unobserved_mae_m": float(err[~seen].abs().mean()),
             "too_long_m": float(err.clamp_min(0).mean()),
             "too_short_m": float((-err).clamp_min(0).mean())}
    return tsdf_mae, float(err.abs().mean()), split


def _tsdf_by_block(m):
    """A DeviceMapper's TSDF distance and weight rows by block index."""
    n = m.block_count()
    keys = [tuple(k) for k in m.state.block_index_of_slot[:n].tolist()]
    rows = np.concatenate([m.channels[k][:n].cpu().numpy()
                           for k in ("tsdf_distance", "tsdf_weight")], 1)
    return dict(zip(keys, rows))


def fuser_phase(dev, smi, scene, voxel):
    """The offline fuser at Replica's width (launch counts `fuser`):
    (a) 64 frames of Replica's default camera orbiting the bench's room,
    rendered by `SyntheticDataLoader`, through `Fuser(FuserConfig())` on
    the card (the reference's defaults: 0.05 m voxels, 16384 slots, color
    every frame, ESDF and mesh every 4th and at the end), timed, traced and
    scored; (b) its first 4 frames fused on the CPU (plain versions) and on
    the card, equal; (c) 16 frames of the orbit written as a Replica
    sequence, read back exactly and fused; (d) the host-table backend on
    those files; (e) the example pipeline for 4 frames."""
    import tempfile
    from pathlib import Path
    import torch
    from isaac_ros_nvblox_tpu_torch import kernels
    from isaac_ros_nvblox_tpu_torch.datasets.base import Frame
    from isaac_ros_nvblox_tpu_torch.datasets.fuser import Fuser, FuserConfig
    from isaac_ros_nvblox_tpu_torch.datasets.replica import ReplicaDataLoader
    from isaac_ros_nvblox_tpu_torch.datasets.replica_writer import (
        DEPTH_SCALE, quantize_depth, write_replica_sequence)
    from isaac_ros_nvblox_tpu_torch.datasets.synthetic import (
        SyntheticDataLoader)
    from isaac_ros_nvblox_tpu_torch.examples import run_pipeline
    from isaac_ros_nvblox_tpu_torch.io import image_codec
    from isaac_ros_nvblox_tpu_torch.models.camera import Camera
    from isaac_ros_nvblox_tpu_torch.models.scene import (orbit_pose,
                                                         render_depth)
    from isaac_ros_nvblox_tpu_torch.utils.timing import Timing

    camera = Camera(**REPLICA_CAMERA)
    codec = image_codec.jpeg_codec()
    emit({"phase": "fuser", "part": "codec", "jpeg_codec": codec})

    # (a) the timed, scored run.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = list(SyntheticDataLoader(num_frames=FUSER_FRAMES, scene=scene,
                                      camera=camera, device=dev))
    load_ms = (time.perf_counter() - t0) * 1e3 / FUSER_FRAMES
    if len(frames) != FUSER_FRAMES or frames[0].depth.shape != (
            camera.height, camera.width):
        fail(f"SyntheticDataLoader did not give {FUSER_FRAMES} frames of "
             f"{camera.width}x{camera.height}")
    Timing.reset()

    def run():
        f = Fuser(frames, FuserConfig(), device=dev)
        f.run()
        return f

    # Two runs (the second traced): the span means cover both.
    fuser, launches, figures = timed_run(run, FUSER_FRAMES)
    PATH_LAUNCHES["fuser"] = launches
    spans = {k: Timing.get(k) for k in ("fuser/depth", "fuser/color",
                                        "fuser/esdf", "fuser/mesh")}
    m = fuser.mapper
    n_updates = -(-FUSER_FRAMES // 4) + 1
    want = {"tsdf_fuse": FUSER_FRAMES, "color_fuse": FUSER_FRAMES,
            "edt_pass1": n_updates, "edt_pass": 2 * n_updates,
            "marching_cubes": n_updates}
    n_blocks = m.block_count()
    v, c, tri = m.mesh_layer.as_arrays()
    tsdf_mae, esdf_mae, esdf_split = map_errors(m, scene, voxel)
    surf_mae, surf_p90 = mesh_surface_errors(m.mesh_layer, scene)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        fuser.output_mesh_ply(Path(tmp) / "mesh.ply")
        ply_bytes = (Path(tmp) / "mesh.ply").stat().st_size
    dtoh = [r for r in figures["top_per_step"] if "DtoH" in r["name"]]
    row = {"phase": "fuser", "part": "timed", "frames": FUSER_FRAMES,
           "camera": REPLICA_CAMERA, "loader_ms_per_frame": load_ms,
           **figures,
           "dtoh_ms_per_frame": sum(r["ms_per_frame"] for r in dtoh),
           "spans_ms": {k: {"count": st.count, "mean_ms": st.mean * 1e3,
                                 "max_ms": st.max * 1e3}
                        for k, st in spans.items()},
           "launches": launches, "want_launches": want,
           "allocated_blocks": n_blocks,
           "overflow_count": int(m.state.overflow_count),
           "mesh_vertices": int(v.shape[0]), "mesh_triangles": int(tri.shape[0]),
           "tsdf_mae_m": tsdf_mae, "esdf_mae_m": esdf_mae,
           "esdf_split": esdf_split,
           "mesh_surface_mae_m": surf_mae, "mesh_surface_p90_m": surf_p90,
           "output_mesh_ply_bytes": ply_bytes,
           "limits": {"tsdf_mae_m": TSDF_MAE_LIMIT_M,
                      "esdf_mae_m": "reference within 1%",
                      "esdf_median_m": voxel,
                      "mesh_surface_mae_m": voxel,
                      "mesh_surface_p90_m": 2 * voxel},
           "reference": FUSER_REF, "nvidia_smi": smi}
    emit(row)
    for name, n in want.items():
        if launches[name] != n:
            fail(f"fuser launched {name} {launches[name]} times, not {n}")
    others = {k: n for k, n in launches.items() if k not in want and n}
    if others:
        fail(f"fuser launched kernels off its path: {others}")
    if row["overflow_count"] or n_blocks < 1000 or tri.shape[0] < 10000:
        fail(f"fuser map too small or overflowed: {n_blocks} blocks, "
             f"{tri.shape[0]} triangles")
    if not (np.isfinite([tsdf_mae, esdf_mae, surf_mae]).all()
            and tsdf_mae <= TSDF_MAE_LIMIT_M
            and esdf_split["median_m"] < voxel
            and surf_mae < voxel and surf_p90 < 2 * voxel):
        fail(f"fuser map outside its limits: {row}")
    # The map against the reference's CPU run: the same blocks, the scores
    # within 1%.
    if n_blocks != FUSER_REF["allocated_blocks"] or any(
            abs(x - FUSER_REF[k]) > 0.01 * FUSER_REF[k]
            for k, x in (("tsdf_mae_m", tsdf_mae), ("esdf_mae_m", esdf_mae))):
        fail(f"fuser map differs from the reference's CPU run: {row}")
    if ply_bytes < 1000 or c.max() <= 10:
        fail("fuser wrote no colored mesh")
    del fuser, m
    torch.cuda.empty_cache()

    # (b) the card against the port's CPU run (plain versions).
    head = frames[:FUSER_CPU_FRAMES]
    maps, secs = [], []
    for d in ("cpu", dev):
        t0 = time.perf_counter()
        f = Fuser(head, FuserConfig(), device=d)
        f.run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        maps.append(f.mapper)
    a, b = (mm.state_arrays() for mm in maps)
    differ = sorted(k for k in a if not np.array_equal(a[k], b[k]))
    # The mesh layers block for block: the same keys, and equal vertices,
    # colors and triangles in each.
    la, lb = (mm.mesh_layer.blocks for mm in maps)
    mesh_differ = sorted(
        str(k) for k in la.keys() | lb.keys()
        if k not in la or k not in lb or not all(
            np.array_equal(getattr(la[k], f), getattr(lb[k], f))
            for f in ("vertices", "colors", "triangles")))
    tri_counts = [mm.mesh_layer.as_arrays()[2].shape[0] for mm in maps]
    row = {"phase": "fuser", "part": "card_vs_cpu",
           "frames": FUSER_CPU_FRAMES, "blocks": [mm.block_count()
                                                  for mm in maps],
           "mesh_blocks": [len(la), len(lb)], "triangles": tri_counts,
           "arrays_differ": differ, "mesh_blocks_differ": mesh_differ[:8],
           "seconds_cpu_card": secs}
    emit(row)
    if differ or mesh_differ or tri_counts[0] == 0:
        fail(f"fuser on the card differs from its CPU run: {row}")
    del maps, a, b
    torch.cuda.empty_cache()

    # (c) Replica files: 16 frames of the same orbit, written and read.
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        root = Path(tmp) / "replica"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_replica_sequence(root, scene, camera, n_frames=REPLICA_FILES,
                               orbit_radius=2.0, orbit_height=1.5,
                               target=(0.0, 0.0, 1.0),
                               with_color=codec is not None, device=dev)
        write_ms = (time.perf_counter() - t0) * 1e3 / REPLICA_FILES
        poses = [orbit_pose(2 * np.pi * i / REPLICA_FILES, radius=2.0,
                            height=1.5, target=(0.0, 0.0, 1.0))
                 for i in range(REPLICA_FILES)]
        q = [quantize_depth(render_depth(scene, camera, pose, device=dev)
                            .cpu().numpy()) for pose in poses]
        pngs = [(root / "results" / f"depth{i:06d}.png").read_bytes()
                for i in range(REPLICA_FILES)]
        t0 = time.perf_counter()
        decoded = [image_codec.decode_png(b) for b in pngs]
        png_ms = (time.perf_counter() - t0) * 1e3 / REPLICA_FILES
        read = list(ReplicaDataLoader(root))
        exact = (len(read) == REPLICA_FILES
                 and all(np.array_equal(d, w) for d, w in zip(decoded, q))
                 and all(np.array_equal(f.depth, w.astype(np.float32)
                                        / DEPTH_SCALE)
                         for f, w in zip(read, q)))
        with_color = all(f.color is not None for f in read)

        def fuse_files(backend):
            f = Fuser(ReplicaDataLoader(root), FuserConfig(),
                      backend=backend, device=dev)
            torch.cuda.synchronize()
            t = time.perf_counter()
            f.run()
            torch.cuda.synchronize()
            return f.mapper, (time.perf_counter() - t) * 1e3 / REPLICA_FILES

        dm, dev_ms = fuse_files("device")
        # The same frames from memory: the writer's quantized depth, the
        # orbit's poses and the camera, never through the files.
        mem = Fuser([Frame(depth=w.astype(np.float32) / DEPTH_SCALE,
                           T_L_C=np.asarray(pose, np.float32), camera=camera)
                     for w, pose in zip(q, poses)],
                    FuserConfig(), device=dev)
        mem.run()
        tsdf_files, tsdf_mem = (_tsdf_by_block(mm) for mm in (dm, mem.mapper))
        keys_files, keys_mem = set(tsdf_files), set(tsdf_mem)
        tsdf_equal = keys_files == keys_mem and all(
            np.array_equal(tsdf_files[k], tsdf_mem[k]) for k in keys_files)
        row = {"phase": "fuser", "part": "replica_files",
               "frames": REPLICA_FILES, "jpeg_codec": codec,
               "color": with_color, "write_ms_per_frame": write_ms,
               "png_decode_ms_per_frame": png_ms, "depth_exact": exact,
               "png_bytes_per_frame": float(np.mean([len(b) for b in pngs])),
               "device_ms_per_frame_wall": dev_ms,
               "blocks_files": len(keys_files), "blocks_memory": len(keys_mem),
               "tsdf_files_equal_memory": tsdf_equal}
        emit(row)
        if not exact or not tsdf_equal or not keys_files:
            fail(f"Replica files did not round-trip: {row}")
        if with_color != (codec is not None):
            fail(f"Replica colors with codec {codec}: {with_color}")
        del mem, tsdf_files, tsdf_mem

        # (d) the host-table backend on the same files.
        hm, host_ms = fuse_files("host")
        rows = hm.table.allocated_slots()
        keys_host = {tuple(k) for k in hm.table.block_indices[rows].tolist()}
        bi = dm.state.block_index_of_slot[:dm.block_count()].tolist()
        slots = np.asarray([hm.table.slot_of(tuple(k)) for k in bi])
        tsdf_diff = max(
            float((dm.channels[k][:dm.block_count()]
                   - hm.pool[k][torch.as_tensor(slots, device=dev)])
                  .abs().max()) for k in ("tsdf_distance", "tsdf_weight"))
        h_tsdf, h_esdf, _ = map_errors(hm, scene, voxel, rows)
        d_tsdf, d_esdf, _ = map_errors(dm, scene, voxel)
        row = {"phase": "fuser", "part": "host_backend",
               "frames": REPLICA_FILES, "blocks": len(keys_host),
               "blocks_device_backend": len(keys_files),
               "ms_per_frame": host_ms, "device_backend_ms_per_frame": dev_ms,
               "tsdf_mae_m": h_tsdf, "esdf_mae_m": h_esdf,
               "device_backend_tsdf_mae_m": d_tsdf,
               "device_backend_esdf_mae_m": d_esdf,
               "tsdf_max_abs_diff_vs_device": tsdf_diff,
               "mesh_triangles": int(hm.mesh_layer.as_arrays()[2].shape[0])}
        emit(row)
        if keys_host != keys_files or tsdf_diff > 1e-5 \
                or row["mesh_triangles"] == 0:
            fail(f"host backend differs from the device backend: {row}")
        del hm, dm
        torch.cuda.empty_cache()

        # (e) the example pipeline, every artifact written.
        out = Path(tmp) / "pipeline"
        t0 = time.perf_counter()
        node = run_pipeline.main(["--frames", "4", "--out", str(out),
                                  "--device", str(dev)])
        pipe_s = time.perf_counter() - t0
        arts = {a: (out / a).stat().st_size if (out / a).exists() else 0
                for a in ("mesh.ply", "tsdf.ply", "esdf.ply", "map.png",
                          "map.yaml", "mesh.html")}
        row = {"phase": "fuser", "part": "pipeline", "frames": 4,
               "seconds": pipe_s, "artifact_bytes": arts,
               "blocks": node.multi_mapper.static_mapper.block_count()}
        emit(row)
        if not all(arts.values()):
            fail(f"the example pipeline left an artifact empty: {arts}")
        del node
    torch.cuda.empty_cache()



def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")

    from isaac_ros_nvblox_tpu_torch import kernels, native
    from isaac_ros_nvblox_tpu_torch.core.types import (
        Transform, voxel_centers_for_blocks)
    from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
    from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import (
        DeviceMapper, _esdf_solve)
    from isaac_ros_nvblox_tpu_torch.mapper.params import MapperParams
    from isaac_ros_nvblox_tpu_torch.models.camera import Camera
    from isaac_ros_nvblox_tpu_torch.models.scene import (Box, RoomBox, Scene,
                                                         Sphere, orbit_pose,
                                                         render_depth)
    from isaac_ros_nvblox_tpu_torch.ops import esdf as esdf_ops
    from isaac_ros_nvblox_tpu_torch.ops import view as view_ops
    from isaac_ros_nvblox_tpu_torch.ops.tsdf import (MODE_CODE,
                                                     TsdfIntegratorParams,
                                                     integrate_tsdf)
    from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # ---- phase 1: the card and the kernels' build ------------------------
    t0 = time.perf_counter()
    built = kernels.build()
    for name in kernels.SIGNATURES:
        kernels.library(name)
    build_s = time.perf_counter() - t0
    # The host libraries (g++): the publish path's mesh helpers and the
    # dataset loaders' PNG unfilter.
    t0 = time.perf_counter()
    native.library()
    native.png_library()
    emit({"phase": "gpu", "nvidia_smi": smi, "kind": kind,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": build_s, "build_s_per_source": built,
          "native_build_s": time.perf_counter() - t0})

    # ---- phase 2: the main path at the benchmark's size ------------------
    camera = Camera(fx=500.0, fy=500.0, cx=319.5, cy=239.5, width=640,
                    height=480)
    scene = Scene(primitives=(
        RoomBox(center=(0.0, 0.0, 1.5), half_extents=(3.0, 2.2, 1.5)),
        Sphere(center=(1.2, 0.8, 1.0), radius=0.5),
        Box(center=(-1.5, -1.0, 0.4), half_extents=(0.4, 0.4, 0.4)),
    ))
    voxel = 0.05
    n_frames = 16
    poses = torch.stack([torch.as_tensor(
        orbit_pose(2 * np.pi * k / n_frames, radius=1.5), device=dev)
        for k in range(n_frames)])
    depths = torch.stack([render_depth(scene, camera, poses[k], device=dev)
                          for k in range(n_frames)])
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(depths).all())
            and float((depths > 0).float().mean()) > 0.9):
        fail("rendered depth frames are not finite or mostly empty")

    params = MapperParams(
        projective=TsdfIntegratorParams(max_integration_distance_m=5.0))
    trunc = params.projective.truncation_m(voxel)

    def pick_max_blocks():
        # The benchmark's rule: the smallest batch bucket that holds the
        # worst frame's touched-block count with 64 blocks of slack.
        worst = 0
        for k in range(n_frames):
            grid, _ = view_ops.touched_block_grid(
                depths[k], poses[k], camera=camera, voxel_size_m=voxel,
                max_distance_m=5.0, truncation_m=trunc)
            worst = max(worst, int(grid.sum()))
        for bucket in (512, 1024, 2048, 4096):
            if worst <= bucket - 64:
                return bucket
        return 4096

    max_blocks = pick_max_blocks()
    mapper = DeviceMapper(
        voxel_size_m=voxel, params=params,
        world=wg.WorldGridConfig(dims=(64, 64, 32), capacity=16384,
                                 origin_block=(-32, -32, -8)),
        max_blocks_per_frame=max_blocks, device=dev)
    depths_r = torch.cat([depths] * 4)
    poses_r = torch.cat([poses] * 4)
    n_steps = depths_r.shape[0]
    esdf_every = 4
    # The benchmark's slot bucket: the ESDF's pool-shaped stages run on the
    # pool prefix that can be allocated (~2.2k blocks) instead of all 16384
    # slots; check_slot_bucket() asserts after timing that this was exact.
    slot_bucket = 4096
    esdf_kw = dict(esdf_every=esdf_every, slot_bucket=slot_bucket)

    # Warm-up: build the map once; its allocated AABB fixes the ESDF region.
    mapper.replay_frames(depths_r, poses_r, camera)
    region = mapper.esdf_region(margin_blocks=0, mult=1)
    mapper.replay_frames(depths_r, poses_r, camera, esdf_region=region,
                         **esdf_kw)
    torch.cuda.synchronize()

    def t_replay(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mapper.replay_frames(depths_r, poses_r, camera, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    kernels.reset_launch_counts()
    t_tsdf, t_both = [], []
    for _ in range(3):
        t_tsdf.append(t_replay())
        t_both.append(t_replay(esdf_region=region, **esdf_kw))
    launches = dict(kernels.LAUNCHES)
    PATH_LAUNCHES["main_path"] = launches
    mapper.check_slot_bucket()
    tsdf_ms = float(np.median(t_tsdf)) / n_steps * 1e3
    for name in ("tsdf_fuse", "edt_pass1", "edt_pass"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")

    n_blocks = mapper.block_count()
    overflow = int(mapper.state.overflow_count)
    if overflow != 0:
        fail(f"overflow_count {overflow} != 0")

    # Accuracy against the analytic scene (the benchmark's definition).
    bidx = mapper.state.block_index_of_slot[:n_blocks]
    gt = scene.sdf(voxel_centers_for_blocks(bidx, voxel))
    ch = mapper.channels
    tsdf = ch["tsdf_distance"][:n_blocks]
    w = ch["tsdf_weight"][:n_blocks]
    sq = ch["esdf_sq_dist"][:n_blocks]
    inside = ch["esdf_is_inside"][:n_blocks]
    for name, t in (("tsdf", tsdf), ("weight", w), ("gt", gt)):
        if t.shape != (n_blocks, 512) or not bool(torch.isfinite(t).all()):
            fail(f"{name} rows are not finite f32[{n_blocks}, 512]")
    near = (gt.abs() < 0.1) & (w > 0.5)
    tsdf_mae = float((tsdf - gt).abs()[near].mean())
    est = torch.clamp_max(torch.sqrt(torch.clamp_max(sq, esdf_ops.INF_SQ))
                          * voxel, 2.0)
    est = torch.where(inside, -est, est)
    emask = (gt > 3 * voxel) & (gt < 1.0) & (sq < 1e11)
    esdf_mae = float((est - gt).abs()[emask].mean())
    # One ESDF update of the path (sites + three passes + gather) alone:
    # event-timed per call, and its device time. (The difference of the
    # two replays above is lost in the host's noise: the path is host-bound.)
    band = mapper.esdf_band_vox
    dims_b = tuple(int(d) for d in region[1])
    origin_t = torch.as_tensor(np.asarray(region[0]), dtype=torch.int32,
                               device=dev)

    def esdf_update(rows=slot_bucket):
        _esdf_solve(mapper.state, ch["tsdf_distance"][:rows],
                    ch["tsdf_weight"][:rows], origin_t, dims_b=dims_b,
                    band=band, voxel_size_m=voxel, esdf_params=params.esdf)

    esdf_ms = cuda_ms(esdf_update)
    esdf_device_ms = plain_device_ms(esdf_update)
    # The same update over all slots: what the slot bucket saves.
    esdf_device_ms_whole_pool = plain_device_ms(
        lambda: esdf_update(mapper.capacity))
    evs, _ = trace(lambda: mapper.replay_frames(depths_r, poses_r, camera), 1)
    tsdf_device_ms = sum(us for _, us in evs) / n_steps / 1e3 if evs else None
    path = {"phase": "main_path", "frames": n_steps,
            "esdf_every": esdf_every, "slot_bucket": slot_bucket,
            "esdf_region_origin": [
                int(v) for v in region[0]],
            "esdf_region_dims_blocks": list(region[1]),
            "max_blocks_per_frame": max_blocks,
            "tsdf_ms_per_frame": tsdf_ms,
            "tsdf_device_ms_per_frame": tsdf_device_ms,
            "esdf_ms_per_update": esdf_ms,
            "esdf_device_ms_per_update": esdf_device_ms,
            "esdf_device_ms_whole_pool": esdf_device_ms_whole_pool,
            "replay_s_tsdf": t_tsdf, "replay_s_tsdf_esdf": t_both,
            "allocated_blocks": n_blocks, "overflow_count": overflow,
            "tsdf_mae_m": tsdf_mae, "esdf_mae_m": esdf_mae,
            "tsdf_voxels_scored": int(near.sum()),
            "esdf_voxels_scored": int(emask.sum()),
            "launches": launches, "nvidia_smi": smi}
    emit(path)
    if not tsdf_mae <= TSDF_MAE_LIMIT_M:
        fail(f"tsdf_mae_m {tsdf_mae} > {TSDF_MAE_LIMIT_M}")
    if not esdf_mae <= ESDF_MAE_LIMIT_M:
        fail(f"esdf_mae_m {esdf_mae} > {ESDF_MAE_LIMIT_M}")

    # ---- where the time goes: one replay with ESDF updates, traced -------
    def replay_esdf():
        mapper.replay_frames(depths_r, poses_r, camera, esdf_region=region,
                             **esdf_kw)

    evs, wall = trace(replay_esdf, 1)
    mapper.check_slot_bucket()
    busy_us = sum(us for _, us in evs)
    by_name = {}
    for name, us in evs:
        key = name[:80]
        n_us = by_name.setdefault(key, [0, 0.0])
        n_us[0] += 1
        n_us[1] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    emit({"phase": "profile", "frames": n_steps, "esdf_every": esdf_every,
          "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
          "device_idle_share": (1 - busy_us / 1e6 / wall) if evs else None,
          "device_activities_per_frame": len(evs) / n_steps,
          "device_to_host_copies": sum(1 for n, _ in evs if "DtoH" in n),
          "top": [{"name": k, "count": c, "ms": us / 1e3}
                  for k, (c, us) in top]})

    results = []

    # ---- each kernel against its plain version ---------------------------
    # tsdf_fuse on frame 0's batch of the converged map (the path's shapes).
    st = wg.WorldGridState(**{k: v.clone() for k, v in
                              vars(mapper.state).items()})
    grid, origin = view_ops.touched_block_grid(
        depths[0], poses[0], camera=camera, voxel_size_m=voxel,
        max_distance_m=5.0, truncation_m=trunc)
    st, slots, bidx0, n_sel = wg.allocate_and_batch(st, grid, origin,
                                                    max_blocks=max_blocks)
    kw = dict(camera=camera, voxel_size_m=voxel, params=params.projective)
    d_k, w_k = ch["tsdf_distance"].clone(), ch["tsdf_weight"].clone()
    d_p, w_p = d_k.clone(), w_k.clone()
    integrate_tsdf_cuda(d_k, w_k, slots, bidx0, depths[0], poses[0], **kw)
    integrate_tsdf(d_p, w_p, slots, bidx0, depths[0], poses[0], **kw)
    torch.cuda.synchronize()
    rows = slots[slots < mapper.capacity].long()
    dk, dp, wk, wp = d_k[rows], d_p[rows], w_k[rows], w_p[rows]
    same = float(((dk == dp) & (wk == wp)).float().mean())
    exact = bool(torch.equal(d_k, d_p) and torch.equal(w_k, w_p))
    untouched = rows_untouched((d_k, w_k), (ch["tsdf_distance"],
                                            ch["tsdf_weight"]), rows)
    obs_agree = float(((wk > 0) == (wp > 0)).float().mean())
    both = (wk > 0) & (wp > 0)
    err = (dk - dp).abs()[both]
    max_err = float(torch.maximum((d_k - d_p).abs().max(),
                                  (w_k - w_p).abs().max()))
    med = float(err.median()) if err.numel() else 0.0
    p99 = float(torch.quantile(err[:1_000_000], 0.99)) if err.numel() else 0.0
    n_valid = int(rows.numel())
    n_changed = int((wp != ch["tsdf_weight"][rows]).sum())
    real = (slots >= 0) & (slots < mapper.capacity)
    p_C = Transform.apply(Transform.inverse(poses[0]),
                          voxel_centers_for_blocks(bidx0, voxel))
    uv, ok = camera.project(p_C)
    n_view, n_updated = tsdf_reads_writes(uv, p_C[..., 2], ok & real[:, None],
                                          depths[0], params.projective, voxel)

    def run_k(sel=slice(None)):
        integrate_tsdf_cuda(d_k, w_k, slots[sel], bidx0[sel], depths[0],
                            poses[0], **kw)

    def run_p():
        integrate_tsdf(d_p, w_p, slots, bidx0, depths[0], poses[0], **kw)

    ms, how = kernel_ms(run_k, "tsdf_fuse_kernel")
    # The batch's real entries alone (what its padding costs), and its
    # first real entry alone (a launch and one block's chain of loads).
    real_idx = torch.nonzero(real).squeeze(1)
    ms_real, _ = kernel_ms(lambda: run_k(real_idx), "tsdf_fuse_kernel")
    ms_one, _ = kernel_ms(lambda: run_k(real_idx[:1]), "tsdf_fuse_kernel")
    ms_call = cuda_ms(run_k)
    plain_ms = cuda_ms(run_p)
    plain_dev = plain_device_ms(run_p)
    H, W = depths.shape[1:]
    # Each in-view voxel reads its distance and weight (8 B), an updated
    # one writes them back; the depth image (f32) is read once, the
    # batch's slots and block indices and the pose once.
    b_ms, b_by = bound_ms(
        n_view * 8 + n_updated * 8 + H * W * 4 + slots.numel() * 16 + 64,
        n_valid * 512 * 30 + n_updated * 15)
    tsdf_check = {"phase": "kernel_check", "name": "tsdf_fuse",
                  "batch_blocks": n_valid, "max_blocks": max_blocks,
                  "in_view_voxels": n_view, "updated_voxels": n_updated,
                  "changed_voxels": n_changed, "identical_fraction": same,
                  "bit_exact": exact, "rows_untouched": untouched,
                  "observed_agreement": obs_agree, "median_err": med,
                  "p99_err": p99, "max_abs_err": max_err, "ms": ms,
                  "ms_timing": how, "ms_real_entries": ms_real,
                  "ms_one_entry": ms_one, "ms_call": ms_call,
                  "plain_ms": plain_ms,
                  "plain_device_ms": plain_dev, "bound_ms": b_ms,
                  "bound_by": b_by, "launches": launches["tsdf_fuse"]}
    CHECKS.append(tsdf_check)
    if not (exact and untouched and n_changed > 0):
        fail(f"tsdf_fuse differs from its plain version: {tsdf_check}")
    results.append({"name": "tsdf_fuse", "route": "cuda",
                    "source": "isaac_ros_nvblox_tpu_torch/csrc/tsdf_fuse.cu",
                    "replaces": "isaac_ros_nvblox_tpu/ops/tsdf_pallas.py:100",
                    "launches": launches["tsdf_fuse"], "max_abs_err": max_err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})

    # edt_pass1 / edt_pass on the path's ESDF region, seeded from the map
    # (the path's last update came after its last frame).
    is_site, _, _ = esdf_ops.esdf_sites_from_tsdf(
        ch["tsdf_distance"], ch["tsdf_weight"], voxel_size_m=voxel,
        max_site_distance_vox=params.esdf.max_site_distance_vox,
        min_weight=params.esdf.min_weight)
    edt_rows = edt_check(mapper.state, is_site, ch["esdf_sq_dist"], origin_t,
                         dims_b, band, "main_path")

    for name, src_line in (("edt_pass1", 260), ("edt_pass", 113)):
        rs = edt_rows[name]
        results.append({
            "name": name, "route": "cuda",
            "source": "isaac_ros_nvblox_tpu_torch/csrc/edt.cu",
            "replaces": f"isaac_ros_nvblox_tpu/ops/esdf_dense.py:{src_line}",
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs) / len(rs),
            "plain_ms": sum(r["plain_ms"] for r in rs) / len(rs),
            "bound_ms": sum(r["bound_ms"] for r in rs) / len(rs),
            "bound_by": rs[-1]["bound_by"], "library_ms": None})

    del mapper
    torch.cuda.empty_cache()

    # ---- the occupancy path (static_occupancy mode) ----------------------
    world = wg.WorldGridConfig(dims=(64, 64, 32), capacity=16384,
                               origin_block=(-32, -32, -8))
    results.append(occupancy_phase(
        dev, smi, camera, scene, depths_r,
        [orbit_pose(2 * np.pi * k / n_frames, radius=1.5)
         for k in range(n_frames)], voxel, world))

    # ---- the colored-mesh pipeline at the reference's cadence ------------
    from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import (
        _surface_batch)
    from isaac_ros_nvblox_tpu_torch.mapper.params import mesh_accuracy_params
    from isaac_ros_nvblox_tpu_torch.models.scene import (
        cluttered_multi_room_scene, look_at_pose, render_color)
    from isaac_ros_nvblox_tpu_torch.ops import mesh_cuda as mc
    from isaac_ros_nvblox_tpu_torch.ops.color import (integrate_color_planar,
                                                      integrate_tsdf_color)
    from isaac_ros_nvblox_tpu_torch.ops.color_cuda import integrate_color_cuda
    from isaac_ros_nvblox_tpu_torch.ops.tsdf_color_cuda import (
        integrate_tsdf_color_cuda)
    from isaac_ros_nvblox_tpu_torch.utils.metrics import mesh_accuracy

    colors = torch.stack([render_color(scene, camera, poses[k], device=dev)
                          for k in range(n_frames)])
    colors_r = torch.cat([colors] * 4)
    pm = DeviceMapper(
        voxel_size_m=voxel, params=params,
        world=wg.WorldGridConfig(dims=(64, 64, 32), capacity=16384,
                                 origin_block=(-32, -32, -8)),
        max_blocks_per_frame=max_blocks, device=dev)
    pm.replay_frames(depths_r, poses_r, camera)
    p_region = pm.esdf_region(margin_blocks=0, mult=1)
    pipe_kw = dict(esdf_every=4, esdf_region=p_region, mesh_every=8,
                   colors=colors_r, color_every=8, slot_bucket=slot_bucket)
    mesh_kw = dict(mesh_every=1, mesh_max_blocks=1024,
                   mesh_surface_blocks=512, slot_bucket=slot_bucket)
    color_kw = dict(colors=colors_r, color_every=1)
    pm.replay_frames(depths_r, poses_r, camera, **pipe_kw)    # warm-up

    def p_replay(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pm.replay_frames(depths_r, poses_r, camera, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    kernels.reset_launch_counts()
    t_pipe = [p_replay(**pipe_kw) for _ in range(3)]
    launches_pipe = dict(kernels.LAUNCHES)
    PATH_LAUNCHES["pipeline"] = launches_pipe
    for name in ("tsdf_fuse", "tsdf_color_fuse", "edt_pass1", "edt_pass",
                 "marching_cubes"):
        if launches_pipe[name] <= 0:
            fail(f"kernel {name} was not launched on the pipeline path")
    pending_pipe = int(pm.mesh_pending.sum())
    pm.check_slot_bucket()
    pipe_dev_ms, pipe_wall = device_ms(
        lambda: pm.replay_frames(depths_r, poses_r, camera, **pipe_kw))
    # Marginals as bench.py:229-235 defines them: the replay with every
    # frame meshed, or every frame colored, minus the TSDF-only replay;
    # host wall (median of 3) and device time.
    t_plain = [p_replay() for _ in range(3)]
    t_mesh = [p_replay(**mesh_kw) for _ in range(3)]
    pending_mesh1 = int(pm.mesh_pending.sum())
    t_color = [p_replay(**color_kw) for _ in range(3)]
    pm.check_slot_bucket()
    plain_dev_ms, _ = device_ms(lambda: pm.replay_frames(depths_r, poses_r,
                                                         camera))
    evs, _ = trace(lambda: pm.replay_frames(depths_r, poses_r, camera,
                                            **mesh_kw), 1)
    mesh_dev_ms = sum(us for _, us in evs) / 1e3
    mesh_top = top_kernels(evs, n_steps)
    color_dev_ms, _ = device_ms(lambda: pm.replay_frames(
        depths_r, poses_r, camera, **color_kw))
    pm.check_slot_bucket()
    overflow_p = int(pm.state.overflow_count)

    def per_frame(ts):
        return float(np.median(ts)) / n_steps * 1e3

    pipe = {"phase": "pipeline", "frames": n_steps, "esdf_every": 4,
            "mesh_every": 8, "color_every": 8, "slot_bucket": slot_bucket,
            "esdf_region_origin": [int(v) for v in p_region[0]],
            "esdf_region_dims_blocks": list(p_region[1]),
            "pipeline_ms_per_frame": per_frame(t_pipe),
            "pipeline_device_ms_per_frame": pipe_dev_ms / n_steps,
            "pipeline_device_idle_share": 1 - pipe_dev_ms / 1e3 / pipe_wall,
            "replay_s_pipeline": t_pipe,
            "tsdf_ms_per_frame": per_frame(t_plain),
            "tsdf_device_ms_per_frame": plain_dev_ms / n_steps,
            "mesh_ms_marginal": per_frame(t_mesh) - per_frame(t_plain),
            "mesh_device_ms_marginal": (mesh_dev_ms - plain_dev_ms) / n_steps,
            "color_ms_marginal": per_frame(t_color) - per_frame(t_plain),
            "color_device_ms_marginal": (color_dev_ms - plain_dev_ms)
            / n_steps,
            "mesh_every_1_top_per_frame": mesh_top,
            "mesh_pending_after_pipeline": pending_pipe,
            "mesh_pending_after_mesh_every_1": pending_mesh1,
            "allocated_blocks": pm.block_count(), "overflow_count": overflow_p,
            "launches": launches_pipe, "nvidia_smi": smi}
    emit(pipe)
    if overflow_p != 0:
        fail(f"pipeline overflow_count {overflow_p} != 0")
    if pending_mesh1 != 0:
        fail(f"mesh_pending holds {pending_mesh1} blocks after the "
             "mesh_every=1 replay")
    if not bool((pm.channels["color_weight"] > 0).any()):
        fail("the pipeline painted no voxel")

    # ---- color frames with an unaligned occlusion depth ------------------
    half = depths_r[:, ::2, ::2].contiguous()
    color_frames = list(range(7, n_steps, 8))
    pm.integrate_color(colors_r[7], poses_r[7], camera, depth=half[7])

    def color_pass():
        for k in color_frames:
            pm.integrate_color(colors_r[k], poses_r[k], camera,
                               depth=half[k])

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    color_pass()
    torch.cuda.synchronize()
    t_cpass = time.perf_counter() - t0
    launches_color = dict(kernels.LAUNCHES)
    PATH_LAUNCHES["color_frames"] = launches_color
    if launches_color["color_fuse"] <= 0:
        fail("kernel color_fuse was not launched by integrate_color")
    # Device time and the busiest activities of a color frame.
    evs, _ = trace(color_pass, 1)
    cpass_dev_ms = sum(us for _, us in evs) / 1e3
    # The color wrapper's occlusion switch (ops/color_cuda.py: any depth
    # > 0, as a device byte) on one frame's depth.
    has_depth_dev = plain_device_ms(
        lambda: torch.any(half[7] > 0.0).to(torch.uint8))
    emit({"phase": "color_frames", "frames": len(color_frames),
          "color": list(colors.shape[1:]), "occlusion_depth":
          list(half.shape[1:]), "ms_per_frame": t_cpass * 1e3
          / len(color_frames), "device_ms_per_frame": cpass_dev_ms
          / len(color_frames),
          "activities_per_frame": len(evs) / len(color_frames),
          "has_depth_device_ms": has_depth_dev,
          "top_per_frame": top_kernels(evs, len(color_frames)),
          "launches": launches_color})

    # ---- the new kernels against their plain versions --------------------
    pch = pm.channels
    names6 = ("tsdf_distance", "tsdf_weight", "color_r", "color_g", "color_b",
              "color_weight")
    kw = dict(camera=camera, voxel_size_m=voxel, params=params.projective)
    cap = pm.capacity
    H, W = depths.shape[1:]
    # The two color kernels' instantiation on these inputs (weighting mode,
    # u8 color) in ptxas's mangled names.
    inst = f"ILi{MODE_CODE[params.projective.weighting_mode]}Eh"

    # tsdf_color_fuse on frame 7's batch (a color-cadence frame).
    st = wg.WorldGridState(**{k: v.clone() for k, v in vars(pm.state).items()})
    grid, origin = view_ops.touched_block_grid(
        depths_r[7], poses_r[7], camera=camera, voxel_size_m=voxel,
        max_distance_m=5.0, truncation_m=trunc)
    st, slots7, bidx7, _ = wg.allocate_and_batch(st, grid, origin,
                                                 max_blocks=max_blocks)
    base = [pch[k].clone() for k in names6]
    rows_k = [b.clone() for b in base]
    rows_p = [b.clone() for b in base]
    args7 = (slots7, bidx7, depths_r[7], colors_r[7], poses_r[7])
    integrate_tsdf_color_cuda(*rows_k, *args7, **kw)
    integrate_tsdf_color(*rows_p, *args7, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(rows_k, rows_p))
    err5 = max(float((a - b).abs().max()) for a, b in zip(rows_k, rows_p))
    n_valid7 = int((slots7 < cap).sum())
    n_view7 = in_view_voxels(slots7, bidx7, poses_r[7], camera, voxel, cap)
    n_tsdf7 = int(changed(rows_p[:2], base[:2]).sum())
    n_col7 = int(changed(rows_p[2:], base[2:]).sum())

    def run5(sel=slice(None)):
        integrate_tsdf_color_cuda(*rows_k, slots7[sel], bidx7[sel],
                                  *args7[2:], **kw)

    ms5, how5 = kernel_ms(run5, "tsdf_color_fuse_kernel")
    # The batch's real entries alone (what its padding costs), and its
    # first real entry alone (a launch and one block's chain of loads).
    real7 = torch.nonzero((slots7 >= 0) & (slots7 < cap)).squeeze(1)
    ms5_real, _ = kernel_ms(lambda: run5(real7), "tsdf_color_fuse_kernel")
    ms5_one, _ = kernel_ms(lambda: run5(real7[:1]), "tsdf_color_fuse_kernel")
    plain5 = cuda_ms(lambda: integrate_tsdf_color(*rows_p, *args7, **kw))
    plain5_dev = plain_device_ms(lambda: integrate_tsdf_color(
        *rows_p, *args7, **kw))
    # Each in-view voxel reads its distance and weight, an updated one
    # writes them back, a colored one reads and writes four color rows;
    # the depth (f32) and color (u8) images are read once.
    b5, b5_by = bound_ms(n_view7 * 8 + n_tsdf7 * 8 + n_col7 * 32
                         + H * W * (4 + 3) + slots7.numel() * 16,
                         n_view7 * 40 + n_col7 * 20)
    row5 = {"phase": "kernel_check", "name": "tsdf_color_fuse",
            "batch_blocks": n_valid7, "in_view_voxels": n_view7,
            "tsdf_updated_voxels": n_tsdf7, "colored_voxels": n_col7,
            "bit_exact": exact, "max_abs_err": err5, "ms": ms5,
            "ms_timing": how5, "ms_real_entries": ms5_real,
            "ms_one_entry": ms5_one, "plain_ms": plain5,
            "plain_device_ms": plain5_dev, "bound_ms": b5, "bound_by": b5_by,
            "ptxas": ptxas_rows("tsdf_color_fuse", FUSE_THREADS, inst),
            "launches": launches_pipe["tsdf_color_fuse"]}
    CHECKS.append(row5)
    if not exact or n_col7 == 0:
        fail(f"tsdf_color_fuse differs from its plain version: {row5}")
    results.append({"name": "tsdf_color_fuse", "route": "cuda",
                    "source": "isaac_ros_nvblox_tpu_torch/csrc/"
                              "tsdf_color_fuse.cu",
                    "replaces": "isaac_ros_nvblox_tpu/ops/"
                                "tsdf_color_pallas.py:51",
                    "launches": launches_pipe["tsdf_color_fuse"],
                    "max_abs_err": err5, "ms": ms5, "plain_ms": plain5,
                    "bound_ms": b5, "bound_by": b5_by, "library_ms": None})

    # color_fuse on the color path's batch of frame 7.
    grid, origin = view_ops.touched_block_grid(
        torch.full((H, W), 5.0, device=dev), poses_r[7], camera=camera,
        voxel_size_m=voxel, max_distance_m=5.0, truncation_m=trunc)
    slots_c, bidx_c, _ = wg.view_batch(pm.state, grid, origin,
                                       max_blocks=max_blocks)
    base = [pch[k].clone() for k in names6[2:]]
    rows_k = [b.clone() for b in base]
    rows_p = [b.clone() for b in base]
    args_c = (pch["tsdf_distance"], pch["tsdf_weight"], slots_c, bidx_c,
              colors_r[7], half[7], poses_r[7])
    integrate_color_cuda(*rows_k, *args_c, **kw)
    integrate_color_planar(*rows_p, *args_c, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in zip(rows_k, rows_p))
    err6 = max(float((a - b).abs().max()) for a, b in zip(rows_k, rows_p))
    n_valid_c = int((slots_c < cap).sum())
    n_view_c = in_view_voxels(slots_c, bidx_c, poses_r[7], camera, voxel,
                              cap)
    n_col_c = int(changed(rows_p, base).sum())

    def run6(sel=slice(None), occlusion=half[7]):
        integrate_color_cuda(*rows_k, *args_c[:2], slots_c[sel], bidx_c[sel],
                             args_c[4], occlusion, args_c[6], **kw)

    ms6, how6 = kernel_ms(run6, "color_fuse_kernel")
    real_c = torch.nonzero((slots_c >= 0) & (slots_c < cap)).squeeze(1)
    ms6_real, _ = kernel_ms(lambda: run6(real_c), "color_fuse_kernel")
    ms6_one, _ = kernel_ms(lambda: run6(real_c[:1]), "color_fuse_kernel")
    # An all-zero occlusion depth switches the occlusion test off: held
    # bit for bit against the plain version too, then timed.
    zero = torch.zeros_like(half[7])
    nz_k = [b.clone() for b in base]
    nz_p = [b.clone() for b in base]
    integrate_color_cuda(*nz_k, *args_c[:5], zero, args_c[6], **kw)
    integrate_color_planar(*nz_p, *args_c[:5], zero, args_c[6], **kw)
    torch.cuda.synchronize()
    exact_nz = all(torch.equal(a, b) for a, b in zip(nz_k, nz_p))
    ms6_nz, _ = kernel_ms(lambda: run6(occlusion=zero), "color_fuse_kernel")
    plain6 = cuda_ms(lambda: integrate_color_planar(*rows_p, *args_c, **kw))
    plain6_dev = plain_device_ms(lambda: integrate_color_planar(
        *rows_p, *args_c, **kw))
    # Each in-view voxel reads its distance and weight; a colored one reads
    # and writes four color rows; the color (u8) and occlusion depth (f32)
    # images are read once.
    b6, b6_by = bound_ms(n_view_c * 8 + n_col_c * 32 + H * W * 3
                         + half[7].numel() * 4 + slots_c.numel() * 16,
                         n_view_c * 30 + n_col_c * 20)
    row6 = {"phase": "kernel_check", "name": "color_fuse",
            "batch_blocks": n_valid_c, "in_view_voxels": n_view_c,
            "colored_voxels": n_col_c, "bit_exact": exact,
            "max_abs_err": err6, "ms": ms6, "ms_timing": how6,
            "ms_real_entries": ms6_real, "ms_one_entry": ms6_one,
            "ms_no_occlusion": ms6_nz, "no_occlusion_bit_exact": exact_nz,
            "plain_ms": plain6, "plain_device_ms": plain6_dev,
            "bound_ms": b6, "bound_by": b6_by,
            "ptxas": ptxas_rows("color_fuse", FUSE_THREADS, inst),
            "launches": launches_color["color_fuse"]}
    CHECKS.append(row6)
    if not (exact and exact_nz) or n_col_c == 0:
        fail(f"color_fuse differs from its plain version: {row6}")
    results.append({"name": "color_fuse", "route": "cuda",
                    "source": "isaac_ros_nvblox_tpu_torch/csrc/color_fuse.cu",
                    "replaces": "isaac_ros_nvblox_tpu/ops/color_pallas.py:42",
                    "launches": launches_color["color_fuse"],
                    "max_abs_err": err6, "ms": ms6, "plain_ms": plain6,
                    "bound_ms": b6, "bound_by": b6_by, "library_ms": None})

    # marching_cubes on the surface batch of the pipeline's first mesh step
    # (every block dirty after the first 8 frames; the default budgets).
    live = wg.live_slot_mask(pm.state)
    nbr8, valid, *_ = _surface_batch(
        pm.state, live, torch.zeros_like(live), pch["tsdf_distance"],
        pch["tsdf_weight"], min_weight=float(params.mesh.min_weight),
        max_blocks=2048, slot_bucket=slot_bucket)
    crows = tuple(pch[k] for k in names6[2:5])
    mc_args = (pch["tsdf_distance"], pch["tsdf_weight"], crows, nbr8, valid)
    mc_kw = dict(min_weight=float(params.mesh.min_weight), with_color=True)
    got = mc.marching_cubes_fused(*mc_args, **mc_kw)
    want = mc.marching_cubes_plain(*mc_args, **mc_kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                for a, b in zip(got, want))
    err4 = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))
    n_surf = int(valid.sum())
    n_tris = int(want[2][:, 0].float().sum())
    ms4, how4 = kernel_ms(lambda: mc.marching_cubes_fused(*mc_args, **mc_kw),
                          "marching_cubes_kernel")
    plain4 = cuda_ms(lambda: mc.marching_cubes_plain(*mc_args, **mc_kw))
    plain4_dev = plain_device_ms(lambda: mc.marching_cubes_plain(*mc_args,
                                                                 **mc_kw))
    # The store floor: the same batch with every row padding (only the
    # sentinel fill runs), and one torch fill call per output tensor.
    dead = torch.zeros_like(valid)
    ms4_pad, _ = kernel_ms(lambda: mc.marching_cubes_fused(
        *mc_args[:4], dead, **mc_kw), "marching_cubes_kernel")
    outs = [torch.empty_like(x) for x in got]

    def fill_outputs():
        outs[0].fill_(-1.0)
        outs[1].zero_()
        outs[2].zero_()

    fill4 = plain_device_ms(fill_outputs)
    # Outputs: bf16 verts and colors [N, 3, 16, 512] and table
    # [N, 16, 512] (112 KB per batch row); inputs: the distinct halo rows
    # of the surface blocks, five f32 channels of 2 KB each.
    halo = nbr8[valid > 0]
    n_rows = int(torch.unique(halo[halo >= 0]).numel())
    n_out = nbr8.shape[0] * (2 * 3 * 16 * 512 * 2 + 16 * 512 * 2)
    b4, b4_by = bound_ms(n_out + n_rows * 5 * 2048 + nbr8.numel() * 4,
                         n_surf * 512 * (12 * 12 + 60))
    row4 = {"phase": "kernel_check", "name": "marching_cubes",
            "batch_blocks": int(nbr8.shape[0]), "surface_blocks": n_surf,
            "halo_rows": n_rows, "triangles": n_tris, "bit_exact": exact,
            "max_abs_err": err4, "ms": ms4, "ms_timing": how4,
            "plain_ms": plain4, "plain_device_ms": plain4_dev,
            "bound_ms": b4, "bound_by": b4_by, "ms_all_padding": ms4_pad,
            "fill_ms": fill4,
            "fill": "verts.fill_(-1), colors.zero_(), table.zero_(): "
                    "write-only yardstick, device time",
            "ptxas": ptxas_rows("marching_cubes", MC_THREADS),
            "launches": launches_pipe["marching_cubes"]}
    CHECKS.append(row4)
    if not exact or n_tris == 0:
        fail(f"marching_cubes differs from its plain version: {row4}")
    results.append({"name": "marching_cubes", "route": "cuda",
                    "source": "isaac_ros_nvblox_tpu_torch/csrc/"
                              "marching_cubes.cu",
                    "replaces": "isaac_ros_nvblox_tpu/ops/mesh_pallas.py:78",
                    "launches": launches_pipe["marching_cubes"],
                    "max_abs_err": err4, "ms": ms4, "plain_ms": plain4,
                    "bound_ms": b4, "bound_by": b4_by, "library_ms": None})
    del pm, rows_k, rows_p, base, got, want
    torch.cuda.empty_cache()

    # ---- mesh accuracy: the benchmark's accuracy run ---------------------
    acc_scene = cluttered_multi_room_scene()
    acc_poses = torch.stack([torch.as_tensor(look_at_pose(
        (cx + 1.6 * np.cos(2 * np.pi * k / 12), 1.4 * np.sin(2 * np.pi * k / 12),
         1.3), (cx, 0.0, 1.2)), device=dev)
        for cx in (-3.0, 3.0) for k in range(12)])
    acc_depths = torch.stack([render_depth(acc_scene, camera, T, device=dev)
                              for T in acc_poses])
    am = DeviceMapper(
        voxel_size_m=voxel, params=mesh_accuracy_params(7.0),
        world=wg.WorldGridConfig(dims=(64, 64, 32), capacity=16384,
                                 origin_block=(-32, -32, -8)),
        enable_color=False, max_blocks_per_frame=4096, device=dev)
    t0 = time.perf_counter()
    am.replay_frames(acc_depths, acc_poses, camera)
    acc = mesh_accuracy(am, acc_scene)
    acc_s = time.perf_counter() - t0
    acc_row = {"phase": "mesh_accuracy", "frames": int(acc_depths.shape[0]),
               "allocated_blocks": am.block_count(),
               "overflow_count": int(am.state.overflow_count),
               "seconds": acc_s, **acc,
               "limits": {"mesh_surface_err_m": MESH_ERR_LIMIT_M,
                          "mesh_precision": MESH_PRECISION_MIN,
                          "mesh_completeness": MESH_COMPLETENESS_MIN,
                          "mesh_fscore": MESH_FSCORE_MIN}}
    emit(acc_row)
    if acc_row["overflow_count"] != 0:
        fail("mesh accuracy run overflowed")
    if not (acc["mesh_surface_err_m"] <= MESH_ERR_LIMIT_M
            and acc["mesh_precision"] >= MESH_PRECISION_MIN
            and acc["mesh_completeness"] >= MESH_COMPLETENESS_MIN
            and acc["mesh_fscore"] >= MESH_FSCORE_MIN):
        fail(f"mesh accuracy outside its limits: {acc_row}")

    del am
    torch.cuda.empty_cache()

    # ---- the 3D-lidar path ------------------------------------------------
    results.append(lidar_phase(dev, smi, voxel, world))

    # ---- the dynamic mode (MultiMapper) ------------------------------------
    scored, rows = dynamics_phase(dev, smi, camera, depths_r, poses_r,
                                  max_blocks, voxel, world)
    results.extend(rows)

    # ---- the publish path: the node's default MultiMapper -----------------
    publish_phase(dev, smi, camera,
                  [orbit_pose(2 * np.pi * k / n_frames, radius=1.5)
                   for k in range(n_frames)], depths_r, voxel, world, scored)
    intr = scored[1]
    del scored

    # ---- the online node: the runtime over the publish path --------------
    node_phase(dev, smi, camera, scene, voxel, world, depths, intr)
    del intr
    torch.cuda.empty_cache()

    # ---- the offline fuser and the host-table backend ---------------------
    fuser_phase(dev, smi, scene, voxel)

    flush_checks()
    emit({"kernels": results})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
