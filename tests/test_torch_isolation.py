"""The port stands alone: no JAX, no reference package, CUDA by default,
plain versions only for CPU tensors, and a smoke script that refuses to run
without a card."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.mapper.device_mapper import DeviceMapper
from isaac_ros_nvblox_tpu_torch.mapper.multi_mapper import MultiMapper
from isaac_ros_nvblox_tpu_torch.mapper.params import (MappingType,
                                                      MultiMapperParams)
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.models.scene import (default_test_scene,
                                                     render_depth)
from isaac_ros_nvblox_tpu_torch.ops import esdf_dense as ed
from isaac_ros_nvblox_tpu_torch.ops.tsdf import (TsdfIntegratorParams,
                                                 integrate_tsdf)
from isaac_ros_nvblox_tpu_torch.ops.color import (integrate_color_planar,
                                                  integrate_tsdf_color)
from isaac_ros_nvblox_tpu_torch.ops.color_cuda import integrate_color_cuda
from isaac_ros_nvblox_tpu_torch.ops.mesh_cuda import (marching_cubes_fused,
                                                      marching_cubes_plain)
from isaac_ros_nvblox_tpu_torch.ops.tsdf_cuda import integrate_tsdf_cuda
from isaac_ros_nvblox_tpu_torch.ops.tsdf_color_cuda import (
    integrate_tsdf_color_cuda)
from isaac_ros_nvblox_tpu_torch.models.lidar import Lidar
from isaac_ros_nvblox_tpu_torch.ops.lidar_cuda import (
    integrate_tsdf_lidar_cuda)
from isaac_ros_nvblox_tpu_torch.ops.occupancy import (
    OccupancyIntegratorParams, integrate_occupancy)
from isaac_ros_nvblox_tpu_torch.ops.occupancy_cuda import (
    integrate_occupancy_cuda)
from isaac_ros_nvblox_tpu_torch.ops.tsdf import integrate_tsdf_lidar
from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.ops.detect import detect_dynamic_plain
from isaac_ros_nvblox_tpu_torch.ops.detect_cuda import detect_dynamic
from isaac_ros_nvblox_tpu_torch.ops.halo import (dilate_dense_grid,
                                                 dilate_dense_grid_plain)
from isaac_ros_nvblox_tpu_torch.runtime.node import NvbloxNode
from isaac_ros_nvblox_tpu_torch.datasets.fuser import Fuser, FuserConfig
from isaac_ros_nvblox_tpu_torch.datasets.synthetic import SyntheticDataLoader
from isaac_ros_nvblox_tpu_torch.mapper.mapper import Mapper

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "isaac_ros_nvblox_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py"))


def _clean_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_modules_import_without_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' "
              "or m.startswith('jax.') or m.startswith('jaxlib') "
              "or m.startswith('isaac_ros_nvblox_tpu.') "
              "or m == 'isaac_ros_nvblox_tpu' or m == 'imageio' "
              "or m.startswith('imageio.') or m == 'mesh_viewer' "
              "or m == 'tools' or m.startswith('tools.')]\n"
              "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(MODULES) >= 14
    # The dynamics slice's modules are among them.
    pkg = "isaac_ros_nvblox_tpu_torch."
    assert {pkg + m for m in (
        "ops.freespace", "ops.masking", "ops.detect", "ops.detect_cuda",
        "ops.ground_plane", "ops.backproject", "ops.image_preproc",
        "ops.halo", "mapper.multi_mapper")} <= set(MODULES)
    # And the publish slice's.
    assert {pkg + m for m in (
        "ops.esdf_slicer", "ops.dense_grid", "mapper.device_io", "io.ply",
        "io.occupancy_grid_io", "native.__init__")} <= set(MODULES)
    # And the runtime slice's.
    assert {pkg + m for m in (
        "utils.timing", "runtime.msgs", "runtime.queues",
        "runtime.transformer", "runtime.layer_streaming", "runtime.costmap",
        "runtime.adapters", "runtime.visualization",
        "runtime.sensor_helpers", "runtime.node",
        "runtime.config_loader")} <= set(MODULES)
    # And the offline fuser's and the host-table backend's.
    assert {pkg + m for m in (
        "datasets.base", "datasets.synthetic", "datasets.replica",
        "datasets.replica_writer", "datasets.recorded", "datasets.fuser",
        "io.image_codec", "io.mesh_viewer", "io.serialization",
        "core.block_pool", "mapper.mapper",
        "examples.run_pipeline")} <= set(MODULES)


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import jax|from jax)|isaac_ros_nvblox_tpu\.",
                     re.M)
    files = list(PKG.rglob("*.py")) + list(PKG.rglob("*.cu")) \
        + list(PKG.rglob("*.cc")) + [ROOT / "chip_smoke.py"]
    for f in files:
        text = f.read_text()
        assert not pat.search(text), f


def test_entry_points_default_to_cuda():
    cam = Camera(fx=50.0, fy=50.0, cx=15.5, cy=11.5, width=32, height=24)
    if torch.cuda.is_available():
        assert DeviceMapper(0.05).device.type == "cuda"
        assert NvbloxNode().device.type == "cuda"
        assert Mapper(0.05, capacity=16).device.type == "cuda"
        assert Fuser([]).mapper.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceMapper(0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiMapper(MultiMapperParams(block_capacity=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        render_depth(default_test_scene(), cam, np.eye(4, dtype=np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        NvbloxNode()
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticDataLoader(num_frames=1, camera=cam)
    with pytest.raises(RuntimeError, match="CUDA"):
        Mapper(0.05, capacity=16)
    for backend in ("device", "host"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Fuser([], FuserConfig(capacity=64), backend=backend)
    assert Fuser([], FuserConfig(capacity=64), backend="host",
                 device="cpu").mapper.device.type == "cpu"
    assert NvbloxNode(device="cpu").multi_mapper.device.type == "cpu"
    assert DeviceMapper(0.05, device="cpu").device.type == "cpu"
    mm = MultiMapper(MultiMapperParams(mapping_type=MappingType.DYNAMIC,
                                       block_capacity=64),
                     world=wg.WorldGridConfig(dims=(8, 8, 8), capacity=64),
                     device="cpu")
    assert mm.static_mapper.device.type == "cpu"
    assert mm.dynamic_mapper.device.type == "cpu"


def test_wrappers_take_plain_versions_on_cpu():
    cam = Camera(fx=50.0, fy=50.0, cx=15.5, cy=11.5, width=32, height=24)
    rng = np.random.RandomState(0)
    bidx = torch.from_numpy(rng.randint(-2, 3, (8, 3)).astype(np.int32))
    bidx[:, 2] = torch.arange(1, 9, dtype=torch.int32)
    slots = torch.arange(8, dtype=torch.int32)
    depth = torch.from_numpy((1.5 + rng.rand(24, 32)).astype(np.float32))
    T = torch.eye(4)
    d0, w0 = torch.zeros(16, 512), torch.zeros(16, 512)
    kernels.reset_launch_counts()
    kw = dict(camera=cam, voxel_size_m=0.05, params=TsdfIntegratorParams())
    a = integrate_tsdf_cuda(d0.clone(), w0.clone(), slots, bidx, depth, T, **kw)
    b = integrate_tsdf(d0.clone(), w0.clone(), slots, bidx, depth, T, **kw)
    assert float(b[1].max()) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    g = torch.where(torch.rand(16, 24, 40) < 0.02, 0.0, float(ed.INF))
    assert torch.equal(ed.edt_pass1(g, 1, 6), ed.edt_pass1_plain(g, 1, 6))
    assert torch.equal(ed.edt_pass(g, 2, 6), ed.edt_pass_plain(g, 2, 6))
    rows = [torch.rand(16, 512) for _ in range(6)]
    color = torch.from_numpy(rng.randint(0, 256, (24, 32, 3)).astype(np.uint8))
    a = integrate_color_cuda(*[r.clone() for r in rows[2:]], rows[0],
                             rows[1] + 1, slots, bidx, color, depth, T, **kw)
    b = integrate_color_planar(*[r.clone() for r in rows[2:]], rows[0],
                               rows[1] + 1, slots, bidx, color, depth, T, **kw)
    a += integrate_tsdf_color_cuda(*[r.clone() for r in rows], slots, bidx,
                                   depth, color, T, **kw)
    b += integrate_tsdf_color(*[r.clone() for r in rows], slots, bidx, depth,
                              color, T, **kw)
    nbr8 = torch.randint(-1, 16, (8, 8), dtype=torch.int32)
    mc = dict(min_weight=0.1, with_color=True)
    a += marching_cubes_fused(rows[0] - 0.5, rows[1], rows[2:5], nbr8, slots,
                              **mc)
    b += marching_cubes_plain(rows[0] - 0.5, rows[1], rows[2:5], nbr8, slots,
                              **mc)
    occ = dict(camera=cam, voxel_size_m=0.05,
               params=OccupancyIntegratorParams())
    lo = torch.randn(16, 512)
    obs = (torch.rand(16, 512) < 0.5).to(torch.uint8)
    a += integrate_occupancy_cuda(lo.clone(), obs.clone(), slots, bidx, depth,
                                  T, **occ)
    b += integrate_occupancy(lo.clone(), obs.clone(), slots, bidx, depth, T,
                             **occ)
    lidar = Lidar.equal_vertical_fov(64, 8, 0.5, min_range_m=0.1)
    rng_img = torch.from_numpy((1.0 + rng.rand(8, 64)).astype(np.float32))
    lkw = dict(lidar=lidar, voxel_size_m=0.05, params=TsdfIntegratorParams())
    a += integrate_tsdf_lidar_cuda(d0.clone(), w0.clone(), slots, bidx - 4,
                                   rng_img, T, **lkw)
    b += integrate_tsdf_lidar(d0.clone(), w0.clone(), slots, bidx - 4,
                              rng_img, T, **lkw)
    assert float(b[-1].max()) > 0
    grid = torch.where(torch.rand(2, 3, 1, 512) < 0.05, torch.rand(2, 3, 1,
                                                                   512), 0.0)
    a, b = list(a), list(b)
    a.append(dilate_dense_grid(grid))
    b.append(dilate_dense_grid_plain(grid))
    st = wg.create_world_grid(wg.WorldGridConfig(dims=(8, 8, 8), capacity=16,
                                                 origin_block=(-4, -4, 0)),
                              "cpu")
    st.slot_grid[3:5, 3:5, 4:6] = torch.arange(8, dtype=torch.int32).view(
        2, 2, 2)
    hc = torch.rand(16, 512) < 0.5
    for s in (1, 2):
        a.append(detect_dynamic(st, hc, depth, T, camera=cam,
                                voxel_size_m=0.05, max_depth_m=5.0,
                                subsample=s))
        b.append(detect_dynamic_plain(st, hc, depth, T, camera=cam,
                                      voxel_size_m=0.05, max_depth_m=5.0,
                                      subsample=s)[0].to(torch.uint8))
    assert int(b[-1].sum()) > 0 and float(a[-3].max()) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert set(kernels.LAUNCHES) == {"tsdf_fuse", "edt_pass1", "edt_pass",
                                     "color_fuse", "tsdf_color_fuse",
                                     "marching_cubes", "occupancy_fuse",
                                     "tsdf_lidar_fuse", "dilate_dense",
                                     "detect_dynamic"}
    assert not any(kernels.LAUNCHES.values())


def test_chip_smoke_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=_clean_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # Alone in a directory, without the package beside it.
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_sources_and_build_flags():
    for name in kernels.SIGNATURES:
        src = kernels.CSRC / f"{name}.cu"
        assert src.exists()
        assert 'extern "C"' in src.read_text()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert kernels.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert kernels.library_path("edt") != kernels.library_path("tsdf_fuse")
    # A kernel's build hash covers the headers it includes.
    for name, headers in kernels.HEADERS.items():
        for h in headers:
            assert (kernels.CSRC / h).exists()
            assert f'#include "{h}"' in (kernels.CSRC / f"{name}.cu").read_text()


def test_native_png_library_builds_into_the_build_dir():
    """The PNG unfilter library builds from the repository's source into
    build/torch_native/ (ignored by git), apart from the mesh library."""
    from isaac_ros_nvblox_tpu_torch import native
    path = native.library_path(native.PNG_SOURCE)
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.relative_to(ROOT).parts == ("build",
                                                        "torch_native")
    assert path != native.library_path()
    native.png_library()
    assert path.exists()
