"""The kernel build helpers of the port (isaac_ros_nvblox_tpu_torch/
kernels.py) that need no card: ptxas's resource report, the alignment
check of the wrappers that move 16 bytes a load or store, and the
wrappers' refusal of devices that are neither the CPU nor a card."""

import pytest
import torch

from isaac_ros_nvblox_tpu_torch import kernels
from isaac_ros_nvblox_tpu_torch.core import world_grid as wg
from isaac_ros_nvblox_tpu_torch.models.camera import Camera
from isaac_ros_nvblox_tpu_torch.ops.color_cuda import integrate_color_cuda
from isaac_ros_nvblox_tpu_torch.ops.detect_cuda import detect_dynamic
from isaac_ros_nvblox_tpu_torch.ops.esdf_dense import esdf_2d_from_sites
from isaac_ros_nvblox_tpu_torch.ops.occupancy import (
    OccupancyIntegratorParams)
from isaac_ros_nvblox_tpu_torch.ops.occupancy_cuda import (
    integrate_occupancy_cuda)
from isaac_ros_nvblox_tpu_torch.ops.tsdf import TsdfIntegratorParams
from isaac_ros_nvblox_tpu_torch.ops.tsdf_color_cuda import (
    integrate_tsdf_color_cuda)

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z4mc_cILb1EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z4mc_cILb1EEvPKf
    80 bytes stack frame, 88 bytes spill stores, 116 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 80 bytes cumulative \
stack size, 18788 bytes smem
ptxas info    : Compiling entry function '_Z6dilatePKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z6dilatePKfPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 6400 bytes smem
ptxas info    : Compiling entry function '_Z4noopv' for 'sm_90a'
ptxas info    : Used 4 registers, 352 bytes cmem[0]
"""


def test_parse_ptxas_report():
    got = kernels.parse_ptxas(LOG)
    assert got == {
        "_Z4mc_cILb1EEvPKf": {"registers": 64, "smem": 18788, "stack": 80,
                              "spill_stores": 88, "spill_loads": 116},
        "_Z6dilatePKfPf": {"registers": 56, "smem": 6400, "stack": 0,
                           "spill_stores": 0, "spill_loads": 0},
        "_Z4noopv": {"registers": 4, "smem": 0},
    }
    assert kernels.parse_ptxas("") == {}


def test_builds_keep_the_ptxas_report():
    assert kernels.NVCC_FLAGS[-2:] == ["-Xptxas", "-v"]
    assert kernels.library_path("dilate").with_suffix(".log").name.startswith(
        "libdilate-")


def test_check_aligned():
    t = torch.zeros(64)
    kernels.check_aligned("f", [("t", t), ("t4", t[4:])])
    with pytest.raises(ValueError, match="t1 must start on a 16-byte"):
        kernels.check_aligned("f", [("t", t), ("t1", t[1:])])
    kernels.check_aligned("f", [("t2", t[2:])], alignment=8)


CAM = Camera(fx=10.0, fy=10.0, cx=3.5, cy=2.5, width=8, height=6)


def _occupancy_on(dev):
    integrate_occupancy_cuda(
        torch.zeros(4, 512, device=dev),
        torch.zeros(4, 512, dtype=torch.uint8, device=dev),
        torch.zeros(2, dtype=torch.int32, device=dev),
        torch.zeros(2, 3, dtype=torch.int32, device=dev),
        torch.zeros(6, 8, device=dev), torch.eye(4, device=dev), camera=CAM,
        voxel_size_m=0.05, params=OccupancyIntegratorParams())


def _detect_on(dev):
    st = wg.create_world_grid(wg.WorldGridConfig(
        dims=(4, 4, 4), capacity=4, origin_block=(0, 0, 0)), dev)
    detect_dynamic(st, torch.zeros(4, 512, dtype=torch.bool, device=dev),
                   torch.zeros(6, 8, device=dev), torch.eye(4, device=dev),
                   camera=CAM, voxel_size_m=0.05, max_depth_m=5.0)


def _color_on(dev):
    integrate_color_cuda(
        *[torch.zeros(4, 512, device=dev) for _ in range(6)],
        torch.zeros(2, dtype=torch.int32, device=dev),
        torch.zeros(2, 3, dtype=torch.int32, device=dev),
        torch.zeros(6, 8, 3, dtype=torch.uint8, device=dev),
        torch.ones(3, 4, device=dev), torch.eye(4, device=dev), camera=CAM,
        voxel_size_m=0.05, params=TsdfIntegratorParams())


def _tsdf_color_on(dev):
    integrate_tsdf_color_cuda(
        *[torch.zeros(4, 512, device=dev) for _ in range(6)],
        torch.zeros(2, dtype=torch.int32, device=dev),
        torch.zeros(2, 3, dtype=torch.int32, device=dev),
        torch.ones(6, 8, device=dev),
        torch.zeros(6, 8, 3, dtype=torch.uint8, device=dev),
        torch.eye(4, device=dev), camera=CAM, voxel_size_m=0.05,
        params=TsdfIntegratorParams())


def _esdf_2d_on(dev):
    esdf_2d_from_sites(
        torch.ones(4, 512, dtype=torch.bool, device=dev),
        torch.ones(4, 512, dtype=torch.bool, device=dev),
        torch.zeros(4, 3, dtype=torch.int32, device=dev),
        torch.full((), 4, dtype=torch.int32, device=dev),
        torch.zeros(3, dtype=torch.int32, device=dev), dims_b=(1, 2), band=5)


@pytest.mark.parametrize(
    "call", [_occupancy_on, _detect_on, _color_on, _tsdf_color_on,
             _esdf_2d_on],
    ids=["occupancy_fuse", "detect_dynamic", "color_fuse",
         "tsdf_color_fuse", "esdf_2d_edt_passes"])
def test_wrappers_refuse_other_devices(call):
    """A wrapper takes the plain version for CPU tensors only and raises on
    any device that is neither the CPU nor a card: nothing falls back."""
    call("cpu")
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device meta"):
        call("meta")
    assert kernels.LAUNCHES == before
