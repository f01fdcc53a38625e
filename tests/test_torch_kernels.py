"""The kernel build helpers of the port (isaac_ros_nvblox_tpu_torch/
kernels.py) that need no card: ptxas's resource report and the alignment
check of the wrappers that move 16 bytes a load or store."""

import pytest
import torch

from isaac_ros_nvblox_tpu_torch import kernels

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
