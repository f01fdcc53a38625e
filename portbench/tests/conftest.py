"""Shared pieces of the benchmark's CPU tests: the real cells cut to a
size a test run holds (a camera 80 pixels wide at the configuration's
field of view, a 180-column lidar, a 1 s lap
of 8 fuser frames, a 24 x 24 x 12-block world of 8192 slots), and the
card fixture."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SEED = 3735928559


# Cells measured and proven correct but left out of BENCHMARK.json for
# the spread of their runs (PERF.md section 7); their files stay, tested.
STAGED = {"fuser_replica.orbit": {"name": "fuser_replica.orbit",
                                  "config": "fuser_replica",
                                  "traffic": "orbit", "chips": 1},
          "node_base.headless": {"name": "node_base.headless",
                                 "config": "node_base",
                                 "traffic": "headless", "chips": 1}}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.Cell(name, STAGED.get(name))
    c = cell.config
    # 80 pixels across at the configuration's field of view.
    k = 80.0 / c["camera"]["width"]
    h = int(round(c["camera"]["height"] * k))
    c["camera"] = dict(c["camera"], fx=c["camera"]["fx"] * k,
                       fy=c["camera"]["fy"] * k, cx=39.5, cy=(h - 1) / 2,
                       width=80, height=h)
    if "lidar" in c:
        c["lidar"] = dict(c["lidar"], width=180)
        c["params"]["node"]["lidar_width"] = 180
        # The wide 80 x 60 view and the coarse lidar touch more blocks a
        # frame than the full-size camera and lidar: keep every one.
        c["params"]["mapper"]["max_blocks_per_frame"] = 8192
    c["world"] = {"dims": [24, 24, 12], "capacity": 8192,
                  "origin_block": [-12, -12, -3]}
    o = cell.traffic["orbit"]
    o["lap_s"] = 1.0
    if "frames_per_lap" in o:
        o["frames_per_lap"] = 8
    return cell


def tiny_run(name: str, seconds: float = 0.5, trace: bool = False):
    return harness.run(tiny_cell(name), SEED, seconds, trace, "cpu",
                       time.perf_counter(), log=lambda msg: None)


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
