"""Whole runs at a test's size on the CPU: the last line's shape, a sound
run comes out correct, the cells' metrics are there, and run.py refuses
to run without a card."""

import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT, SEED, tiny_cell, tiny_run
from portbench import devtrace, harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["node_base.viewer", "fuser_replica.orbit"])
def test_sound_run_is_correct_and_shaped(name):
    line = tiny_run(name)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert "breakdown" not in line
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["metrics"]) == {"frames_per_s", "peak_mem_mib",
                                    "setup_s"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]
    assert json.loads(json.dumps(line)) == line


class FakeTrace:
    """A device trace of two kernels a step apart, for the traced line's
    shape on a machine without a card."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        return False

    def events(self):
        t0 = self.t0
        return [("tsdf_fuse_kernel(float*, float*)", t0 + 0.01, t0 + 0.011),
                ("void edt_sweep_contig<4>(float const*)", t0 + 0.02,
                 t0 + 0.021),
                ("void at::native::elementwise_kernel<128, 4>()", t0 + 0.03,
                 t0 + 0.0305),
                ("Memcpy DtoH (Device -> Pinned)", t0 + 0.04, t0 + 0.0401)]


def test_traced_line_shape(monkeypatch):
    monkeypatch.setattr(devtrace, "DeviceTrace", FakeTrace)
    line = tiny_run("node_base.viewer", trace=True)
    assert list(line)[:6] == KEYS + ["breakdown"]
    assert list(line)[-1] == "checks"
    dev = line["device"]
    assert dev["busy_s"] > 0 and dev["window_s"] > dev["busy_s"]
    assert 0 < len(line["breakdown"]["device_ops"]) <= 10
    assert 0 < len(line["breakdown"]["idle_gaps"]) <= 10
    m = line["metrics"]
    cell = tiny_cell("node_base.viewer")
    assert set(m) <= {x["name"] for x in cell.per_layer}
    for name in ("node_tick_ms", "integrate_ms",
                 "mesh_update_ms", "host_bytes_per_frame",
                 "glue_device_ms_per_frame", "device_ms_per_frame",
                 "device_idle_share"):
        assert name in m, name
    # No peak table entry for a CPU: the rooflines find nothing to read.
    assert "roofline.tsdf_fuse" not in m
    assert m["glue_device_ms_per_frame"]["value"] < m["device_ms_per_frame"][
        "value"]


def test_kernel_names_of_the_program():
    names = harness.kernel_names(ROOT / harness.PORT)
    assert {"tsdf_fuse_kernel", "tsdf_lidar_fuse_kernel", "edt_sweep_contig",
            "marching_cubes_kernel"} <= names
    assert harness.kernel_of("void edt_sweep_contig<4>(float const*)") == \
        "edt_sweep_contig"
    assert harness.kernel_of("tsdf_fuse_kernel(float*, int)") == \
        "tsdf_fuse_kernel"
    assert harness.kernel_of(
        "void (anonymous namespace)::tsdf_fuse_kernel<3>(float*, float*)") \
        == "tsdf_fuse_kernel"
    assert harness.kernel_of(
        "(anonymous namespace)::edt_sweep_strided(float const*, float*)") \
        == "edt_sweep_strided"


def test_run_py_without_a_card_prints_nothing():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "node_base.viewer",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_frame_p95_reader():
    read = harness.metric_reader("frame_p95_ms")
    assert read({"latencies_ms": [1.0] * 19}) is None
    lat = [float(i) for i in range(1, 101)]
    assert abs(read({"latencies_ms": lat}) - 95.05) < 1e-9
