"""The port's example pipeline and its viewer (CPU): the graph of
examples/run_pipeline.py (sensor -> NvbloxNode -> costmap, mesh adapter ->
PLY, map, HTML), run as `python -m isaac_ros_nvblox_tpu_torch.examples.
run_pipeline`, with tests/test_example_pipeline.py's checks; the viewer's
PLY reader and page against tools/mesh_viewer.py."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from isaac_ros_nvblox_tpu_torch.datasets.fuser import Fuser, FuserConfig
from isaac_ros_nvblox_tpu_torch.datasets.synthetic import SyntheticDataLoader
from isaac_ros_nvblox_tpu_torch.examples import run_pipeline
from isaac_ros_nvblox_tpu_torch.io import mesh_viewer as mv
from isaac_ros_nvblox_tpu_torch.io.ply import write_mesh_ply
from isaac_ros_nvblox_tpu_torch.models.camera import Camera

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "examples/config/nvblox"
ARTIFACTS = ("mesh.ply", "tsdf.ply", "esdf.ply", "map.png", "map.yaml",
             "mesh.html")


def _reference_viewer():
    spec = importlib.util.spec_from_file_location(
        "mesh_viewer", REPO / "tools" / "mesh_viewer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_pipeline_full_graph(tmp_path, capsys):
    run_pipeline.main(["--config", str(CONFIG / "nvblox_base.yaml"),
                       "--frames", "2", "--out", str(tmp_path),
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "blocks:" in out
    # All graph edges fired (mesh -> adapter, slice -> costmap).
    assert "'mesh': " in out and "costmap has data: True" in out
    for artifact in ARTIFACTS:
        p = tmp_path / artifact
        assert p.exists() and p.stat().st_size > 0, artifact


def test_example_pipeline_dynamic_mode(tmp_path, capsys):
    run_pipeline.main([
        "--config", str(CONFIG / "nvblox_base.yaml"),
        str(CONFIG / "specializations" / "nvblox_dynamics.yaml"),
        "--frames", "2", "--out", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "blocks:" in out and "costmap has data: True" in out
    assert (tmp_path / "mesh.ply").exists()


def test_example_pipeline_runs_as_a_module(tmp_path):
    """`python -m` from the repository root, imported without JAX."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; "
         "runpy.run_module('isaac_ros_nvblox_tpu_torch.examples."
         "run_pipeline', run_name='__main__'); "
         "assert not any(m == 'jax' or m.startswith('isaac_ros_nvblox_tpu.')"
         " for m in sys.modules)",
         "--frames", "1", "--out", str(tmp_path), "--device", "cpu",
         "--mode", "static"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "frames: 1" in proc.stdout
    assert all((tmp_path / a).exists() for a in ARTIFACTS)


@pytest.fixture(scope="module")
def fused():
    cam = Camera(fx=120.0, fy=120.0, cx=59.5, cy=44.5, width=120, height=90)
    fuser = Fuser(SyntheticDataLoader(num_frames=3, camera=cam,
                                      device="cpu"),
                  FuserConfig(capacity=8192), device="cpu")
    fuser.run()
    fuser.mapper.update_esdf()
    return fuser


def test_viewer_voxel_layer_payload_and_html(fused, tmp_path):
    """Voxel-layer cubes beside the mesh (nvblox_plugin_visual.cpp:91-310
    cube rendering + cut ceiling); the page equals the reference viewer's
    for the same arrays."""
    ref = _reference_viewer()
    assert mv._PAGE == ref._PAGE
    for layer in ("tsdf", "esdf", "color"):
        cubes = mv.voxel_layer_payload(fused.mapper, layer)
        assert cubes is not None
        centers, colors, vsize = cubes
        assert centers.shape[0] > 100 and centers.shape == colors.shape
        assert (colors >= 0).all() and (colors <= 1).all()
        assert vsize == fused.mapper.voxel_size_m
    assert mv.voxel_layer_payload(fused.mapper, "occupancy") is None
    v, c, t = fused.mapper.mesh_layer.as_arrays()
    out = tmp_path / "view.html"
    mv.write_html(out, v, c.astype(np.float32) / 255.0, t, cubes)
    ref.write_html(tmp_path / "ref.html", v, c.astype(np.float32) / 255.0,
                   t, cubes)
    html = out.read_text()
    assert html == (tmp_path / "ref.html").read_text()
    assert "drawArraysInstanced" in html and "zcut" in html
    assert len(html) > 10000


def test_viewer_reads_ply_as_reference(fused, tmp_path):
    v, c, t = fused.mapper.mesh_layer.as_arrays()
    write_mesh_ply(tmp_path / "m.ply", v, t, c)
    got = mv.read_ply(tmp_path / "m.ply")
    want = _reference_viewer().read_ply(tmp_path / "m.ply")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], v)
    np.testing.assert_array_equal(got[2], t)
