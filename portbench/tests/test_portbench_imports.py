"""No run holds JAX or the JAX package; the reference holds nothing of the
program under test."""

import ast
import subprocess
import sys

from conftest import ROOT

REFERENCE = ROOT / "portbench" / "reference"


def _top_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_sources_import_torch_and_numpy_only():
    for path in REFERENCE.glob("*.py"):
        assert _top_imports(path) <= {"__future__", "bisect", "dataclasses",
                                      "functools", "json", "math", "pathlib",
                                      "typing", "numpy", "torch"}, path


CHECK = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.node, portbench.reference.fuser
import portbench.reference.mesh, portbench.reference.view
held = {{m.split('.')[0] for m in sys.modules}}
assert not held & {{'isaac_ros_nvblox_tpu_torch', 'chip_smoke'}}, held
from portbench import harness, programs, inputs, devtrace, compare, work
import portbench.kinds.node, portbench.kinds.fuser
import portbench.run
assert harness.forbidden_modules() == [], harness.forbidden_modules()
print('ok')
"""


def test_loaded_modules_after_import():
    out = subprocess.run([sys.executable, "-c", CHECK.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_forbidden_names_compare_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "isaac_ros_nvblox_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "isaac_ros_nvblox_tpu.core", sys)
    assert harness.forbidden_modules() == ["isaac_ros_nvblox_tpu"]
