"""On the card: one short run of each cell through run.py comes out
correct, with the contract's line last on standard output."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, SEED

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(card, name):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
