"""Each cell's inputs from the seed: equal for one seed, different across
seeds, and of the same amount of work for every seed."""

import json

import numpy as np
import pytest

from conftest import ROOT, STAGED, tiny_cell
from portbench import inputs

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]] + sorted(STAGED)


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_inputs_other_seed_other_inputs(name):
    cell = tiny_cell(name)
    cell.traffic["orbit"]["lap_s"] = 0.2
    a = inputs.make_lap(cell.config, cell.traffic, 2 ** 31 + 11, "cpu")
    b = inputs.make_lap(cell.config, cell.traffic, 2 ** 31 + 11, "cpu")
    c = inputs.make_lap(cell.config, cell.traffic, 2 ** 31 + 12, "cpu")
    for field in ("depths", "colors", "poses", "scans"):
        x, y, z = (getattr(lap, field) for lap in (a, b, c))
        if x is None:
            assert cell.kind == "fuser" and field == "scans"
            continue
        assert np.array_equal(x, y), field
        assert x.shape == z.shape, field
        assert not np.array_equal(x, z), field
    assert (a.orbit.phase, a.orbit.radius_m) == (b.orbit.phase,
                                                 b.orbit.radius_m)
    assert abs(a.orbit.radius_m - c.orbit.radius_m) <= 0.06
    # Every depth frame sees the room.
    assert (a.depths > 0).mean() > 0.95
