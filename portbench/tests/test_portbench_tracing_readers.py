"""The readers of the program's sub-spans, span log and counters, each on
a hand-made context and a hand-made program log: known values, and None
where the span, counter or log is absent (as in a program that keeps
none)."""

import types

import pytest

from conftest import ROOT  # noqa: F401  (puts the repo on the path)
from isaac_ros_nvblox_tpu_torch.utils import timing
from isaac_ros_nvblox_tpu_torch.utils.timing import SpanRecord
from portbench import harness

SPAN_READERS = {"depth_upload_ms": "mapper/depth/upload",
                "depth_blocks_ms": "mapper/depth/blocks",
                "esdf2d_solve_ms": "mapper/esdf2d/solve",
                "mesh_readback_ms": "mapper/mesh/readback",
                "mesh_layer_ms": "mapper/mesh/layer"}
LOG_READERS = ("mesh_deferred_blocks", "host_reads_per_frame",
               "depth_device_busy_share")


def _rec(name, start, end, id, parent=None, **counters):
    r = SpanRecord(name, id, parent)
    r.start, r.end = start, end
    r.counters = {k.replace("__", "/"): list(v) for k, v in counters.items()}
    return r


# A window of steps over [1.0, 2.0]: two depth spans of 0.1 s, one mesh
# update with its readback, a span outside the window.
LOG = [
    _rec("mapper/depth/upload", 1.10, 1.11, 1, 0),
    _rec("node/depth/integrate", 1.10, 1.20, 0, 9),
    _rec("node/depth/integrate", 1.50, 1.60, 2, 9),
    _rec("mapper/mesh/readback", 1.70, 1.75, 3, 4,
         host__reads=(3, 3), mapper__mesh__deferred_blocks=(40, 1)),
    _rec("mapper/mesh/layer", 1.75, 1.78, 5, 4, host__reads=(2, 2)),
    _rec("node/mesh/update", 1.65, 1.80, 4, 9,
         mapper__mesh__deferred_blocks=(10, 1)),
    _rec("node/tick", 1.05, 1.90, 9),
    _rec("node/tick", 2.50, 2.60, 10, host__reads=(7, 7)),
]
# Busy on the card: [1.15, 1.25] and [1.55, 1.56]: half of the first
# depth span, a tenth of the second.
EVENTS = [("tsdf_fuse_kernel", 1.15, 1.25), ("copy", 1.55, 1.56),
          ("late", 2.55, 2.58)]


def _ctx(**kw):
    ctx = {"spans": {"mapper/depth/upload": (4, 0.0025),
                     "mapper/depth/blocks": (4, 0.0011),
                     "mapper/esdf2d/solve": (2, 0.0004),
                     "mapper/mesh/readback": (1, 0.05),
                     "mapper/mesh/layer": (1, 0.03)},
           "steps": [(1.0, 1.4, "harness/step"), (1.4, 2.0, "harness/step")],
           "frames": 2, "events": EVENTS}
    ctx.update(kw)
    return ctx


@pytest.fixture
def program_log(monkeypatch):
    monkeypatch.setattr(timing.Timing, "span_log", lambda: list(LOG))


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers(name):
    read = harness.metric_reader(name)
    _, mean_s = _ctx()["spans"][SPAN_READERS[name]]
    assert read(_ctx()) == pytest.approx(mean_s * 1e3)
    assert read(_ctx(spans={})) is None


def test_log_readers_read_the_window(program_log):
    ctx = _ctx()
    # (40 + 10) deferred blocks over 2 adds; the tick outside the window
    # is not counted.
    assert harness.metric_reader("mesh_deferred_blocks")(ctx) == 25.0
    # 5 reads in the window over 2 frames.
    assert harness.metric_reader("host_reads_per_frame")(ctx) == 2.5
    # (0.05 + 0.01) busy of 0.2 s of depth spans.
    share = harness.metric_reader("depth_device_busy_share")(ctx)
    assert share == pytest.approx(30.0)


@pytest.mark.parametrize("name", LOG_READERS)
def test_log_readers_without_their_input(name, monkeypatch):
    read = harness.metric_reader(name)
    # A program that keeps no log (an older version of the port).
    monkeypatch.setattr(timing, "Timing", types.SimpleNamespace())
    assert read(_ctx()) is None
    # A log without the reader's span or counter, or an empty one.
    monkeypatch.setattr(timing, "Timing", types.SimpleNamespace(
        span_log=lambda: [_rec("node/tick", 1.1, 1.2, 0)]))
    want = 0.0 if name == "host_reads_per_frame" else None
    assert read(_ctx()) == want
    monkeypatch.setattr(timing, "Timing",
                        types.SimpleNamespace(span_log=lambda: []))
    assert read(_ctx()) is None


def test_busy_share_needs_device_events(program_log):
    read = harness.metric_reader("depth_device_busy_share")
    assert read(_ctx(events=[])) is None
    assert read(_ctx(events=[("k", 1.0, 2.0)])) == pytest.approx(100.0)
