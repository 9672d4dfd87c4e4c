"""The program's spans in a traced window (`benchmark/metrics/_spans.py`)
against hand counts on a synthetic trace, the harness's `Trace` unchanged
by them, and the sync counter's reader at the tiny size on the CPU.

    python -m pytest benchmark/tests/test_spans.py -q
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans as spans_cli
from benchmark.harness import cells, trace
from benchmark.metrics import _spans
from benchmark.tests import tiny
from cnc_torch.utils import profiling

MAIN, AUTOGRAD = 1, 2


def _dev(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


def _launch(ts, corr, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": tid, "args": {"correlation": corr}}


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid}


# device ops (us): [0, 10] [20, 30] [25, 40] [70, 80] [100, 110] [150, 160]
# idle gaps:       (10, 20) (40, 70) (80, 100) (110, 150)
DEVICE = [_dev(0, 10, 1), _dev(20, 10, 2), _dev(25, 15, 3), _dev(70, 10, 4), _dev(100, 10, 5),
          _dev(150, 10, 6)]
LAUNCHES = [_launch(0, 1), _launch(15, 2), _launch(18, 3), _launch(60, 4), _launch(95, 5),
            _launch(140, 6)]
TRAIN = [_span("cnc/train/step", 0, 160),
         _span("cnc/train/rate", 5, 50),           # 10-20 and 40-55 idle inside
         _span("cnc/rate/pg_bits", 12, 4),         # nested: 12-16
         _span("cnc/train/backward", 55, 35),      # 55-70 and 80-90; the gap 40-70 straddles
         _span("cnc/train/update", 90, 20),        # 90-100
         _span("cnc/sync/step_end", 120, 10)]      # 120-130; 110-120 and 130-150 only the root
SERVE = [_span("cnc/serve/view", 0, 160),
         _span("cnc/serve/chunk", 0, 160),
         _span("cnc/serve/round", 10, 60),         # 10-20, 40-70
         _span("cnc/sync/alive", 10, 5),           # 10-15
         _span("cnc/render/field", 45, 20),        # 45-65
         _span("cnc/serve/round", 75, 40),         # 80-100, 110-115
         _span("cnc/render/field", 85, 10)]        # 85-95


def _idle_ms(spans, name):
    _, inc, exc = _spans.IDLE_MS[name]
    return 1e3 * _spans.idle_seconds(DEVICE, spans, inc, exc)


@pytest.mark.parametrize("name, spans, want_us", [
    ("rate_idle_ms.train", TRAIN, 10 + 15),
    ("backward_idle_ms.train", TRAIN, 15 + 10),
    ("update_idle_ms.train", TRAIN, 10),
    ("field_idle_ms.serve", SERVE, 20 + 10),
    ("round_idle_ms.serve", SERVE, 10 + 30 - 20 + 20 + 5 - 10),
])
def test_idle_inside_spans_by_hand(name, spans, want_us):
    assert _idle_ms(spans, name) == pytest.approx(want_us * 1e-3)


def test_idle_by_innermost_span_and_the_share_the_roots_leave():
    got = _spans.idle_by_innermost(DEVICE, TRAIN)
    want = {"cnc/train/rate": 2 + 4 + 15, "cnc/rate/pg_bits": 4, "cnc/train/backward": 25,
            "cnc/train/update": 10, "cnc/sync/step_end": 10, "cnc/train/step": 10 + 20}
    assert got.keys() == want.keys()
    for k, us in want.items():
        assert got[k] == pytest.approx(us * 1e-6), k
    assert _spans.covered_share(DEVICE, TRAIN) == pytest.approx(70 / 100)
    # time outside every span is named as such
    got = _spans.idle_by_innermost(DEVICE, [_span("cnc/train/update", 90, 20)])
    assert got[_spans.OUTSIDE] == pytest.approx(90e-6)
    assert _spans.covered_share(DEVICE, []) == 0.0 and _spans.covered_share([], TRAIN) is None


def test_early_ops_reads_the_shared_clock():
    evs = DEVICE + LAUNCHES + TRAIN
    assert _spans.early_ops(evs) == []
    # a kernel stamped before the span its launch lies in started
    bad = [dict(e, ts=10) if e.get("cat") == "kernel" and e["name"] == "k6" else e for e in evs]
    assert _spans.early_ops(bad + [_span("cnc/sync/late", 135, 10)]) == [125]
    # launches on another thread than the spans' are not held to them
    assert _spans.early_ops(DEVICE + [_launch(140, 6, AUTOGRAD)] + TRAIN) == []


def _harness_events():
    """A trace with the harness's own ranges, a launch in each, the ops'
    sequence numbers and autograd's backward of one of them."""
    cpu = [{"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 16, "dur": 3, "tid": MAIN,
            "args": {"Sequence number": 9}},
           {"ph": "X", "cat": "cpu_op", "name": "autograd::engine::evaluate_function: MulBackward0",
            "ts": 94, "dur": 3, "tid": AUTOGRAD, "args": {"Sequence number": 9}}]
    back = [_launch(95, 5, AUTOGRAD)]
    ranges = [_span("bench/rate", 5, 50), _span("bench/render", 58, 5)]
    return DEVICE + [e for e in LAUNCHES if e["args"]["correlation"] != 5] + back + cpu + ranges


def test_trace_reads_the_same_with_the_programs_spans():
    base = _harness_events()
    plain, mixed = trace.Trace(base, 0.2), trace.Trace(base + TRAIN + SERVE, 0.2)
    assert mixed.ranges == plain.ranges and len(plain.ranges) == 2
    assert mixed.busy_s == plain.busy_s == pytest.approx(60e-6)
    assert mixed.launch_calls == plain.launch_calls
    for name in ("rate", "render", "occupancy"):
        assert mixed.range_ops(name) == plain.range_ops(name)
    assert sorted(op["name"] for op in plain.range_ops("rate")) == ["k2", "k3", "k5"]
    assert mixed.breakdown() == plain.breakdown()


def _run(kind, steps=16):
    return SimpleNamespace(kind=kind, trace=object(), steps=steps, views=3)


def test_sync_counter_reads_only_a_training_window(monkeypatch):
    read = cells.reader("syncs_per_step.train").read
    monkeypatch.setattr(profiling, "recorded", profiling.collections.Counter(
        {"train/step": 16, "sync/draw_starts": 16, "sync/step_end": 16, "train/rate": 16}))
    assert read(_run("train")) == 2.0
    assert read(_run("serve")) is None
    assert read(SimpleNamespace(kind="train", trace=None, steps=16)) is None
    assert read(_run("train", steps=8)) is None            # the count spans other steps
    profiling.recorded["serve/view"] = 1
    assert read(_run("train")) is None                      # and a view
    monkeypatch.delattr(profiling, "recorded")              # a program without the count
    assert read(_run("train")) is None


def test_sync_counter_and_summary_at_the_tiny_size(monkeypatch):
    """One traced tiny training window on the CPU: the sync spans of its
    steps, counted by the program and found in the trace alike."""
    torch.set_num_threads(4)
    monkeypatch.setattr(profiling, "recorded", profiling.collections.Counter())
    wl = tiny.workload("nerf_synthetic.train_rate")
    with spans_cli.kept_events(trace, []) as evs:
        run = cells.traffic("train").run(wl, 2 ** 33 + 7, 0.5, True, torch.device("cpu"),
                                         time.perf_counter())
    assert trace.events.__name__ == "events"
    got = _spans.summary(evs, "train", run.steps)
    syncs = got["syncs"]
    for name in ("draw_starts", "level_resolutions", "host_scalar", "step_end"):
        assert syncs.pop("cnc/sync/" + name) == run.steps, name
    # three plane indices a field query: a render a step, and the occupancy update
    assert syncs.pop("cnc/sync/plane_index") >= 3 * run.steps and syncs == {}
    assert cells.reader("syncs_per_step.train").read(run) == got["syncs_per"] > 4
    assert got["spans"]["cnc/train/step"] == run.steps
    assert set(got["idle_ms"]) == {"rate_idle_ms.train", "backward_idle_ms.train",
                                   "update_idle_ms.train"}
