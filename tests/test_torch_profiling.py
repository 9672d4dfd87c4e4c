"""cnc_torch's section timers and trace (utils/profiling.py) against
cnc_tpu's: the same summary format from the same recorded sections, `force`
and `timed` on tensors, and a Chrome trace written to the directory asked
for."""

import json
import re

import jax.numpy as jnp
import pytest
import torch

from cnc_tpu.utils import profiling as jprof
from cnc_torch.utils import profiling as tprof


def _fill(timers):
    for name, secs in (("render", (0.25, 0.5)), ("encode", (1.5,)), ("bits", (0.001, 0.002, 0.003))):
        for s in secs:
            timers.totals[name] += s
            timers.counts[name] += 1
    return timers


def test_summary_format_equals_cnc_tpus():
    got, want = _fill(tprof.SectionTimers()).summary(), _fill(jprof.SectionTimers()).summary()
    assert got == want
    assert got.splitlines() == ["encode: 1.500s total, 1500.0 ms/call x1",
                                "render: 0.750s total, 375.0 ms/call x2",
                                "bits: 0.006s total, 2.0 ms/call x3"]


def test_section_and_timed():
    t = tprof.SectionTimers()
    with t.section("a"):
        sum(range(1000))
    with t.section("a"):
        pass
    x = torch.arange(6.0)
    out = t.timed("b", lambda v, k: {"y": [v * k]}, x, k=2.0)
    assert torch.equal(out["y"][0], x * 2)
    assert t.counts == {"a": 2, "b": 1} and all(v >= 0 for v in t.totals.values())
    for line in t.summary().splitlines():
        assert re.fullmatch(r"[ab]: \d+\.\d{3}s total, \d+\.\d ms/call x\d+", line)
    # force returns what it was given, tensors or not
    assert tprof.force(5) == 5 and tprof.force(x) is x
    assert jprof.force(jnp.ones(3)) is not None


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert d == str(tmp_path / "tr")
    names = {e.get("name") for e in data["traceEvents"]}
    assert any("mm" in str(n) for n in names)
