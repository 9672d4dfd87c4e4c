"""The harness on the CPU: everything BENCHMARK.json names is found by name,
the result line's keys, the run without a card, the reference against the
program at a tiny size, and the modules a run loads.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import cells, report
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in cells.manifest()["workloads"]]
SEED = 2 ** 33 + 12345          # above 32 signed bits, as the driver's are


def test_manifest_names_resolve():
    man = cells.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    for c in man["configs"]:
        path = ROOT / c["file"]
        cfg = json.loads(path.read_text())
        assert path == ROOT / "benchmark" / "configs" / f"{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in man["workloads"]:
        wl = cells.workload(w["name"])
        assert (wl["name"], wl["config"], wl["traffic"]) == (w["name"], w["config"], w["traffic"])
        assert hasattr(cells.traffic(w["traffic"]), "run")
    for kind in ("end_to_end", "per_layer"):
        for m in man[kind]:
            assert callable(cells.reader(m["name"]).read)
    for w in man["workloads"]:
        got = {m["name"] for m in cells.metrics_for(man, w["name"], "end_to_end")}
        assert "setup_s" in got and len(got) >= 2
        assert cells.metrics_for(man, w["name"], "per_layer")


@pytest.fixture(scope="module")
def tiny_runs():
    """Each cell's traffic at the tiny size on the CPU, untraced and traced."""
    torch.set_num_threads(4)
    out = {}
    for name in CELLS:
        for traced in (False, True):
            wl = tiny.workload(name)
            run = cells.traffic(wl["traffic"]).run(wl, SEED, 0.5, traced, torch.device("cpu"),
                                                   time.perf_counter())
            out[name, traced] = run
    return out


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tiny_runs, name, traced):
    run = tiny_runs[name, traced]
    man = cells.manifest()
    metrics = cells.read_metrics(
        cells.metrics_for(man, name, "per_layer" if traced else "end_to_end"), run)
    rec = report.result(run, metrics, traced)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(rec) == want + (["breakdown"] if traced else []) + ["checks"]
    assert set(rec["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(m) == {"value", "unit"} for m in rec["metrics"].values())
    json.dumps(rec)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_at_a_tiny_size(tiny_runs, name):
    """On the CPU the program runs its plain twins, of which the reference
    is a frozen copy: every compared number is exactly 0."""
    for traced in (False, True):
        run = tiny_runs[name, traced]
        assert run.correct and run.numbers
        assert all(v == 0.0 for _, v, _ in run.numbers), run.numbers


def test_no_card_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no result" in r.stderr and "CUDA" in r.stderr


def test_run_without_the_program_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder
    exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


_IMPORTS = """
import sys, time, torch
sys.path.insert(0, {root!r})
from benchmark.tests import tiny
from benchmark.harness import cells
for name in {cells!r}:
    wl = tiny.workload(name)
    cells.traffic(wl["traffic"]).run(wl, 7, 0.2, False, torch.device("cpu"), time.perf_counter())
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_a_run_loads_no_jax_module():
    r = subprocess.run([sys.executable, "-c", _IMPORTS.format(root=str(ROOT), cells=CELLS[:2])],
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-2000:]
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not tops & set(report.FORBIDDEN)
    assert "cnc_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.train_ref, benchmark.reference.serve_ref, "
            "benchmark.reference.compare\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not tops & (set(report.FORBIDDEN) | {"cnc_torch"})


def test_compare_takes_non_finite_as_failing():
    from benchmark.reference import compare
    ref = {"loss": [1.0, 1.0], "grad": {"a": 1.0, "b": 2.0, "c": 3.0},
           "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    lim = {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}
    assert compare.correct(compare.train(ref, ref, lim))
    for bad in ({**ref, "loss": [math.nan, 1.0]}, {**ref, "grad": {**ref["grad"], "b": math.nan}},
                {**ref, "change": {**ref["change"], "c": math.inf}}, {**ref, "loss": [1.0]}):
        assert not compare.correct(compare.train(bad, ref, lim)), bad
