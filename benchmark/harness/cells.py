"""Everything the harness finds by name: the manifest, a cell's workload
file and configuration, a traffic kind's generator and a metric's reader."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]     # the checkout
BENCH = ROOT / "benchmark"


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    """A cell's workload file, with its configuration under "cfg"."""
    wl = _json(BENCH / "workloads" / f"{name}.json")
    wl["cfg"] = _json(BENCH / "configs" / f"{wl['config']}.json")
    return wl


def metrics_for(man: dict, cell: str, kind: str) -> List[dict]:
    """The manifest's metrics of `kind` ("end_to_end" or "per_layer") that
    this cell reports."""
    return [m for m in man[kind] if "workloads" not in m or cell in m["workloads"]]


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    return _module(BENCH / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")


def reader(metric: str):
    """A metric's reader: `read(run) -> float | None`."""
    return _module(BENCH / "metrics" / f"{metric}.py",
                   "benchmark_metric_" + metric.replace(".", "_"))


def read_metrics(specs: List[dict], run) -> Dict[str, dict]:
    out = {}
    for m in specs:
        v = reader(m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
