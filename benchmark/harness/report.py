"""The run's record: the look for the cards, the check that no JAX module
was loaded, the lines that give each compared number beside its limit, and
the result line."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace
from typing import Dict

FORBIDDEN = ("jax", "jaxlib", "flax", "cnc_tpu")


class NoCard(RuntimeError):
    """The cell asks for more cards than the machine has."""


def require_cards(chips: int):
    """The device to run on; raises NoCard (the run then prints no result)
    where torch sees no CUDA device or fewer than the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark measures the "
                     "port on a CUDA card and does not fall back to the CPU")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch sees "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def result(run: SimpleNamespace, metrics: Dict[str, dict], traced: bool) -> dict:
    import torch
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": bool(run.correct), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in run.numbers}
    return out


def emit(record: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, c in record["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(record), flush=True)
