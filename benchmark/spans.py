#!/usr/bin/env python3
"""Where the card sits idle in one cell's traced window, by the program's
own spans (`cnc/<name>`, `cnc_torch/utils/profiling.py`).

    python3 benchmark/spans.py --workload CELL --seed N [--out FILE]

Runs the cell's traced window as `benchmark/run.py --trace 1` runs it (the
same traffic, profiler and ranges) and keeps the trace's events.  Prints
one JSON line, also appended to FILE: the result line of that run, and
under "spans" what `benchmark/metrics/_spans.py` reads from them: the
device-idle ms a step or a view inside each span quantity of its `IDLE_MS`,
the idle seconds by the innermost span the host was in, the share of idle
time inside a span other than the roots, the sync spans by name, and the
device operations that start before the span their launch lies in, with
the largest lead (none where the spans share the device's clock).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


@contextlib.contextmanager
def kept_events(trace_mod, kept: list):
    """While open, every trace the harness reduces leaves its events in
    `kept` too."""
    events = trace_mod.events

    def keep(prof):
        evs = events(prof)
        kept.extend(evs)
        return evs

    trace_mod.events = keep
    try:
        yield kept
    finally:
        trace_mod.events = events


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    from benchmark.harness import cells, report, trace
    from benchmark.metrics import _spans
    torch.set_num_threads(1)
    man = cells.manifest()
    entry = [w for w in man["workloads"] if w["name"] == args.workload]
    if not entry:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    wl = cells.workload(args.workload)
    try:
        device = report.require_cards(entry[0]["chips"])
    except report.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    with kept_events(trace, []) as evs:
        run = cells.traffic(wl["traffic"]).run(wl, args.seed, 1.0, True, device, T0)
    metrics = cells.read_metrics(cells.metrics_for(man, args.workload, "per_layer"), run)
    rec = report.result(run, metrics, True)
    rec.update(cell=args.workload, seed=args.seed, card=report.power_limit(),
               spans=_spans.summary(evs, run.kind, run.steps if run.kind == "train"
                                    else run.views))
    line = json.dumps(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
