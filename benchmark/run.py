#!/usr/bin/env python3
"""Run one cell of the benchmark of `cnc_torch` once, on one card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

CELL is the name of an entry of BENCHMARK.json's `workloads`; its file
`benchmark/workloads/CELL.json` names the configuration
(`benchmark/configs/<config>.json`) and the traffic kind
(`benchmark/traffic/<kind>.py`, which sets up, measures for S seconds and
checks the outputs against the plain reference).  With `--trace 0` the
result line carries the cell's end-to-end metrics, with `--trace 1` (a
traced window) its per-layer ones; each is read by
`benchmark/metrics/<name>.py`.  The last line of standard output is the
result as one JSON object; the numbers that decide `correct` are the last
lines of standard error.  Without a CUDA card, or with fewer than the cell
asks for, it says why on standard error, prints no result and exits 2.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from benchmark.harness import cells, report
    import torch
    # one host thread for torch's CPU operators: the step is paced by the
    # host, and a pool of spinning threads on a shared machine spreads it
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
    print(f"card: {report.power_limit()}", file=sys.stderr)
    run = cells.traffic(wl["traffic"]).run(wl, args.seed, args.seconds, bool(args.trace),
                                            device, T0)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = cells.read_metrics(cells.metrics_for(man, args.workload, kind), run)
    bad = report.forbidden_modules()
    if bad:
        print(f"no result: modules of JAX or of cnc_tpu were loaded: {bad}", file=sys.stderr)
        return 3
    report.emit(report.result(run, metrics, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
