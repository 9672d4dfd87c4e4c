#!/usr/bin/env python3
"""The rate basins' table from the runs' records (numpy only).

Reads the records `tools/torch_pipeline_run.py` (the port, P and Q) and
`tools/cnc_tpu_basin_run.py` (cnc_tpu, R) append to <dir>/summary.jsonl, or
the `point done:` lines of their logs, and the census files of
`tools/torch_basin_census.py`, and prints one row a run: the estimated rate
at steps 500 and 1,000, the median of the readings at 900, 920, ..., 1,000
and the basin it gives (upper above 2.8 MB; PERF.md §6, PR 19), the census
at step 1,000 (the four bands in MB, the entry-features clipped against
their symbol), and each 3D context feature that is clipped low on every
covered entry of its levels ("dead").

    python3 tools/basin_table.py SOURCE [SOURCE ...] [--census DIR] \
        [--pair SOURCE ...]

A SOURCE is a summary.jsonl or a log file (a glob); --census names the
directory of the census files (<tag>_<step>.json or
ckpt_s<seed>_<step>.json).  With --pair, each seed whose basin differs
between the two sets of runs gives a line: the upper run's excess over the
lower's in MB and in entry-features clipped against their symbol, and the
share of the excess the clipped-against band holds, at step 1,000.  With
--features, each run's 3D context features' clipped-low share at each step
that has a census file.
"""

import argparse
import glob
import json
import os

import numpy as np

UPPER_MB = 2.8
BANDS = ("lt1", "1to5", "gt5", "against")


def records(path):
    """The run records in a summary.jsonl or a log's `point done:` lines."""
    out = []
    with open(path) as fh:
        for line in fh:
            if "point done: " in line:
                out.append(json.loads(line.split("point done: ", 1)[1]))
            elif line.startswith("{"):
                out.append(json.loads(line))
    return out


def basin(trace, lo=900, hi=1000, every=20):
    r = {int(s): mb for s, mb, _ in trace}
    vals = [r[s] for s in range(lo, hi + 1, every) if s in r]
    if len(vals) != (hi - lo) // every + 1:
        return None, "incomplete"
    med = float(np.median(vals))
    return med, "upper" if med > UPPER_MB else "lower"


def low_shares(census):
    """Each 3D context feature's share of covered entries clipped low, over
    levels 3-11 together."""
    lv3 = [lv for lv in census["levels"] if lv["kind"] == "ctx" and lv["table"] == "xyz"]
    return [sum(lv["features"][f]["n_lo"] for lv in lv3)
            / max(sum(lv["features"][f]["n"] for lv in lv3), 1)
            for f in range(len(lv3[0]["features"]))]


def dead_features(census, frac=1.0):
    """3D context features clipped low on at least `frac` of their covered
    entries over every 3D context level."""
    lv3 = [lv for lv in census["levels"] if lv["kind"] == "ctx" and lv["table"] == "xyz"]
    out = []
    for f in range(len(lv3[0]["features"])):
        n = sum(lv["features"][f]["n"] for lv in lv3)
        lo = sum(lv["features"][f]["n_lo"] for lv in lv3)
        if n and lo >= frac * n:
            out.append(f)
    return out


def find_census(cdir, rec, step):
    if not cdir:
        return None
    names = []
    if "tsv_row" in rec:
        names.append(f"{rec['tsv_row'][0]}_{step}.json")
    names.append(f"ckpt_s{rec['seed']}_{step}.json")
    for n in names:
        p = os.path.join(cdir, n)
        if os.path.exists(p):
            with open(p) as fh:
                return json.load(fh)
    return None


def row(rec, cdir=None):
    tr = {int(s): mb for s, mb, _ in rec["rate_trace"]}
    med, which = basin(rec["rate_trace"])
    c = find_census(cdir, rec, 1000)
    tot = c["totals"] if c else rec.get("census", {}).get("1000")
    mb = lambda b: tot[f"bits_{b}"] / 8 / 2 ** 20
    cells = [str(rec["seed"]), f"{tr.get(500, float('nan')):.4f}", f"{tr.get(1000, float('nan')):.4f}",
             f"{med:.4f}" if med is not None else "n/a", which]
    if tot:
        cells += [" / ".join(f"{mb(b):.4f}" for b in BANDS), f"{tot['bits_pg'] / 8 / 2 ** 20:.4f}",
                  f"{tot['total_MB']:.4f}", f"{tot['n_against']:,}"]
    else:
        cells += ["not measured"] * 4
    cells.append(",".join(f"f{f}" for f in dead_features(c)) or "none" if c else "n/a")
    return "| " + " | ".join(cells) + " |"


def load(patterns):
    recs = []
    for pattern in patterns:
        for path in sorted(glob.glob(pattern)):
            recs += records(path)
    return sorted(recs, key=lambda r: r["seed"])


def census_totals(rec, cdir, step=1000):
    c = find_census(cdir, rec, step)
    return c["totals"] if c else rec.get("census", {}).get(str(step))


def pairs(recs, others, cdir=None, cdir_other=None):
    """Seed-matched upper/lower pairs: (seed, excess MB, excess clipped
    against, the clipped-against band's share of the excess bits)."""
    by_seed = {r["seed"]: (r, cdir) for r in recs}
    out = []
    for o in others:
        if o["seed"] not in by_seed:
            continue
        a, ca = by_seed[o["seed"]]
        ba, bo = basin(a["rate_trace"])[1], basin(o["rate_trace"])[1]
        if {ba, bo} != {"upper", "lower"}:
            continue
        (up, cu), (lo, cl) = ((a, ca), (o, cdir_other)) if ba == "upper" else ((o, cdir_other),
                                                                            (a, ca))
        tu, tl = census_totals(up, cu), census_totals(lo, cl)
        excess = tu["bits_total"] - tl["bits_total"]
        out.append((o["seed"], excess / 8 / 2 ** 20, tu["n_against"] - tl["n_against"],
                    (tu["bits_against"] - tl["bits_against"]) / excess))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--census", default=None)
    ap.add_argument("--pair", nargs="+", default=None)
    ap.add_argument("--pair_census", default=None)
    ap.add_argument("--features", action="store_true")
    args = ap.parse_args()
    if args.features:
        for rec in load(args.sources):
            cells = []
            for step in (0, 250, 500, 1000):
                c = find_census(args.census, rec, step)
                if c:
                    cells.append(f"{step}: " + " ".join(f"{x:.5f}" for x in low_shares(c)))
            print(f"seed {rec['seed']} ({basin(rec['rate_trace'])[1]}): " + "; ".join(cells))
        return 0
    if args.pair:
        for seed, mb, n, share in pairs(load(args.sources), load(args.pair), args.census,
                                        args.pair_census):
            print(f"seed {seed}: upper over lower {mb:.4f} MB, {n:,} more clipped against "
                  f"their symbol, that band {share:.3f} of the excess bits")
        return 0
    print("| seed | MB at 500 | MB at 1,000 | median 900–1,000 | basin | census at 1,000: "
          "<1 / 1–5 / >5 / against (MB) | Pg levels MB | total MB | against | dead 3D "
          "features |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    recs = load(args.sources)
    upper = 0
    for rec in recs:
        print(row(rec, args.census))
        upper += basin(rec["rate_trace"])[1] == "upper"
    print(f"upper: {upper} of {len(recs)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
