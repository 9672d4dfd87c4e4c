#!/usr/bin/env python3
"""A census of where the estimated rate's bits sit, per table, level and
output feature, on the port (torch only).

One full-coverage pass over every context level of a trainer's state: the
3D context levels in the codec's chunks (`CNCCodec.chunks3d`, each chunk's
own entries counted once), and each plane's 2D context levels whole, with
the full (unsampled) frac plane, through the port's float pools
(`ContextModels.pool_3d_level`, `pool_2d_level`, the functions the training
rate samples).  For every covered entry-feature the context model's pooled
output p is the probability of +1, clipped to [1e-6, 1 - 1e-6] before its
bits are taken (`ops/entropy.bernoulli_bits`).  Per feature the census
counts:

- `n`: covered entries; `n_lo` / `n_hi`: those with p below 1e-6 / above
  1 - 1e-6 (`n_out` both);
- `n_against`: the clipped ones whose symbol is the unlikely one (p < 1e-6
  on +1, p > 1 - 1e-6 on -1): log2(1e6) = 19.93 bits each;
- the level's bits in four bands, bits and counts: an entry under 1 bit,
  1-5 bits, over 5 bits in range, and clipped against (`bits_lt1`,
  `bits_1to5`, `bits_gt5`, `bits_against`; `n_lt1`, ...), which sum to
  `bits`.

The levels the context models do not code (3D 0-2, 2D 0) are listed with
their global-probability bits (`ops/entropy.global_pg_bits`), so `total_MB`
is a full-coverage estimate of the whole rate.

    python3 tools/torch_basin_census.py --ckpt CKPT.npz --out census.json \
        [--device cpu]

reads a checkpoint of either package at cnc_tpu's recorded configuration
(tools/torch_pipeline_run.py's defaults); `census_of_trainer(trainer)` does
the same in process (`tools/torch_pipeline_run.py --census_at`).  At full
width on the card a census takes seconds; on the CPU, ten minutes or more
and several GiB.  A census reads only the tables' signs, the context MLPs
and the occupancy grid, so

    python3 tools/torch_basin_census.py --pack CKPT.npz --out STATE.npz

(numpy only) keeps just those from a checkpoint, the signs one bit each
(about 3 MB at full width against a checkpoint's 240 MB), and --ckpt reads
such a file as it reads a checkpoint.
"""

import argparse
import json
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

AXES = ("xy", "xz", "yz")
BANDS = ("lt1", "1to5", "gt5", "against")
COUNTS = ("n", "n_lo", "n_hi", "n_out", "n_against") + tuple(f"n_{b}" for b in BANDS)


def tally(pooled, covered, values_q):
    """Per-feature counts and band bits of one pool's covered entries (torch
    tensors [n_e, F], [n_e], [n_e, F]) as python numbers: a list of F dicts."""
    import torch

    from cnc_torch.ops import entropy as ent_ops

    p = pooled[covered].float()
    x = values_q[covered].float()
    bits = ent_ops.bernoulli_bits(x, p)
    lo, hi = p < ent_ops.P_EPS, p > 1.0 - ent_ops.P_EPS
    against = (lo & (x > 0)) | (hi & (x < 0))
    band = {"lt1": ~against & (bits < 1.0), "gt5": ~against & (bits > 5.0),
            "against": against}
    band["1to5"] = ~against & ~band["lt1"] & ~band["gt5"]
    b64 = bits.double()
    cols = {"n": torch.ones_like(lo).sum(0), "n_lo": lo.sum(0), "n_hi": hi.sum(0),
            "n_out": (lo | hi).sum(0), "n_against": against.sum(0),
            "bits": b64.sum(0)}
    for name, m in band.items():
        cols[f"n_{name}"] = m.sum(0)
        cols[f"bits_{name}"] = torch.where(m, b64, 0.0).sum(0)
    f = pooled.shape[1]
    host = {k: v.cpu().tolist() for k, v in cols.items()}
    return [{k: (int(v[i]) if k.startswith("n") else float(v[i])) for k, v in host.items()}
            for i in range(f)]


def add_into(acc, part):
    """Sum one chunk's per-feature dicts into the level's."""
    if acc is None:
        return [dict(d) for d in part]
    for a, d in zip(acc, part):
        for k, v in d.items():
            a[k] += v
    return acc


def census(entropy, ent_params, tables, binaries, cache=None, codec=None):
    """The census of one state: the entropy model, its context MLPs, the
    four binarized tables (`rf.quantized_tables`) and the occupancy grid.
    Returns {"levels": [...], "totals": {...}}."""
    import torch

    from cnc_torch.codec.codec import CNCCodec
    from cnc_torch.ops import entropy as ent_ops

    with torch.no_grad():
        tables = {k: v.detach() for k, v in tables.items()}
        if cache is None:
            cache = entropy.refresh_cache(binaries)
        codec = codec or CNCCodec(entropy)
        levels = []
        tbl3 = tables["xyz"]
        for l, sl in enumerate(tbl3.split(list(entropy.spec3.level_sizes))):
            pg_n, bits_n, ttl = ent_ops.global_pg_bits(sl)
            if l not in entropy.ctx_levels_3d:
                levels.append({"table": "xyz", "level": l, "kind": "pg", "entries": int(ttl),
                               "bits": float(bits_n)})
                continue
            chunk_e, _, w = codec.chunks3d[l]
            acc = None
            for want_lo, want_hi, start in codec._chunk_bounds(l):
                pooled, covered, vq = entropy.pool_3d_level(ent_params, tbl3, cache, l, pg_n,
                                                            start, chunk_e, w)
                keep = slice(want_lo - start, want_hi - start)
                acc = add_into(acc, tally(pooled[keep], covered[keep], vq[keep]))
            levels.append({"table": "xyz", "level": l, "kind": "ctx",
                           "entries": entropy.tables3d[l].n_entries, "features": acc})
        for ai, ax in enumerate(AXES):
            tbl2 = tables[ax]
            plane = (entropy.pn_frac_plane(tbl3, cache["pn"][ax])
                     if entropy.cfg.use_dimension_wise else None)
            for l, sl in enumerate(tbl2.split(list(entropy.spec2.level_sizes))):
                pg_n, bits_n, ttl = ent_ops.global_pg_bits(sl)
                if l not in entropy.ctx_levels_2d:
                    levels.append({"table": ax, "level": l, "kind": "pg", "entries": int(ttl),
                                   "bits": float(bits_n)})
                    continue
                t = entropy.tables2d[l]
                pooled, covered, vq = entropy.pool_2d_level(
                    ent_params, tbl2, l, pg_n, plane, cache["bin2d"][ai], cache["mask2d"][ai],
                    0, t.n_entries, t.n_points, cache["mask2d_bits"][ai])
                levels.append({"table": ax, "level": l, "kind": "ctx",
                               "entries": t.n_entries, "features": tally(pooled, covered, vq)})
    return {"levels": levels, "totals": totals(levels, entropy.total_param_count)}


def level_sums(lv):
    """A context level's counts and bits summed over its features."""
    keys = COUNTS + ("bits",) + tuple(f"bits_{b}" for b in BANDS)
    return {k: sum(f[k] for f in lv["features"]) for k in keys}


def totals(levels, n_params):
    ctx = [level_sums(lv) for lv in levels if lv["kind"] == "ctx"]
    out = {k: sum(c[k] for c in ctx) for k in ctx[0]} if ctx else {}
    out["bits_pg"] = sum(lv["bits"] for lv in levels if lv["kind"] == "pg")
    out["bits_total"] = out.get("bits", 0.0) + out["bits_pg"]
    out["total_MB"] = out["bits_total"] / 8.0 / 1024.0 / 1024.0
    out["bits_per_param"] = out["bits_total"] / n_params
    return out


def census_of_trainer(trainer):
    """The census of a port Trainer's current state."""
    from cnc_torch.models import radiance_field as rf

    return census(trainer.entropy, trainer.ent_params,
                  rf.quantized_tables(trainer.field, trainer.cfg.model),
                  trainer.occ_state.binaries)


def summary_line(c):
    """One line of a census: the rate, the entry-features clipped against
    their symbol and the four bands' share of the context levels' bits."""
    t = c["totals"]
    share = " ".join(f"{b} {t[f'bits_{b}'] / max(t['bits'], 1e-30):.4f}" for b in BANDS)
    return (f"total {t['total_MB']:.4f} MB ({t['bits_per_param']:.4f} bits/param); "
            f"clipped {t['n_out']} (against {t['n_against']}) of {t['n']} entry-features; "
            f"bits by band: {share}")


TABLES = ("xyz", "xy", "xz", "yz")


def pack_state(ckpt_path, out_path):
    """A checkpoint's census inputs: each table's signs (x >= 0, the binary
    quantizer's +1) packed one bit a value with its shape, the context MLPs,
    the occupancy grid and the step."""
    import numpy as np

    with np.load(ckpt_path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files
               if k.startswith("ent|") or k in ("binaries", "bin_res", "step")}
        for t in TABLES:
            x = z[f"params|['{t}']"]
            out[f"sign|{t}"] = np.packbits((x >= 0).reshape(-1))
            out[f"shape|{t}"] = np.asarray(x.shape)
    np.savez_compressed(out_path, **out)
    return out_path


def load_state(path, entropy):
    """(ContextParams, binarized tables, occupancy grid, step) of a packed
    census state (`pack_state`) or a checkpoint of either package, on the
    entropy model's device."""
    import numpy as np
    import torch

    from cnc_torch.utils import checkpoint as ckpt

    dev = entropy.device
    with np.load(path, allow_pickle=False) as z:
        data = {k: z[k] for k in z.files if not k.startswith("opt")}
    tables = {}
    for t in TABLES:
        if f"sign|{t}" in data:
            shape = tuple(int(d) for d in data[f"shape|{t}"])
            bits = np.unpackbits(data[f"sign|{t}"])[:int(np.prod(shape))].reshape(shape)
            x = np.where(bits == 1, np.float32(1.0), np.float32(-1.0))
        else:
            x = np.where(data[f"params|['{t}']"] >= 0, np.float32(1.0), np.float32(-1.0))
        tables[t] = torch.from_numpy(x).to(dev)
    ent = entropy.ent_params_from_jax(ckpt._nest(data, "ent"))
    res = int(data["bin_res"])
    binaries = np.unpackbits(data["binaries"])[:res ** 3].reshape((res,) * 3).astype(bool)
    return ent, tables, torch.from_numpy(binaries).to(dev), int(data["step"])


def recorded_config():
    """cnc_tpu's recorded 2,000/20,000-step configuration, as
    tools/torch_pipeline_run.py's defaults build it."""
    import dataclasses

    from cnc_torch.config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig

    return CNCConfig(
        model=ModelConfig(),
        entropy=EntropyConfig(sample_num=100000, ctx_grad=False, v_ctx_cap=1 << 20),
        render=dataclasses.replace(RenderConfig(), sample_budget=65536),
        train=dataclasses.replace(TrainConfig(), lmbda=2e-3, rate_update_interval=4,
                                  target_sample_batch_size=65536, init_batch_size=1024,
                                  min_ray_bucket=1024, max_ray_bucket=1024))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", nargs="+", default=[],
                    help="checkpoints of either package, or packed census states")
    ap.add_argument("--pack", nargs="+", default=[],
                    help="checkpoints to pack into census states (numpy only)")
    ap.add_argument("--out", required=True,
                    help="the census as JSON (a directory with several --ckpt or --pack)")
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    args = ap.parse_args()
    many = len(args.ckpt) + len(args.pack) > 1

    def dest(src, ext):
        name = os.path.basename(src).replace(".npz", "") + ext
        return os.path.join(args.out, name) if many else args.out

    if many:
        os.makedirs(args.out, exist_ok=True)
    for src in args.pack:
        print(f"packed {src} into {pack_state(src, dest(src, '.npz'))}", flush=True)
    if not args.ckpt:
        return 0
    import torch

    from cnc_torch.train import driver

    t0 = time.time()
    entropy = driver.build_entropy(recorded_config(), device=args.device)
    build_s = time.time() - t0
    for src in args.ckpt:
        t1 = time.time()
        ent, tables, binaries, step = load_state(src, entropy)
        c = census(entropy, ent, tables, binaries)
        c.update(step=step, ckpt=os.path.basename(src), device=str(entropy.device),
                 torch=torch.__version__, build_s=round(build_s, 1),
                 census_s=round(time.time() - t1, 1))
        out = dest(src, ".json")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump(c, fh)
        print(f"census of {src} (step {step}, {c['census_s']} s): {summary_line(c)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
