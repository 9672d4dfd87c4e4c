#!/usr/bin/env python3
"""cnc_tpu at its recorded 2,000/20,000-step configuration on the CPU, with
the rate trace and checkpoints a basin count needs.

The configuration is tools/torch_pipeline_run.py's defaults, which are
cnc_tpu's recorded rows' (tools/overnight_r5.sh:47-51): lambda 2e-3, the
rate every 4 steps, no gradient through the context lookups, 1,024 rays a
step, a 65,536-sample budget, v_ctx_cap 2^20, sample_num 100,000, on
ProceduralDataset("blocks") with 24 train views at 256x256.  The run
trains cnc_tpu's own `Trainer.fit` from `Trainer(cfg, ...)` at --seed,
records the estimated rate (embed_MB, bits_per_param) every --trace_every
steps, copies the checkpoint `fit` writes at each step of --ckpt_at to
<ckpt_dir>/ckpt_s<seed>_<step>.npz, packs each into its census state
(tools/torch_basin_census.py --pack: the tables' signs, the context MLPs,
the occupancy grid; about 2 MB) under <out_root>/state/, and appends one
line to <out_root>/summary.jsonl.  No evaluation or encode follows.

    python3 tools/cnc_tpu_basin_run.py --seed 0 --out_root runs_basin_r \
        --ckpt_dir runs_basin_r/ckpt [--census 1]

With --census 1 it then runs tools/torch_basin_census.py on each
checkpoint (the port's pooling, on the CPU) in a child process and adds
the census files to the line.  `--census_only 1` runs only that step on
checkpoints an earlier run left.  The census of the packed states can as
well run on the card: `python3 tools/torch_basin_census.py --ckpt
<out_root>/state/*.npz --out DIR`.  A full-width checkpoint is about 240 MB;
keep --ckpt_dir out of the tree.  It runs on the CPU only (JAX is pointed
at the host): 12.7 GB at its peak (the entropy tables' build), then about
8 GB; 1,000 steps took 54-95 minutes on eight shared cores, with one to
three other runs beside it.
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

_T0 = time.time()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def log(*a):
    print(f"[{time.time() - _T0:8.1f}s]", *a, flush=True)


def basin(trace, lo=900, hi=1000, every=20, upper_mb=2.8):
    """(median estimated MB over the readings at lo, lo + every, ..., hi,
    "upper" or "lower"): the basin rule of PERF.md §6 (PR 19)."""
    import numpy as np

    vals = [mb for s, mb, _ in trace if lo <= s <= hi and (s - lo) % every == 0]
    if len(vals) != (hi - lo) // every + 1:
        return None, "incomplete"
    med = float(np.median(vals))
    return med, "upper" if med > upper_mb else "lower"


def ckpt_file(ckpt_dir, seed, step):
    return os.path.join(ckpt_dir, f"ckpt_s{seed}_{step}.npz")


def run_census(files, out_root, seed, threads):
    """tools/torch_basin_census.py on each checkpoint, one child process
    each (torch on the CPU); returns the census files written."""
    out = []
    for f in files:
        dst = os.path.join(out_root, "census",
                           os.path.basename(f).replace(".npz", ".json"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        cmd = [sys.executable, os.path.join(_ROOT, "tools", "torch_basin_census.py"),
               "--ckpt", f, "--device", "cpu", "--out", dst]
        log("census:", " ".join(cmd))
        subprocess.run(cmd, check=True, env=env)
        out.append(dst)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--max_steps", type=int, default=1000)
    ap.add_argument("--trace_every", type=int, default=20)
    ap.add_argument("--ckpt_at", type=str, default="250,500,1000")
    ap.add_argument("--out_root", type=str, default="runs_basin_r")
    ap.add_argument("--ckpt_dir", type=str, default=None, help="default: <out_root>/ckpt")
    ap.add_argument("--census", type=int, default=0)
    ap.add_argument("--census_only", type=int, default=0)
    ap.add_argument("--census_threads", type=int, default=8)
    args = ap.parse_args()
    ckpt_at = sorted(int(s) for s in args.ckpt_at.split(",") if s)
    ckpt_dir = args.ckpt_dir or os.path.join(args.out_root, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.makedirs(args.out_root, exist_ok=True)
    if args.census_only:
        files = [ckpt_file(ckpt_dir, args.seed, s) for s in ckpt_at]
        run_census([f for f in files if os.path.exists(f)], args.out_root, args.seed,
                   args.census_threads)
        return 0

    import jax
    if jax.config.jax_platforms != "cpu":
        import jax.extend.backend as jax_backend
        jax.config.update("jax_platforms", "cpu")
        jax_backend.clear_backends()

    from cnc_tpu.config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig
    from cnc_tpu.data.scenes import ProceduralDataset
    from cnc_tpu.train import driver
    from cnc_tpu.train.trainer import Trainer
    sys.path.insert(0, os.path.join(_ROOT, "tools"))
    from torch_basin_census import pack_state

    base_ck = os.path.join(ckpt_dir, f"ckpt_s{args.seed}_latest.npz")
    every = ckpt_at[0]
    for s in ckpt_at:
        if s % every:
            raise SystemExit(f"--ckpt_at {args.ckpt_at}: each step must be a multiple of "
                             f"the first")
    cfg = CNCConfig(
        model=ModelConfig(),
        entropy=EntropyConfig(sample_num=100000, ctx_grad=False, v_ctx_cap=1 << 20),
        render=dataclasses.replace(RenderConfig(), sample_budget=65536),
        train=dataclasses.replace(TrainConfig(), lmbda=2e-3, rate_update_interval=4,
                                  max_steps=args.max_steps, seed=args.seed,
                                  target_sample_batch_size=65536, init_batch_size=1024,
                                  min_ray_bucket=1024, max_ray_bucket=1024,
                                  checkpoint_path=base_ck, checkpoint_every=every))
    log(f"seed {args.seed}: devices {jax.devices()}")
    train_ds = ProceduralDataset("blocks", n_images=24, width=256, height=256, split="train")
    t0 = time.time()
    entropy = driver.build_entropy(cfg)
    trainer = Trainer(cfg, train_ds, entropy=entropy)
    if trainer.step:
        raise SystemExit(f"{base_ck} exists: this tool does not resume; remove it")
    log(f"entropy model and trainer ready in {time.time() - t0:.1f} s")

    trace, kept = [], []
    step_fn = trainer._train_step

    def traced_step(*a, **kw):
        aux = step_fn(*a, **kw)
        s = trainer.step
        if s % args.trace_every == 0 and "embed_MB" in aux:
            trace.append([s, float(aux["embed_MB"]), float(aux["bits_per_param"])])
        return aux

    trainer._train_step = traced_step          # fit calls it through the instance

    def on_step(s):
        if s in ckpt_at:                       # fit saved step s to base_ck just now
            dst = ckpt_file(ckpt_dir, args.seed, s)
            shutil.copyfile(base_ck, dst)
            kept.append(dst)
            os.makedirs(os.path.join(args.out_root, "state"), exist_ok=True)
            pack_state(dst, os.path.join(args.out_root, "state", os.path.basename(dst)))
            log(f"step {s}: checkpoint {dst}; rate {trace[-1][1]:.4f} MB")

    t_fit = time.time()
    trainer.fit(args.max_steps, log_every=100, log_fn=log, step_callback=on_step)
    train_s = time.time() - t_fit
    if os.path.exists(base_ck):
        os.remove(base_ck)
    med, which = basin(trace)
    rec = {"package": "cnc_tpu", "device": "cpu", "seed": args.seed,
           "steps": args.max_steps, "train_s": round(train_s, 1),
           "step_s": round(train_s / (args.max_steps + 1), 4),
           "median_MB_900_1000": med, "basin": which, "checkpoints": kept,
           "rate_trace": trace}
    del trainer, entropy
    if args.census:
        rec["census"] = run_census(kept, args.out_root, args.seed, args.census_threads)
    with open(os.path.join(args.out_root, "summary.jsonl"), "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    log(f"seed {args.seed} done: median {med} MB, {which}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
