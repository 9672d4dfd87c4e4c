#!/usr/bin/env python3
"""One rate-distortion point of the port's pipeline, resumable across runs.

The port's counterpart of one point of `tools/rd_sweep_depth.py`: train,
evaluate, encode, decode, evaluate again, quantize the MLPs and append the
TSV row, through `cnc_torch.train.driver.run_with_trainer`, on the card.
The defaults are the configuration of cnc_tpu's recorded 2,000- and
20,000-step rows (tools/overnight_r5.sh:47-51; runs_20k/bitstreams/
l0.002_k4/meta.json): lambda 2e-3, the rate every 4 steps, no gradient
through the context lookups, 1,024 rays a step, a 65,536-sample budget,
v_ctx_cap 2^20, sample_num 100,000, on ProceduralDataset("blocks") with 24
train and 8 test views at 256x256, one test view evaluated.

    python3 tools/torch_pipeline_run.py --max_steps 2000 --seed 0 \
        --out_root runs_torch

With --init cnc_tpu the field and context MLPs start from cnc_tpu's own
initial draws at the seed (`Trainer.start_from_cnc_tpu`, drawn in numpy
without JAX) instead of the port's; nothing else changes.  The estimated
rate is traced every --trace_every steps (at rate steps), and with
--census_at S1,S2,... the census of tools/torch_basin_census.py is taken
after those steps' updates (one JSON file a step under <out_root>/census/,
its totals in the summary line).

The run checkpoints every --checkpoint_every steps to
<ckpt_dir>/ckpt_<tag>.npz (about 250 MB at full width).  With --deadline_s
it stops at the first checkpoint after which the time left (from process
start) falls below --margin_s, and exits 0; running the same command again
resumes from that file.  As in cnc_tpu, a checkpoint written after step s's
update records step s, so the resumed run takes step s again.  When the
point completes, a line with the keys of runs_20k/summary.jsonl (plus the
seed, the init, the card, the TSV row, the estimated rate trace and the
census totals) is appended to <out_root>/summary.jsonl and the checkpoint
is deleted.  The census's seconds are left out of train_s and step_s.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

_T0 = time.time()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(f"[{time.time() - _T0:8.1f}s]", *a, flush=True)


class _Deadline(Exception):
    pass


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lmbda", type=float, default=2e-3)
    ap.add_argument("--interval", type=int, default=4, help="rate_update_interval K")
    ap.add_argument("--ctx_grad", type=int, default=0)
    ap.add_argument("--pin_bucket", type=int, default=1024,
                    help="pin the ray bucket (min == max == init); 0 = dynamic batching")
    ap.add_argument("--sample_budget", type=int, default=65536,
                    help="per-step sample budget and target (0 = the default 2^18)")
    ap.add_argument("--v_ctx_cap", type=int, default=1 << 20, help="0 = the default 2^21")
    ap.add_argument("--max_steps", type=int, default=2000)
    ap.add_argument("--init", choices=("port", "cnc_tpu"), default="port",
                    help="the initial field and context MLPs: the port's draws or cnc_tpu's")
    ap.add_argument("--trace_every", type=int, default=500,
                    help="record the estimated rate every N steps (at rate steps)")
    ap.add_argument("--census_at", type=str, default="",
                    help="steps after which to take the rate census, e.g. 0,250,500,1000")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--checkpoint_every", type=int, default=1000)
    ap.add_argument("--out_root", type=str, default="runs_torch")
    ap.add_argument("--ckpt_dir", type=str, default=None, help="default: --out_root")
    ap.add_argument("--deadline_s", type=float, default=1e9,
                    help="wall budget from process start")
    ap.add_argument("--margin_s", type=float, default=300.0,
                    help="stop at a checkpoint once less than this is left of the budget")
    args = ap.parse_args()

    import torch

    from cnc_torch.config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig
    from cnc_torch.data.scenes import ProceduralDataset
    from cnc_torch.train import driver
    from cnc_torch.train.trainer import Trainer
    from cnc_torch.utils.device import resolve_device
    from torch_basin_census import census_of_trainer, summary_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device()
    tag = f"l{args.lmbda:g}_k{args.interval}_s{args.seed}" + (
        "_cnc_tpu_init" if args.init == "cnc_tpu" else "")
    census_at = {int(x) for x in args.census_at.split(",") if x}
    ckpt_dir = args.ckpt_dir or args.out_root
    ck = os.path.join(ckpt_dir, f"ckpt_{tag}.npz")
    side = ck[:-len(".npz")] + ".json"   # train seconds and steps of earlier runs
    render_kw, train_kw = {}, dict(lmbda=args.lmbda, rate_update_interval=args.interval,
                                   max_steps=args.max_steps, seed=args.seed,
                                   checkpoint_path=ck, checkpoint_every=args.checkpoint_every)
    if args.sample_budget:
        render_kw["sample_budget"] = args.sample_budget
        train_kw["target_sample_batch_size"] = args.sample_budget
    if args.pin_bucket:
        train_kw.update(init_batch_size=args.pin_bucket, min_ray_bucket=args.pin_bucket,
                        max_ray_bucket=args.pin_bucket)
    cfg = CNCConfig(
        model=ModelConfig(),
        # rd_sweep_depth.py's default sample_num, which the recorded rows used
        entropy=EntropyConfig(sample_num=100000, ctx_grad=bool(args.ctx_grad),
                              **({"v_ctx_cap": args.v_ctx_cap} if args.v_ctx_cap else {})),
        render=dataclasses.replace(RenderConfig(), **render_kw),
        train=dataclasses.replace(TrainConfig(), **train_kw))
    card_line = card()
    log(f"point {tag}: card {card_line}; torch {torch.__version__}; device {dev}")

    train_ds = ProceduralDataset("blocks", n_images=24, width=256, height=256, split="train",
                                 device=dev)
    test_ds = ProceduralDataset("blocks", n_images=8, width=256, height=256, split="test",
                                device=dev)
    t0 = time.time()
    entropy = driver.build_entropy(cfg, device=dev) if args.lmbda > 0 else None
    trainer = Trainer(cfg, train_ds, entropy=entropy, device=dev)
    init_s = None
    if args.init == "cnc_tpu" and trainer.step == 0:
        t_init = time.time()
        trainer.start_from_cnc_tpu()
        init_s = time.time() - t_init
        log(f"cnc_tpu's initial state drawn and loaded in {init_s:.2f} s")
    prior = {"train_s": 0.0, "steps_run": 0, "runs": 0, "rate_trace": [], "census": {}}
    if os.path.exists(side) and trainer.step > 0:
        with open(side) as fh:
            prior = json.load(fh)
    log(f"entropy model and trainer ready in {time.time() - t0:.1f} s; starting at step "
        f"{trainer.step}" + (f" (resumed from {ck}; {prior['runs']} earlier runs)"
                             if trainer.step else ""))

    trace = prior["rate_trace"]
    censuses = prior.setdefault("census", {})
    steps_here = [0]
    census_s = [0.0]
    t_fit = time.time()

    def record():
        return {"train_s": prior["train_s"] + time.time() - t_fit - census_s[0],
                "steps_run": prior["steps_run"] + steps_here[0], "runs": prior["runs"] + 1,
                "rate_trace": trace, "census": censuses}

    def on_step(s, aux):
        steps_here[0] += 1
        if s % args.trace_every == 0 and "embed_MB" in aux:
            trace.append([s, float(aux["embed_MB"]), float(aux["bits_per_param"])])
        if s in census_at and args.lmbda > 0:
            t_c = time.time()
            c = census_of_trainer(trainer)
            c["step"], c["census_s"] = s, round(time.time() - t_c, 2)
            census_s[0] += time.time() - t_c
            os.makedirs(os.path.join(args.out_root, "census"), exist_ok=True)
            with open(os.path.join(args.out_root, "census", f"{tag}_{s}.json"), "w") as fh:
                json.dump(c, fh)
            censuses[str(s)] = {**c["totals"], "census_s": c["census_s"]}
            log(f"census at step {s} ({c['census_s']} s): {summary_line(c)}")
        if s > 0 and s % args.checkpoint_every == 0:      # fit saved step s just now
            with open(side, "w") as fh:
                json.dump(record(), fh)
            left = args.deadline_s - (time.time() - _T0)
            if left < args.margin_s and s < args.max_steps:
                raise _Deadline(s)

    try:
        trainer.fit(args.max_steps, log_every=200, log_fn=log, step_callback=on_step)
    except _Deadline as stop:
        log(f"deadline: stopped after the checkpoint at step {stop.args[0]} ({ck}); run the "
            f"same command again to resume")
        return 0
    totals = record()
    t_tail = time.time()
    res = driver.run_with_trainer(trainer, test_ds, scene=tag, out_root=args.out_root,
                                  max_steps=args.max_steps, max_eval_images=1, log_fn=log)
    res = dataclasses.replace(res, elapsed_train_s=totals["train_s"])
    row = driver.append_result_row(res, tag, "Procedural_depth", out_root=args.out_root)
    rec = {
        "lmbda": args.lmbda, "interval": args.interval, "ctx_grad": bool(args.ctx_grad),
        "visible_frac": None, "steps": args.max_steps,
        "psnr": round(res.psnr, 4), "psnr_codec": round(res.psnr_codec, 4),
        "delta_codec_db": round(res.psnr_codec - res.psnr, 4),
        "embed_MB_est": round(res.embed_MB_est, 4),
        "embed_MB_codec": round(res.embed_MB_codec, 4),
        "total_MB": round(res.total_size_MB(), 4),
        "compression_x": round(res.compression_x(), 2),
        "ssim": round(res.ssim, 4), "ssim_codec": round(res.ssim_codec, 4),
        "psnr_mlp_q13": round(res.quant_results[0]["psnr"], 4),
        "train_s": round(totals["train_s"], 1), "encode_s": round(res.encode_s, 1),
        "decode_s": round(res.decode_s, 1),
        "step_s": round(totals["train_s"] / max(totals["steps_run"], 1), 5),
        "wall_s": round(totals["train_s"] + time.time() - t_tail, 1),
        "seed": args.seed, "init": args.init, "init_draw_s": init_s,
        "steps_run": totals["steps_run"], "runs": totals["runs"],
        "card": card_line, "rate_trace": trace, "census": censuses, "tsv_row": row}
    os.makedirs(args.out_root, exist_ok=True)
    with open(os.path.join(args.out_root, "summary.jsonl"), "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    for f in (ck, side):
        if os.path.exists(f):
            os.remove(f)     # the summary row supersedes the checkpoint
    log("point done:", json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
