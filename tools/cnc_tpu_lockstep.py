#!/usr/bin/env python3
"""Both packages' training step in lockstep on the CPU, and cnc_tpu's side
of the rate census.

`lockstep(jtr, ttr, n_steps)` drives cnc_tpu's `Trainer` and the port's
from cnc_tpu's state, one step at a time, as cnc_tpu's `fit` orders it:

1. the port takes cnc_tpu's whole state (a checkpoint written by cnc_tpu
   and read by the port: parameters, both optimizers' moments and counts,
   the occupancy grid, the step and the ray count);
2. every `occ_update_interval` steps both update the occupancy grid, the
   port with cnc_tpu's draws injected (`_update_from_draws`); the grids
   must agree (binaries exactly, occs within 1e-6), then both refresh the
   rate's cache;
3. both take one step on the same rays and pixels (cnc_tpu's `_fetch`), the
   same jitter and, at a rate step, the same entry windows, all from
   cnc_tpu's keys; before the step, at a rate step, both packages' census
   of the state (`tools/torch_basin_census.py` against `cnc_tpu_census`).

Every step is held to `tests/test_torch_train_rate.py`'s one-step
tolerances: the same samples marched and mse 1e-6 relative; at a rate step
also the estimated rate 1e-4 relative, every parameter's gradient within
1e-4 of its largest entry, and the census's counts exactly and its bits
1e-4 relative.  At a render-only step the largest gradient error is
recorded, not held (the render tests hold it at their own shapes).  Each step
starts from cnc_tpu's state again, so the first quantity out of tolerance
names the term where the port departs, undisturbed by the drift of earlier
steps.  It runs on the CPU only and imports both packages.

    python3 tools/cnc_tpu_lockstep.py --ckpt CNC_TPU_CKPT.npz --steps 40

runs it at cnc_tpu's recorded configuration from a cnc_tpu checkpoint
(`tools/cnc_tpu_basin_run.py` writes them).  At full width both packages'
models sit in one process on the CPU; it has been run at the tests' tiny
configuration only (`tests/test_torch_basin_census.py`).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tools"))

MSE_RTOL, RATE_RTOL, GRAD_TOL, OCC_ATOL, CENSUS_RTOL = 1e-6, 1e-4, 1e-4, 1e-6, 1e-4


def _jax_cpu():
    import jax

    if jax.config.jax_platforms != "cpu":
        import jax.extend.backend as jax_backend
        jax.config.update("jax_platforms", "cpu")
        jax_backend.clear_backends()
    return jax


def starts_from_key(tctx, key):
    """The entry-window starts cnc_tpu's rate terms draw from `key`, as the
    port's `starts` (tests/test_torch_context_tables.py's copy)."""
    import jax

    k3 = jax.random.fold_in(key, 7)
    u = lambda k: np.asarray(jax.random.uniform(k))
    s3 = {l: tctx.start_from_uniform(tctx.tables3d[l], u(jax.random.fold_in(k3, l)))
          for l in tctx.ctx_levels_3d}
    s2 = {(ai, l): tctx.start_from_uniform(tctx.tables2d[l],
                                           u(jax.random.fold_in(key, 100 + 10 * ai + l)))
          for ai in range(3) for l in tctx.ctx_levels_2d}
    return {"3d": s3, "2d": s2}


def occ_draws(key, warmup, cells, count):
    """The draws cnc_tpu's `update_occ_grid` makes from `key`."""
    import jax

    k_sel, k_jit = jax.random.split(key)
    if warmup:
        return dict(cell_jitter=np.array(jax.random.uniform(k_jit, (cells, 3))))
    n = cells // 4
    k_u, k_o = jax.random.split(k_sel)
    return dict(cell_jitter=np.array(jax.random.uniform(k_jit, (2 * n, 3))),
                uniform_idx=np.array(jax.random.randint(k_u, (n,), 0, cells)),
                occ_draw=np.array(jax.random.randint(k_o, (n,), 0, max(count, 1))))


# --------------------------------------------------------------- the census
def tally_np(pooled, covered, values_q):
    """tools/torch_basin_census.py's `tally` in numpy float32 on cnc_tpu's
    pool outputs."""
    eps = np.float32(1e-6)
    cov = np.asarray(covered)
    p = np.asarray(pooled, np.float32)[cov]
    x = np.asarray(values_q, np.float32)[cov]
    pc = np.clip(p, eps, np.float32(1.0) - eps)
    inv = np.float32(1.4426950408889634)
    bits = ((-np.log(pc) * inv) * ((1 + x) / 2) + (-np.log1p(-pc) * inv) * ((1 - x) / 2))
    lo, hi = p < eps, p > np.float32(1.0) - eps
    against = (lo & (x > 0)) | (hi & (x < 0))
    band = {"lt1": ~against & (bits < 1), "gt5": ~against & (bits > 5), "against": against}
    band["1to5"] = ~against & ~band["lt1"] & ~band["gt5"]
    b64 = bits.astype(np.float64)
    out = []
    for f in range(p.shape[1]):
        d = {"n": int(p.shape[0]), "n_lo": int(lo[:, f].sum()), "n_hi": int(hi[:, f].sum()),
             "n_out": int((lo | hi)[:, f].sum()), "n_against": int(against[:, f].sum()),
             "bits": float(b64[:, f].sum())}
        for name, m in band.items():
            d[f"n_{name}"] = int(m[:, f].sum())
            d[f"bits_{name}"] = float(b64[:, f][m[:, f]].sum())
        out.append(d)
    return out


def cnc_tpu_census(jctx, ent_params, tables, jcache, chunks=None):
    """The census of a cnc_tpu state through cnc_tpu's own float pools
    (`pool_3d_level`, `pool_2d_level`) and the full frac planes: the same
    dict as the port's `census`.  `tables` are the binarized tables;
    `chunks` maps a 3D level to its (chunk_e, w, [(lo, hi, start), ...]);
    without it each level is pooled in one window."""
    import jax.numpy as jnp

    from cnc_tpu.ops import entropy as jent
    from torch_basin_census import add_into, totals

    tb = {k: jnp.asarray(v) for k, v in tables.items()}
    levels = []
    spec3, spec2 = jctx.spec3, jctx.spec2
    for l in range(spec3.n_levels):
        o = spec3.offsets[l]
        pg_n, bits_n, ttl = jent.global_pg_bits(tb["xyz"][o:o + spec3.level_sizes[l]])
        if l not in jctx.ctx_levels_3d:
            levels.append({"table": "xyz", "level": l, "kind": "pg", "entries": int(ttl),
                           "bits": float(bits_n)})
            continue
        t = jctx.tables3d[l]
        chunk_e, w, bounds = (chunks[l] if chunks else
                              (t.n_entries, t.n_vertices, [(0, t.n_entries, 0)]))
        acc = None
        for lo, hi, start in bounds:
            pooled, covered, vq = jctx.pool_3d_level(ent_params, tb["xyz"], jcache, l, pg_n,
                                                     jnp.int32(start), chunk_e, w)
            keep = slice(lo - start, hi - start)
            acc = add_into(acc, tally_np(np.asarray(pooled)[keep], np.asarray(covered)[keep],
                                         np.asarray(vq)[keep]))
        levels.append({"table": "xyz", "level": l, "kind": "ctx", "entries": t.n_entries,
                       "features": acc})
    for ai, ax in enumerate(("xy", "xz", "yz")):
        plane = (jctx.pn_frac_plane(tb["xyz"], jcache["pn"][ax])
                 if jctx.cfg.use_dimension_wise else None)
        for l in range(spec2.n_levels):
            o = spec2.offsets[l]
            pg_n, bits_n, ttl = jent.global_pg_bits(tb[ax][o:o + spec2.level_sizes[l]])
            if l not in jctx.ctx_levels_2d:
                levels.append({"table": ax, "level": l, "kind": "pg", "entries": int(ttl),
                               "bits": float(bits_n)})
                continue
            t = jctx.tables2d[l]
            pooled, covered, vq = jctx.pool_2d_level(
                ent_params, tb[ax], l, pg_n, plane, jcache["bin2d"][ai], jcache["mask2d"][ai],
                jnp.int32(0), t.n_entries, t.n_points)
            levels.append({"table": ax, "level": l, "kind": "ctx", "entries": t.n_entries,
                           "features": tally_np(pooled, covered, vq)})
    return {"levels": levels, "totals": totals(levels, jctx.total_param_count)}


def compare_census(got, want, rtol=CENSUS_RTOL):
    """The first disagreement between two censuses (counts exact, bits
    within rtol of the larger of the two and 1e-3 bits), or None."""
    for a, b in zip(got["levels"], want["levels"]):
        name = f"{a['table']} level {a['level']}"
        if (a["table"], a["level"], a["kind"]) != (b["table"], b["level"], b["kind"]):
            return f"{name}: levels differ"
        pairs = ([({"bits": a["bits"]}, {"bits": b["bits"]})] if a["kind"] == "pg"
                 else list(zip(a["features"], b["features"])))
        for f, (x, y) in enumerate(pairs):
            for k in x:
                if k.startswith("n"):
                    if x[k] != y[k]:
                        return f"{name} feature {f}: {k} {x[k]} != {y[k]}"
                elif abs(x[k] - y[k]) > rtol * max(abs(x[k]), abs(y[k]), 1e-3 / rtol):
                    return f"{name} feature {f}: {k} {x[k]} vs {y[k]}"
    return None


# ------------------------------------------------------------- the lockstep
def _sync(jtr, ttr, tmp):
    from cnc_tpu.utils import checkpoint as jckpt
    from cnc_torch.utils import checkpoint as tckpt

    jckpt.save_checkpoint(tmp, jtr)
    tckpt.load_checkpoint(tmp, ttr, log_fn=lambda *a: None)


def _grad_errors(jgrads, ttr):
    """Per parameter: max |port grad - cnc_tpu grad| / max |cnc_tpu grad|."""
    out = {}
    tparams = {"rf": dict(ttr.field.named_parameters()),
               "ent": dict(ttr.ent_params.named_parameters()) if ttr.ent_params else {}}
    import jax

    for top, tree in jgrads.items():
        for path, g in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [getattr(p, "key", None) for p in path]
            name = ("tables." + keys[0] if top == "rf" and len(keys) == 1
                    else ".".join(keys))
            g = np.asarray(g)
            tg = tparams[top][name].grad
            tg = np.zeros_like(g) if tg is None else tg.detach().cpu().numpy()
            scale = np.abs(g).max()
            out[f"{top}/{name}"] = float(np.abs(tg - g).max() / scale) if scale > 0 else (
                0.0 if np.abs(tg).max() == 0 else float("inf"))
    return out


def lockstep(jtr, ttr, n_steps, log=print, census=True, chunks=None):
    """Drive both trainers n_steps from cnc_tpu's current state (see the
    module docstring).  Returns (records, first): one record a step, and the
    first quantity out of tolerance as a string (None when every step held)."""
    import jax
    import jax.numpy as jnp
    import torch

    from cnc_tpu.train.trainer import _next_bucket
    from cnc_torch.grids import occupancy as tocc
    from cnc_torch.models import radiance_field as trf
    from torch_basin_census import census as port_census

    cfg = jtr.cfg
    bkgd = jnp.ones((3,))
    records = []
    jcache = tcache = None
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "sync.npz")
        for i in range(n_steps):
            s = jtr.step
            rec = {"step": s}
            records.append(rec)
            _sync(jtr, ttr, tmp)
            assert ttr.step == s
            jtr.key, k_occ, k_rays, k_step = jax.random.split(jtr.key, 4)
            if s % cfg.render.occ_update_interval == 0 or i == 0:
                warm = s < cfg.render.occ_warmup_steps
                count = int(np.asarray(jtr.occ_state.binaries).sum())
                draws = occ_draws(k_occ, warm, jtr.occ_state.occs.shape[0], count)
                jtr.occ_state = jtr._occ_step(warm)(jtr.params, jtr.occ_state, k_occ)
                with torch.no_grad():
                    ttr.occ_state = tocc._update_from_draws(
                        ttr.occ_state, ttr._occ_eval_fn, ttr.cfg.render,
                        **{k: torch.from_numpy(v) for k, v in draws.items()})
                jb = np.asarray(jtr.occ_state.binaries)
                if not np.array_equal(ttr.occ_state.binaries.cpu().numpy(), jb):
                    return records, f"step {s}: occupancy binaries differ"
                occ_err = float(np.abs(ttr.occ_state.occs.cpu().numpy()
                                       - np.asarray(jtr.occ_state.occs)).max())
                rec["occ_err"] = occ_err
                if occ_err > OCC_ATOL:
                    return records, f"step {s}: occupancy occs {occ_err:.3g} > {OCC_ATOL}"
                if jtr.entropy is not None:
                    jcache = jtr.entropy.refresh_cache(jtr.occ_state.binaries, jcache)
                    tcache = ttr.entropy.refresh_cache(ttr.occ_state.binaries)
            bucket = _next_bucket(jtr.num_rays, cfg.train.min_ray_bucket,
                                  cfg.train.max_ray_bucket, 1)
            rays, pixels = jtr._fetch(bucket, k_rays)
            o, d, pix = (np.asarray(a) for a in (rays.origins, rays.viewdirs, pixels))
            use_rate = (jtr.entropy is not None and cfg.train.lmbda > 0
                        and s % cfg.train.rate_update_interval == 0)
            rec["rate_step"] = use_rate
            if use_rate and census:
                jt = jax.tree.map(np.asarray, jtr.params)
                from cnc_tpu.models import radiance_field as jrf
                jtabs = {k: np.asarray(v) for k, v in
                         jrf.quantized_tables(jtr.params, cfg.model).items()}
                want = cnc_tpu_census(jtr.entropy, jtr.ent_params, jtabs, jcache, chunks)
                got = port_census(ttr.entropy, ttr.ent_params,
                                  trf.quantized_tables(ttr.field, ttr.cfg.model),
                                  ttr.occ_state.binaries, cache=tcache)
                rec["census_MB"] = (got["totals"]["total_MB"], want["totals"]["total_MB"])
                rec["census_against"] = (got["totals"]["n_against"],
                                         want["totals"]["n_against"])
                bad = compare_census(got, want)
                del jt
                if bad:
                    return records, f"step {s}: census {bad}"
            # cnc_tpu's gradients as its `_train_step` sums them
            g_rf, _ = jtr._render_grad_fn(bucket)(jtr.params, jtr.occ_state.binaries,
                                                  rays.origins, rays.viewdirs, pixels, bkgd,
                                                  k_step)
            jgrads = {"rf": g_rf}
            if use_rate:
                scale = jtr._rate_scale()
                (g2, ge2), _ = jtr._rate2d_grad_fn()(jtr.params, jtr.ent_params, scale, k_step,
                                                     jcache, jtr.entropy.table_arrays)
                (g3, ge3), _ = jtr._rate3d_grad_fn()(jtr.params, jtr.ent_params, scale, k_step,
                                                     jcache, jtr.entropy.table_arrays)
                jgrads = {"rf": jax.tree.map(lambda a, b, c: a + b + c, g_rf, g2, g3),
                          "ent": jax.tree.map(jnp.add, ge2, ge3)}
            jaux = jtr._train_step(bucket, rays, pixels, bkgd, k_step, jcache)
            u = np.array(jax.random.uniform(k_step, (o.shape[0],)))
            kw = dict(jitter=torch.from_numpy(u), ent_cache=tcache)
            if use_rate:
                kw["starts"] = starts_from_key(ttr.entropy, k_step)
            taux = ttr._train_step(torch.from_numpy(o.copy()), torch.from_numpy(d.copy()),
                                   torch.from_numpy(pix.copy()), torch.ones(3), **kw)
            jtr.num_rays = int(bucket * (cfg.train.target_sample_batch_size
                                         / max(float(jaux["n_marched"]), 1.0)))
            jtr.step += 1
            rec["n_marched"] = (int(taux["n_marched"]), int(jaux["n_marched"]))
            if rec["n_marched"][0] != rec["n_marched"][1]:
                return records, f"step {s}: samples marched {rec['n_marched']}"
            rec["mse"] = (float(taux["mse"]), float(jaux["mse"]))
            if abs(rec["mse"][0] - rec["mse"][1]) > MSE_RTOL * abs(rec["mse"][1]):
                return records, f"step {s}: mse {rec['mse']}"
            if use_rate:
                for k in ("bits_per_param", "embed_MB", "ctx_util"):
                    rec[k] = (float(taux[k]), float(jaux[k]))
                    if abs(rec[k][0] - rec[k][1]) > RATE_RTOL * abs(rec[k][1]):
                        return records, f"step {s}: {k} {rec[k]}"
            errs = _grad_errors(jgrads, ttr)
            rec["grad_err"] = max(errs.values())
            worst = max(errs, key=errs.get)
            rec["grad_worst"] = worst
            if use_rate and errs[worst] > GRAD_TOL:
                return records, f"step {s}: gradient of {worst} {errs[worst]:.3g} > {GRAD_TOL}"
            log(f"step {s}: held ({json.dumps(rec)})")
    return records, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True, help="a cnc_tpu checkpoint at the recorded "
                    "configuration (tools/cnc_tpu_basin_run.py)")
    ap.add_argument("--seed", type=int, default=42, help="the run's seed (its key stream)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--out", default=None, help="the records as JSON")
    args = ap.parse_args()
    _jax_cpu()
    import dataclasses

    from cnc_tpu.config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig
    from cnc_tpu.data.scenes import ProceduralDataset
    from cnc_tpu.train import driver as jdriver
    from cnc_tpu.train.trainer import Trainer as JTrainer
    from cnc_tpu.utils import checkpoint as jckpt
    from cnc_torch.codec.codec import CNCCodec
    from cnc_torch.train import driver as tdriver
    from cnc_torch.train.trainer import Trainer as TTrainer
    from torch_basin_census import recorded_config

    tcfg = dataclasses.replace(recorded_config(), train=dataclasses.replace(
        recorded_config().train, seed=args.seed))
    jcfg = CNCConfig(
        model=ModelConfig(),
        entropy=EntropyConfig(sample_num=100000, ctx_grad=False, v_ctx_cap=1 << 20),
        render=dataclasses.replace(RenderConfig(), sample_budget=65536),
        train=dataclasses.replace(TrainConfig(), lmbda=2e-3, rate_update_interval=4,
                                  seed=args.seed, target_sample_batch_size=65536,
                                  init_batch_size=1024, min_ray_bucket=1024,
                                  max_ray_bucket=1024))
    ds = ProceduralDataset("blocks", n_images=24, width=256, height=256, split="train")
    jtr = JTrainer(jcfg, ds, entropy=jdriver.build_entropy(jcfg))
    jckpt.load_checkpoint(args.ckpt, jtr)
    ttr = TTrainer(tcfg, None, entropy=tdriver.build_entropy(tcfg, device="cpu"), device="cpu")
    codec = CNCCodec(ttr.entropy)
    chunks = {l: (codec.chunks3d[l][0], codec.chunks3d[l][2], codec._chunk_bounds(l))
              for l in ttr.entropy.ctx_levels_3d}
    t0 = time.time()
    records, first = lockstep(jtr, ttr, args.steps, chunks=chunks)
    print(json.dumps({"first_out_of_tolerance": first, "steps": len(records),
                      "seconds": round(time.time() - t0, 1)}))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"records": records, "first": first}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
