#!/usr/bin/env python3
"""A/B of cnc_torch's codec pools, frac planes (K7i) and table build between
trees, on one NVIDIA GPU, on cnc_tpu's committed 20,000-step bundle; and a
bundle's PSNR on either device.

    python3 tools/torch_codec_ab.py prepare WORK
    python3 tools/torch_codec_ab.py time WORK TREE LABEL >> LOG
    python3 tools/torch_codec_ab.py summary LOG
    python3 tools/torch_codec_ab.py psnr BUNDLE DEVICE

`prepare` decodes BUNDLE (runs_20k/bitstreams/l0.002_k4) once with this
tree's cnc_torch on the card (every stream's sha256 checked by the decode)
and saves its four tables' signs and which entries the codec codes to
WORK/tables.pt.  The entries no stream codes come back +1, so a level's
+-1 sum, and with it the Pg value the encode derives from it, would differ
from the bundle's: `prepare` turns as many of those entries' values to -1
as the bundle's Pg value asks for (no probability reads them: a context
corner is read only where its entry is coded), so the tables re-encode to
the bundle's Pg values and, through a correct codec, to its streams.  With
the bundle's occupancy grid and context MLPs, which every tree reads from
the bundle itself, they are the inputs every tree encodes and decodes: no
training, the same inputs on both trees.

`time` imports cnc_torch from TREE (a directory holding another version's
`cnc_torch/`, e.g. a commit unpacked with `git archive`), builds its kernels
into TREE/cnc_torch/_build and prints one JSON line:
  * `build`: the bundle's ContextModels built on the card: seconds and the
    peak device memory (torch.cuda.max_memory_allocated);
  * `tables`: the finest level's tables (514^3 vertices) built again alone:
    ms, device ms, its peak device memory, and a digest of the tables (equal
    across trees): the counting sort (`level_tables`) or, in a tree before
    it, the keys, a stable torch.sort and the fill;
  * `pools`: the pools of one encode, each finished into the coder's
    probabilities (`CNCCodec._pool3d` and `_pool2d`, as the codec makes
    them: one launch a pool, or the pool and K9c's launch in a tree before
    it), each replayed through chip_smoke.device_ms behind a spin long
    enough to cover the tree's host time in a pool: their count, the summed
    device ms of the pass, and the device ms of the middle chunk of the last
    3D level and of the xy plane's last 2D level;
  * `kernels`: at those two pools, the tree's kernels alone by device ms:
    `int_ctx_pool` (or, in a tree before it, K9a `int_encode` and K9b
    `int_mlp_pool` on that tree's window), and the pool finished in its
    launch (`int_ctx_pool_pq`) or K9c's own launch (`int_pq`); each held to
    its twin with torch.equal;
  * `planes`: K7i, the integer frac plane of each axis (three a pass) on
    the tables' signs, alone: ms, device ms, launches, and a digest (equal
    across trees); each equal to its twin;
  * `codec`: `refresh_cache_int` once, then CODEC_RUNS encodes and decodes
    of the tables: seconds, their median, the launches of each pass; each
    decode equal to the tables on the coded entries and +1 elsewhere;
  * `streams`: the re-encoded `.b` files against the committed ones, byte
    for byte, checks.json by its content (its keys' order may differ), and
    the Pg values.

Times vary between calls by up to 1.5x: compare trees only within one call,
in turns (parent, new, new, parent).  `summary` gives each tree's mean over
its runs, each run's encode and decode seconds and whether the trees' ranges
of readings overlap, and whether every run's streams equal the bundle's.

`psnr` decodes BUNDLE through `decode_bundle` on DEVICE ("cpu": the plain
twins; "cuda": the kernels) and renders test view 0 of the 256x256 `blocks`
test set as tools/rd_sweep_depth.py scored it; prints one JSON line with the
decode and render seconds, the PSNR and SSIM and the device.
"""

from __future__ import annotations

import filecmp
import hashlib
import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BUNDLE = REPO / "runs_20k" / "bitstreams" / "l0.002_k4"
TABLES = ("xyz", "xy", "xz", "yz")
AXES = ("xy", "xz", "yz")
CODEC_RUNS = 3
SPIN_SCALE = 8        # device_ms's spin, times chip_smoke's (about 8 ms)


def _smoke():
    sys.path.insert(1, str(REPO))
    import chip_smoke
    return chip_smoke


def _model(dev):
    """The bundle's ContextModels and codec, its MLPs, Pg values and grid."""
    import torch
    from cnc_torch.codec import codec as codec_mod
    from cnc_torch.config import CNCConfig
    from cnc_torch.models import context_models as cm
    cfg = CNCConfig.from_dict(json.loads((BUNDLE / "meta.json").read_text())["config"])
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device=dev)
    pgs, ent_params, _, binaries = codec_mod.load_bundle(str(BUNDLE))
    return entropy, codec_mod.CNCCodec(entropy), ent_params, pgs, \
        torch.from_numpy(binaries).to(dev)


def prepare(work: Path) -> None:
    import torch
    from cnc_torch.codec import intctx
    work.mkdir(parents=True, exist_ok=True)
    entropy, codec, ent_params, pgs, binaries = _model(torch.device("cuda"))
    rec = codec.decode(ent_params, binaries, pgs, str(BUNDLE))
    cache = entropy.refresh_cache_int(binaries)
    signs = {k: intctx.sign_table(rec[k]) for k in TABLES}
    covered = _smoke().covered_rows(torch, intctx, entropy, codec, codec._int_params(ent_params),
                                    signs, cache, pgs)
    f = entropy.cfg.n_features
    for k in TABLES:
        spec, tag = (entropy.spec3, "3D") if k == "xyz" else (entropy.spec2, k)
        for l in range(spec.n_levels):
            rows = slice(spec.offsets[l], spec.offsets[l] + spec.level_sizes[l])
            ttl = spec.level_sizes[l] * f
            pos = int((signs[k][rows] > 0).sum())
            want = _pos_of_pg(codec, float(pgs[f"{tag}{l}"]), ttl)
            free = (~covered[k][rows]).nonzero().squeeze(1)
            if not 0 <= pos - want <= free.numel() * f:
                raise AssertionError(f"{k} level {l}: {pos - want} values to turn, "
                                     f"{free.numel() * f} uncoded")
            level = signs[k][rows]
            flat = level[free].reshape(-1)
            flat[:pos - want] = -1
            level[free] = flat.reshape(-1, f)
            if codec._pg_from_sum(int(level.sum()), ttl) != float(pgs[f"{tag}{l}"]):
                raise AssertionError(f"{k} level {l}: the Pg value is not the bundle's")
    torch.save({"signs": {k: (signs[k] > 0).cpu() for k in TABLES},
                "covered": {k: covered[k].cpu() for k in TABLES}}, work / "tables.pt")


def _pos_of_pg(codec, pg, ttl):
    """The count of +1 values whose Pg value (codec._pg_from_sum) is pg."""
    guess = round(pg * ttl)
    for pos in (guess, guess - 1, guess + 1, guess - 2, guess + 2):
        if 0 <= pos <= ttl and codec._pg_from_sum(2 * pos - ttl, ttl) == pg:
            return pos
    raise AssertionError(f"no count of {ttl} values gives Pg {pg}")


def _site_args(entropy, codec, intctx, ip, signs, cache, pgs):
    """The arguments of the two timed pools in this tree's own API: the
    middle chunk of the last 3D level and the xy plane's last 2D level with
    its frac plane."""
    k = entropy.cfg.max_context_layer_num
    l3, l2 = entropy.ctx_levels_3d[-1], entropy.ctx_levels_2d[-1]
    chunk_e, n_chunks, w3 = codec.chunks3d[l3]
    start = codec._chunk_bounds(l3)[n_chunks // 2][2]
    t3, t2 = entropy.tables3d[l3], entropy.tables2d[l2]
    lv3 = entropy._ctx_levels_meta(entropy.spec3, entropy.mask3d_offsets, l3 - k, l3)
    lv2 = entropy._ctx_levels_meta(entropy.spec2, entropy.mask2d_offsets, l2 - min(l2, k), l2)
    pg3 = intctx.quantize_pg(pgs[f"3D{l3}"])
    pg2 = intctx.quantize_pg(pgs[f"xy{l2}"])
    plane = (codec._frac(signs["xyz"], cache, "xy"), entropy.pn_res, entropy.pn_mask_offset)
    ovl = cache["ovl_int"][str(l3)]
    m2 = cache["mask2d"][0]
    if hasattr(intctx, "int_ctx_pool"):
        pos, slots, ev3 = entropy._entry_rows("3d", l3, start, chunk_e, w3, "pos_flat")
        coords, slots2, ev2 = entropy._entry_rows("2d", l2, 0, t2.n_entries, t2.n_points,
                                                  "coords")
        # each pool's arguments, and its finish: (m_scale, table offset, evals)
        return {"3D": ((ip, None, pos, slots, start, chunk_e, t3.resolution, cache["mask3d"],
                        entropy.mask3d_offsets[l3], signs["xyz"], lv3, pg3, codec.m_shift3[l3],
                        None, ovl), (codec.m_scale3[l3], t3.offset, ev3)),
                "2D": ((ip, l2, coords, slots2, 0, t2.n_entries, t2.resolution, m2,
                        entropy.mask2d_offsets[l2], signs["xy"], lv2, pg2, codec.m_shift2[l2],
                        plane, None), (codec.m_scale2[l2], t2.offset, ev2))}
    (pos,), valid, slots, _ = entropy._entry_window("3d", l3, start, chunk_e, w3,
                                                    ("pos_flat",))
    mask = cache["mask3d"][entropy.mask3d_offsets[l3] + pos.long()] & valid
    (coords,), valid2, slots2, _ = entropy._entry_window("2d", l2, 0, t2.n_entries,
                                                         t2.n_points, ("coords",))
    mask2 = m2[entropy.mask2d_offsets[l2] + (coords >> 16).long() * t2.resolution
               + (coords & 0xFFFF).long()] & valid2
    return {"3D": ((pos, 3, t3.resolution, signs["xyz"], lv3, cache["mask3d"], None),
                   (pg3, codec.m_shift3[l3], mask, slots, chunk_e, ovl, pos), None),
            "2D": ((coords, 2, t2.resolution, signs["xy"], lv2, m2, plane),
                   (pg2, codec.m_shift2[l2], mask2, slots2, t2.n_entries, None, None), l2)}


def _time_kernels(torch, cs, intctx, ip, sites):
    """Each site's kernels by device ms, held to their twins."""
    out = {}
    for key, a in sites.items():
        if hasattr(intctx, "int_ctx_pool"):
            a, (m_scale, offset, evals) = a
            got = intctx.int_ctx_pool(*a)
            want = intctx.int_ctx_pool_plain(*a)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"int_ctx_pool at {key} differs from its twin")
            out[key] = {"int_ctx_pool": cs.device_ms(lambda a=a: intctx.int_ctx_pool(*a))}
            pq_args = (got[0], got[1], m_scale, a[9], offset, evals)
            twin = intctx._int_pq_plain(*pq_args)
            if hasattr(intctx, "int_ctx_pool_pq"):
                fin = a[:13] + (m_scale,) + a[13:] + (offset, evals)
                if not all(torch.equal(x, y) for x, y in zip(intctx.int_ctx_pool_pq(*fin), twin)):
                    raise AssertionError(f"int_ctx_pool_pq at {key} differs from its twins")
                out[key]["int_ctx_pool_pq"] = cs.device_ms(lambda f=fin: intctx.int_ctx_pool_pq(
                    *f))
            else:
                if not all(torch.equal(x, y) for x, y in zip(intctx._int_pq_cuda(*pq_args),
                                                              twin)):
                    raise AssertionError(f"int_pq at {key} differs from its twin")
                out[key]["int_pq"] = cs.device_ms(lambda p=pq_args: intctx._int_pq_cuda(*p))
            intctx.raise_on_pool_faults(a[2].device)
            continue
        enc_args, mlp_tail, level = a
        feats = intctx._int_encode_cuda(*enc_args)
        if not torch.equal(feats, intctx._int_encode_plain(*enc_args)):
            raise AssertionError(f"K9a at {key} differs from its twin")
        mlp_args = (ip, level, feats) + mlp_tail
        got = intctx._int_mlp_pool_cuda(*mlp_args)
        if not all(torch.equal(x, y) for x, y in zip(got, intctx._int_mlp_pool_plain(
                *mlp_args))):
            raise AssertionError(f"K9b at {key} differs from its twin")
        out[key] = {"int_encode": cs.device_ms(lambda e=enc_args: intctx._int_encode_cuda(*e)),
                    "int_mlp_pool": cs.device_ms(lambda m=mlp_args: intctx._int_mlp_pool_cuda(
                        *m))}
    return out


def _time_tables(torch, cs, entropy, dev):
    """The finest level's tables built alone with this tree's API: the
    counting sort, or the keys, a stable torch.sort and the fill."""
    from cnc_torch.ops import context_ops as cops
    p = next(p for p in entropy._level_plans() if p["kind"] == "3d" and p["r"] == entropy.fine_res)
    v, r, tbl, e_max = p["v"], p["r"], p["tbl"], p["e_max"]
    if hasattr(cops, "level_tables"):
        build = lambda: cops.level_tables(v, 3, r, tbl, e_max, dev)
    else:
        def build():
            skey, loc = torch.sort(cops.vertex_keys(v, 3, r, tbl, dev), stable=True)
            return cops.entry_fill(skey, loc, e_max, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = build()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    digest = hashlib.sha256()
    for k in ("cum", "entry_values", "vert_entry", "pos_flat", "n_entries"):
        digest.update(got[k].cpu().numpy().tobytes())
    del got
    return {"vertices": v, "ms": cs.time_ms(build, iters=5, warmup=1),
            "device_ms": cs.device_ms(build, iters=5), "peak_gib": peak,
            "digest": digest.hexdigest()[:16]}


def time_tree(work: Path, tree: Path, label: str) -> None:
    import torch
    sys.path.insert(0, str(tree.resolve()))
    import cnc_torch
    from cnc_torch import kernels
    from cnc_torch.codec import intctx
    if Path(cnc_torch.__file__).resolve().parent != (tree / "cnc_torch").resolve():
        raise RuntimeError(f"cnc_torch was not imported from {tree}")
    cs = _smoke()
    kernels.lib()
    dev = torch.device("cuda")
    out = {"tree": label, "card": cs.card_line(), "device": torch.cuda.get_device_name(0)}
    saved = torch.load(work / "tables.pt")
    tables = {k: torch.where(saved["signs"][k], 1.0, -1.0).to(dev) for k in TABLES}
    covered = {k: saved["covered"][k].to(dev) for k in TABLES}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    entropy, codec, ent_params, pgs, binaries = _model(dev)
    torch.cuda.synchronize()
    out["build"] = {"s": time.time() - t0,
                    "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    out["tables"] = _time_tables(torch, cs, entropy, dev)
    torch.cuda.synchronize()
    t0 = time.time()
    cache = entropy.refresh_cache_int(binaries)
    torch.cuda.synchronize()
    out["cache_s"] = time.time() - t0
    ip = codec._int_params(ent_params)
    signs = {k: intctx.sign_table(tables[k]) for k in TABLES}

    # ---- K7i: the pass's three frac planes, each alone
    out["planes"] = {}
    for ax in AXES:
        args = (signs["xyz"], cache["pn"][ax], entropy.fine_offset, entropy.pn_res,
                entropy.cfg.n_features)
        plane = lambda a=args: intctx.frac_plane(*a)
        kernels.reset_launches()
        got = plane()
        launched = {k: v for k, v in kernels.launches.items() if v}
        if not torch.equal(got, intctx.int_frac_plane(*args)):
            raise AssertionError(f"{label}: K7i's {ax} plane differs from its twin")
        out["planes"][ax] = {"ms": cs.time_ms(plane), "device_ms": cs.device_ms(plane),
                             "launches": launched,
                             "digest": hashlib.sha256(got.cpu().numpy().tobytes())
                             .hexdigest()[:16]}

    # ---- one encode, its pools recorded, then the streams against the bundle's
    calls = []
    for name in ("_pool3d", "_pool2d"):
        def recording(*a, _fn=getattr(codec, name), _name=name, **kw):
            calls.append((_name, a, kw))
            return _fn(*a, **kw)
        setattr(codec, name, recording)
    enc_dir = work / f"encode_{label}"
    try:
        pgs_enc, _, coded_mb = codec.encode(ent_params, tables, binaries, str(enc_dir),
                                            cache=cache)
    finally:
        for name in ("_pool3d", "_pool2d"):
            delattr(codec, name)
    names = sorted(p.name for p in BUNDLE.glob("b_*"))
    made = sorted(p.name for p in enc_dir.glob("b_*"))
    same = lambda n: (json.loads((BUNDLE / n).read_text()) == json.loads((enc_dir / n)
                                                                         .read_text())
                      if n.endswith(".json") else filecmp.cmp(BUNDLE / n, enc_dir / n,
                                                              shallow=False))
    differ = [n for n in names if n not in made or not same(n)]
    out["streams"] = {"files": len(names), "made": len(made), "differ": differ,
                      "extra": sorted(set(made) - set(names)),
                      "pgs_equal": all(float(pgs_enc[k]) == float(pgs[k]) for k in pgs),
                      "coded_mb": coded_mb}

    # ---- the pools of that encode, replayed
    l3, l2 = entropy.ctx_levels_3d[-1], entropy.ctx_levels_2d[-1]
    mid = codec._chunk_bounds(l3)[codec.chunks3d[l3][1] // 2][2]
    spin = cs.SPIN_CYCLES
    cs.SPIN_CYCLES = spin * SPIN_SCALE
    try:
        per = [cs.device_ms(lambda n=n, a=a, kw=kw: getattr(codec, n)(*a, **kw), iters=3)
               for n, a, kw in calls]
    finally:
        cs.SPIN_CYCLES = spin
    if hasattr(intctx, "raise_on_pool_faults"):
        intctx.raise_on_pool_faults(dev)
    at = lambda want: next(t for (n, a, _), t in zip(calls, per) if want(n, a))
    out["pools"] = {
        "count": len(calls), "pass_device_ms": sum(per), "largest_device_ms": max(per),
        "3D": at(lambda n, a: n == "_pool3d" and a[0] == l3 and a[5] == mid),
        "2D": at(lambda n, a: n == "_pool2d" and a[0] == l2)}     # xy: the first plane pooled
    del calls

    # ---- the kernels alone at those two pools
    out["kernels"] = _time_kernels(torch, cs, intctx, ip,
                                   _site_args(entropy, codec, intctx, ip, signs, cache, pgs))

    # ---- encodes and decodes
    runs = []
    for _ in range(CODEC_RUNS):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        codec.encode(ent_params, tables, binaries, str(enc_dir), cache=cache)
        torch.cuda.synchronize()
        enc_s = time.time() - t0
        enc_l = {k: v for k, v in kernels.launches.items() if v}
        kernels.reset_launches()
        t0 = time.time()
        rec = codec.decode(ent_params, binaries, pgs, str(enc_dir), cache=cache)
        torch.cuda.synchronize()
        dec_s = time.time() - t0
        dec_l = {k: v for k, v in kernels.launches.items() if v}
        if not all(torch.equal(rec[k][covered[k]], tables[k][covered[k]])
                   and bool((rec[k][~covered[k]] == 1).all()) for k in TABLES):
            raise AssertionError(f"{label}: the decode differs from the bundle's tables")
        runs.append({"encode_s": enc_s, "decode_s": dec_s, "encode_launches": enc_l,
                     "decode_launches": dec_l})
    out["codec"] = {"encode_s": statistics.median(r["encode_s"] for r in runs),
                    "decode_s": statistics.median(r["decode_s"] for r in runs), "runs": runs}
    print(json.dumps(out))


def summary(path: Path) -> None:
    """Markdown tables of the `time` lines in `path`."""
    runs = [json.loads(line) for line in path.read_text().splitlines()
            if line.startswith('{"tree"')]
    trees = list(dict.fromkeys(r["tree"] for r in runs))
    by = lambda t: [r for r in runs if r["tree"] == t]
    mean = lambda xs: sum(xs) / len(xs)
    print(f"{runs[0]['card']}; {len(runs)} runs ({', '.join(r['tree'] for r in runs)})")
    print("| item | " + " | ".join(trees) + " |")
    print("| --- |" + " --- |" * len(trees))
    rows = [("ContextModels build s", lambda r: r["build"]["s"]),
            ("ContextModels build peak GiB", lambda r: r["build"]["peak_gib"]),
            ("finest level's tables ms", lambda r: r["tables"]["ms"]),
            ("finest level's tables device ms", lambda r: r["tables"]["device_ms"]),
            ("finest level's tables peak GiB", lambda r: r["tables"]["peak_gib"]),
            ("pools a pass", lambda r: r["pools"]["count"]),
            ("one pass's pools, device ms summed", lambda r: r["pools"]["pass_device_ms"]),
            ("the largest pool, device ms", lambda r: r["pools"]["largest_device_ms"]),
            ("pool: last 3D level, middle chunk, device ms", lambda r: r["pools"]["3D"]),
            ("pool: xy plane's last 2D level, device ms", lambda r: r["pools"]["2D"])]
    for key in ("3D", "2D"):
        for k in sorted({k for r in runs for k in r["kernels"][key]}):
            rows.append((f"kernel {k} at the {key} pool, device ms",
                         lambda r, key=key, k=k: r["kernels"][key].get(k)))
    for ax in AXES:
        rows += [(f"K7i {ax} plane, device ms", lambda r, ax=ax: r["planes"][ax]["device_ms"]),
                 (f"K7i {ax} plane, ms", lambda r, ax=ax: r["planes"][ax]["ms"])]
    rows += [("refresh_cache_int s", lambda r: r["cache_s"]),
             ("encode s (median of the run's)", lambda r: r["codec"]["encode_s"]),
             ("decode s (median of the run's)", lambda r: r["codec"]["decode_s"])]
    for name, get in rows:
        cells = []
        for t in trees:
            vals = [get(r) for r in by(t) if get(r) is not None]
            cells.append(f"{mean(vals):.4f}" if vals else "-")
        print(f"| {name} | " + " | ".join(cells) + " |")
    digests = {r["tables"]["digest"] for r in runs}
    print(f"finest level's tables: {len(digests)} digest(s) over every run ({sorted(digests)})")
    digests = {json.dumps({ax: r["planes"][ax]["digest"] for ax in AXES}) for r in runs}
    print(f"K7i planes: {len(digests)} digest set(s) over every run; launches a plane "
          + " / ".join(sorted({json.dumps(r["planes"][ax]["launches"]) for r in runs
                               for ax in AXES})))
    for t in trees:
        launches = {json.dumps(x["encode_launches"], sort_keys=True) for r in by(t)
                    for x in r["codec"]["runs"]}
        launches |= {json.dumps(x["decode_launches"], sort_keys=True) for r in by(t)
                     for x in r["codec"]["runs"]}
        print(f"{t}: launches per encode or decode pass: {' / '.join(sorted(launches))}")
        for r in by(t):
            s = r["streams"]
            print(f"{t}: streams {s['files'] - len(s['differ'])} of {s['files']} byte-identical"
                  f" to the bundle's ({s['made']} written; differ: {s['differ'] or 'none'};"
                  f" Pg equal {s['pgs_equal']}; {s['coded_mb']:.4f} MB coded)")

    def spread(item, key):
        get = lambda r: [x[key] for x in r["codec"]["runs"]]
        spans = {t: sorted(v for r in by(t) for v in get(r)) for t in trees}
        text = "; ".join(f"{t} {v[0]:.4f} / {statistics.median(v):.4f} / {v[-1]:.4f}"
                         for t, v in spans.items())
        if len(trees) == 2:
            (a, b) = spans.values()
            apart = a[-1] < b[0] or b[-1] < a[0]
            text += (f"; {trees[1]} - {trees[0]} = "
                     f"{statistics.median(b) - statistics.median(a):+.4f} between medians, "
                     + ("resolved (the ranges do not overlap)" if apart else
                        "not resolved (the ranges overlap)"))
        print(f"{item}, every reading (least / median / most): {text}")

    spread("encode s", "encode_s")
    spread("decode s", "decode_s")


def psnr(bundle: str, device: str) -> None:
    import torch
    from cnc_torch.data import scenes
    from cnc_torch.render import renderer
    from cnc_torch.train import driver
    from cnc_torch.utils import metrics
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("psnr: no CUDA device")
    t0 = time.time()
    field, binaries, cfg = driver.decode_bundle(bundle, device=dev, log_fn=lambda m: None)
    decode_s = time.time() - t0
    test = scenes.ProceduralDataset("blocks", 8, 256, 256, "test", device=dev)
    rays, gt = test.image_and_rays(0)
    aabb = torch.tensor(cfg.render.aabb, dtype=torch.float32, device=dev)
    t0 = time.time()
    rgb = renderer.render_image(field, cfg.model, cfg.render, aabb, binaries, rays.origins,
                                rays.viewdirs, torch.ones(3, device=dev), device=dev)[0]
    render_s = time.time() - t0
    print(json.dumps({"bundle": bundle, "device": (torch.cuda.get_device_name(0)
                                                   if dev.type == "cuda" else "cpu"),
                      "threads": torch.get_num_threads(), "decode_s": decode_s,
                      "render_s": render_s, "psnr": float(metrics.psnr(rgb, gt)),
                      "ssim": float(metrics.ssim(rgb, gt))}))


def main() -> int:
    import torch
    if sys.argv[1:2] in (["prepare"], ["psnr"]):
        sys.path.insert(0, str(REPO))       # this tree's cnc_torch
    if len(sys.argv) == 3 and sys.argv[1] == "summary":
        summary(Path(sys.argv[2]))
        return 0
    if len(sys.argv) == 4 and sys.argv[1] == "psnr":
        psnr(sys.argv[2], sys.argv[3])
        return 0
    if not torch.cuda.is_available():
        print("torch_codec_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "prepare":
        prepare(Path(sys.argv[2]))
    elif len(sys.argv) == 5 and sys.argv[1] == "time":
        time_tree(Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
