"""The full CNC pipeline: train -> eval -> encode -> decode -> re-eval -> quantize.

Port of `cnc_tpu/train/driver.py` for one card (the reference driver,
train_CNC_nerf_synthetic.py:302-613): joint rate-distortion training,
test-set evaluation, full-coverage encoding to bitstreams, zeroing the
tables and decoding them back (the built-in lossless self-check), the
post-codec evaluation, 13-bit MLP quantization with a final evaluation, and
one append-only TSV row in the reference's column order (SSIM recorded
negated).  `decode_bundle` serves a compressed scene in a fresh process.

`run_pipeline(group=)` is cnc_tpu's `run_pipeline(mesh=)`: every rank
builds the entropy model with its per-rank quotas and trains (`Trainer(
group=)`); rank 0 then evaluates, encodes, decodes and returns the result,
which cnc_tpu computes outside the mesh on replicated parameters, while the
other ranks wait for it and return None.

What differs from cnc_tpu is mechanics: there is no `warm_compile`, and the
field is a module, so the decoded tables and each quantized MLP are copied
into it in place (the field ends holding the last sweep's MLPs, as
cnc_tpu's `trainer.params` does).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..codec import codec as codec_mod
from ..config import CNCConfig
from ..grids import occupancy as occ
from ..models import context_models as cm
from ..models import radiance_field as rf
from ..parallel import sharding
from ..utils.device import resolve_device
from .trainer import Trainer


@dataclasses.dataclass
class PipelineResult:
    psnr: float
    lpips: Optional[float]    # None = no LPIPS weights (recorded "n/a")
    ssim: float
    psnr_codec: float
    lpips_codec: Optional[float]
    ssim_codec: float
    embed_MB_est: float
    embed_MB_codec: float
    mlp_MB_orig: float
    context_MB: float
    binary_vxl_MB: float
    quant_results: list
    elapsed_train_s: float
    encode_s: float
    decode_s: float
    raw_table_MB: float = float("nan")   # fp32 size of the four hash tables

    def total_size_MB(self, digit_idx: int = 0) -> float:
        return (self.embed_MB_codec + self.context_MB + self.binary_vxl_MB +
                self.quant_results[digit_idx]["mlp_MB"])

    def compression_x(self, digit_idx: int = 0) -> float:
        """Coded-bundle compression against the raw fp32 tables and fp32
        MLPs (the reference's ~100x-vs-Instant-NGP headline, README.md:3)."""
        return ((self.raw_table_MB + self.mlp_MB_orig) /
                self.total_size_MB(digit_idx))


def build_entropy(cfg: CNCConfig, n_devices: int = 1, device=None) -> cm.ContextModels:
    """The entropy model on `device`; with n_devices > 1, per-device sampling
    quotas (cnc_tpu's data-parallel split of the total budget)."""
    ecfg = cfg.entropy
    if n_devices > 1:
        ecfg = dataclasses.replace(
            ecfg,
            sample_num=max(1, ecfg.sample_num // n_devices),
            v_ctx_cap=max(256, ecfg.v_ctx_cap // n_devices),
            sample_num_2d=(max(64, ecfg.sample_num_2d // n_devices)
                           if ecfg.sample_num_2d else ecfg.sample_num_2d),
            pn_frac_sample_cap=(max(1024, ecfg.pn_frac_sample_cap // n_devices)
                                if ecfg.pn_frac_sample_cap
                                else ecfg.pn_frac_sample_cap))
    return cm.ContextModels(ecfg, cfg.model.grid_3d, cfg.model.grid_2d, device=device)


def run_pipeline(cfg: CNCConfig, train_dataset, test_dataset, scene: str,
                 out_root: str = ".", max_steps: Optional[int] = None,
                 max_eval_images: Optional[int] = None, log_fn=print,
                 device=None, group=None) -> Optional[PipelineResult]:
    """Build the entropy model (when lmbda > 0) and the Trainer on `device`
    (the card unless device="cpu"; with `group`, the group's device), then
    `run_with_trainer`.  The datasets must live on the same device.

    With `group` (`parallel.sharding.make_group`; every rank calls this
    alike) the training is data parallel with per-rank quotas; rank 0 alone
    evaluates, encodes, decodes and logs, and returns the result; the other
    ranks wait until it has (`sharding.rank0_barrier`: they raise if rank 0
    failed or did not arrive in time) and return None."""
    if group is not None and device is None:
        device = group.device
    dev = resolve_device(device)
    world_size = group.world_size if group is not None else 1
    rank0 = group is None or group.rank == 0
    t0 = time.time()
    entropy = build_entropy(cfg, world_size, device=dev) if cfg.train.lmbda > 0 else None
    if rank0:
        log_fn(f"entropy tables built in {time.time() - t0:.1f}s")
    trainer = Trainer(cfg, train_dataset, entropy=entropy, device=dev, group=group)
    if group is None:
        return run_with_trainer(trainer, test_dataset, scene, out_root=out_root,
                                max_steps=max_steps, max_eval_images=max_eval_images,
                                log_fn=log_fn)
    if rank0:
        log_fn(f"training data parallel over {world_size} ranks...")
    elapsed = trainer.fit(max_steps=max_steps, log_fn=log_fn)
    result = None
    if rank0:
        try:
            result = finish_pipeline(trainer, test_dataset, scene, elapsed, out_root=out_root,
                                     max_eval_images=max_eval_images, log_fn=log_fn)
        except BaseException:
            sharding.rank0_barrier(group, "run_pipeline", ok=False)
            raise
    sharding.rank0_barrier(group, "run_pipeline")
    return result


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_with_trainer(trainer: Trainer, test_dataset, scene: str,
                     out_root: str = ".", max_steps: Optional[int] = None,
                     max_eval_images: Optional[int] = None,
                     log_fn=print, log_every: int = 200) -> PipelineResult:
    """The pipeline over a prebuilt (possibly resumed or reset_state-ed)
    Trainer; training continues from its step to `max_steps`."""
    log_fn("training...")
    elapsed = trainer.fit(max_steps=max_steps, log_fn=log_fn, log_every=log_every)
    return finish_pipeline(trainer, test_dataset, scene, elapsed, out_root=out_root,
                           max_eval_images=max_eval_images, log_fn=log_fn)


def finish_pipeline(trainer: Trainer, test_dataset, scene: str, elapsed: float,
                    out_root: str = ".", max_eval_images: Optional[int] = None,
                    log_fn=print) -> PipelineResult:
    """Everything after the training: evaluation, encode, the decode
    self-check, the post-codec evaluation and the MLP quantization sweep.
    No collective: with a data-parallel trainer, rank 0 runs it alone."""
    cfg = trainer.cfg
    entropy = trainer.entropy
    dev = trainer.device

    log_fn("evaluating (pre-codec)...")
    ev = trainer.evaluate(test_dataset, max_images=max_eval_images, log_fn=log_fn)

    embed_mb_est = embed_mb_codec = 0.0
    enc_s = dec_s = 0.0
    context_mb = 0.0
    stream_dir = os.path.join(out_root, "bitstreams", scene)
    binaries = trainer.occ_state.binaries
    if cfg.train.lmbda > 0:
        codec = codec_mod.CNCCodec(entropy)
        with torch.no_grad():
            tables = rf.quantized_tables(trainer.field, cfg.model)
        _sync(dev)
        t0 = time.time()
        # one occupancy-cache build serves both codec passes (the decode
        # self-check runs on the same binaries right after)
        codec_cache = entropy.refresh_cache_int(binaries)
        pgs, embed_mb_est, embed_mb_codec = codec.encode(
            trainer.ent_params, tables, binaries, stream_dir, prefix="b", cache=codec_cache)
        enc_s = time.time() - t0
        log_fn(f"encoded {embed_mb_codec:.4f} MB (analytic {embed_mb_est:.4f} MB) in "
               f"{enc_s:.1f}s -> {stream_dir}")
        del tables

        # lossless self-check: zero the tables, decode, swap in (driver
        # :446-471).  The decode reads only pgs, the streams and the cache.
        rf.replace_tables(trainer.field, {k: torch.zeros_like(trainer.field.tables[k])
                                          for k in rf.TABLES})
        t0 = time.time()
        rec = codec.decode(trainer.ent_params, binaries, pgs, stream_dir, prefix="b",
                           cache=codec_cache)
        _sync(dev)
        dec_s = time.time() - t0
        rf.replace_tables(trainer.field, rec)
        del rec, codec_cache
        log_fn(f"decoded in {dec_s:.1f}s")
        context_mb = entropy.param_count(trainer.ent_params) * 4 / 1024 / 1024
        codec_mod.save_bundle(
            stream_dir, pgs, trainer.ent_params, trainer.field, binaries,
            {"scene": scene, "lmbda": cfg.train.lmbda,
             "n_features": cfg.model.n_features_per_level, "config": cfg.to_dict()})

    log_fn("evaluating (post-codec)...")
    ev_codec = trainer.evaluate(test_dataset, max_images=max_eval_images, log_fn=log_fn)

    # 13-bit MLP quantization sweep (driver :508-556); every digit count
    # quantizes the MLPs as they were before the sweep
    quant_results = []
    mlp = rf.split_mlp_params(trainer.field)
    mlp_np = {k: p.detach().cpu().numpy().copy() for k, p in mlp.items()}
    _, mlp_mb_orig, _ = codec_mod.quantize_mlp_params(mlp_np, 13)
    for digits in cfg.train.mlp_quant_digits:
        mb, _, q = codec_mod.quantize_mlp_params(mlp_np, digits)
        with torch.no_grad():
            for k, p in mlp.items():
                p.copy_(torch.from_numpy(q[k]))
        ev_q = trainer.evaluate(test_dataset, max_images=max_eval_images, log_fn=log_fn)
        quant_results.append({"digits": digits, "mlp_MB": mb, **ev_q})

    _, vxl_bits, _ = occ.occupancy_grid_size_bits(binaries)
    vxl_mb = float(vxl_bits) / 8 / 1024 / 1024

    result = PipelineResult(
        psnr=ev["psnr"], lpips=ev["lpips"], ssim=ev["ssim"],
        psnr_codec=ev_codec["psnr"], lpips_codec=ev_codec["lpips"],
        ssim_codec=ev_codec["ssim"],
        embed_MB_est=embed_mb_est, embed_MB_codec=embed_mb_codec,
        mlp_MB_orig=mlp_mb_orig, context_MB=context_mb,
        binary_vxl_MB=vxl_mb, quant_results=quant_results,
        elapsed_train_s=elapsed, encode_s=enc_s, decode_s=dec_s,
        raw_table_MB=sum(trainer.field.tables[k].numel() for k in rf.TABLES) * 4 / 1024**2)
    log_fn(f"compression: {result.raw_table_MB:.1f} MB raw fp32 tables -> "
           f"{result.total_size_MB():.4f} MB bundle ({result.compression_x():.1f}x)")
    return result


def decode_bundle(stream_dir: str, device=None, log_fn=print):
    """Rebuild a renderable radiance field from a self-contained bitstream
    directory, in a fresh process: the config from meta.json, the context
    and MLP weights and the occupancy grid from meta.npz, the hash tables
    decoded from the streams.  Reads bundles of either package.

    Returns (field: RadianceField, binaries: bool [R, R, R], cfg) on `device`
    (the card unless device="cpu"), ready for `render_image`."""
    dev = resolve_device(device)
    with open(os.path.join(stream_dir, "meta.json")) as fh:
        meta = json.load(fh)
    cfg = CNCConfig.from_dict(meta["config"])
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device=dev)
    pgs, ent_params, mlp_params, binaries = codec_mod.load_bundle(stream_dir)
    binaries = torch.from_numpy(binaries).to(dev)
    codec = codec_mod.CNCCodec(entropy)
    t0 = time.time()
    rec = codec.decode(ent_params, binaries, pgs, stream_dir, prefix="b")
    log_fn(f"decoded bundle {stream_dir} in {time.time() - t0:.1f}s")
    tables = {k: v.cpu().numpy() for k, v in rec.items()}
    field = rf.params_from_jax({**tables, **mlp_params}, cfg.model, device=dev)
    return field, binaries, cfg


def append_result_row(result: PipelineResult, scene: str, dataset_name: str,
                      out_root: str = ".") -> list:
    """Append the TSV row with the reference's column layout (driver
    :562-613) to <out_root>/results/<dataset_name>/output.txt, and return
    its columns.  SSIM is written negated, as the reference records it."""
    outdir = os.path.join(out_root, "results", dataset_name)
    os.makedirs(outdir, exist_ok=True)
    r = result

    def fmt(v):
        # absent LPIPS (no weights) is recorded "n/a", never NaN
        if v is None or (isinstance(v, float) and np.isnan(v)):
            return "n/a"
        return np.round(v, 4)

    cols = [scene,
            fmt(r.psnr), fmt(r.lpips), fmt(-r.ssim),
            fmt(r.psnr_codec), fmt(r.lpips_codec), fmt(-r.ssim_codec),
            fmt(r.embed_MB_est), fmt(r.embed_MB_codec),
            fmt(r.mlp_MB_orig), fmt(r.context_MB), fmt(r.binary_vxl_MB)]
    for i, q in enumerate(r.quant_results):
        cols += [q["digits"], fmt(q["mlp_MB"]),
                 fmt(q["psnr"]), fmt(q["lpips"]), fmt(-q["ssim"]),
                 fmt(r.total_size_MB(i))]
    cols += [np.round(r.elapsed_train_s, 4), np.round(r.encode_s, 4),
             np.round(r.decode_s, 4),
             # extension columns (not in the reference layout): raw fp32
             # table MB and the resulting compression factor
             fmt(r.raw_table_MB), fmt(r.compression_x())]
    cols = [str(c) for c in cols]
    with open(os.path.join(outdir, "output.txt"), "a") as fw:
        fw.write("\t".join(cols) + "\n")
    return cols
