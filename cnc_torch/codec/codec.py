"""CNC bitstream codec: full-coverage encode and sequential decode.

Port of `cnc_tpu/codec/codec.py` (reference encode/decode drivers,
utils_bpp_acc.py:709-999), writing and reading the same streams:

  encode: per level, compute per-entry Bernoulli probabilities from the
  integer context pipeline (full coverage, chunked by a vertex budget), pull
  them to the host, range-code the +-1 entries, write
  `{prefix}_{3D|xy|xz|yz}{level}[_{chunk}].b` and `{prefix}_checks.json` (a
  sha256 per stream of its symbol bits, plus "__format__").

  decode: strictly level-sequential: 3D levels 0..L in order (context reads
  only already-decoded coarser levels), then the three planes (whose
  dimension-wise prior needs the fully decoded finest 3D level).  Entries
  never touched by an occupied footprint are not coded and keep their +1
  initialization.

The streams are byte-identical to cnc_tpu's for the same tables, occupancy
and context weights, and a bundle written by either package decodes in the
other.  The device work per pool is one launch of int_ctx_pool (the context
encode, the MLP and the pooling of the window's kept rows), finished in the
same launch into K9c's probabilities, coverage and sign bits, which reach
the host in one copy; the dimension-wise planes are K7i (codec/intctx.py).
The pools' order-fault word is read where the host pulls their results
anyway, not after each pool.  What stays plain torch:
the per-table stats (one integer sum per level and the packed sign bits)
and the decoded symbols' writes, one `index_copy_` per level (so no
out-of-range padding row is needed, unlike cnc_tpu's recompile-avoiding
padded scatter).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import pathlib
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.context_models import ContextModels
from . import coder, intctx

P_CLIP = 1e-6
AXES = ("xy", "xz", "yz")


def _to_device_tree(tree: Mapping, dev) -> Dict:
    return {k: (_to_device_tree(v, dev) if isinstance(v, Mapping)
                else torch.from_numpy(np.ascontiguousarray(v)).to(dev))
            for k, v in tree.items()}


class CNCCodec:
    """Host-orchestrated encoder/decoder over a ContextModels instance, on
    the model's device.

    All per-entry probabilities run through the deterministic integer
    pipeline (codec/intctx.py), identical in every process, on every device
    and in both packages, which is what makes the self-contained bundle
    decodable anywhere."""

    def __init__(self, ctx: ContextModels):
        self.ctx = ctx
        self.cfg = ctx.cfg
        # static chunking per 3D context level (reference :798-810); exact
        # max chunk-vertex windows from the cum tables
        self.chunks3d: Dict[int, tuple] = {}
        chunk_es = {}
        for l in ctx.ctx_levels_3d:
            t = ctx.tables3d[l]
            pts_per_entry = t.n_vertices / t.n_entries
            chunk_es[l] = int(min(t.n_entries,
                                  max(1, self.cfg.max_points_per_chunk / pts_per_entry)))
        sns = ([chunk_es[l] for l in ctx.ctx_levels_3d] +
               [ctx.tables2d[l].n_entries for l in ctx.ctx_levels_2d])
        wins = ctx.max_window_pts(sns)
        for i, l in enumerate(ctx.ctx_levels_3d):
            t = ctx.tables3d[l]
            chunk_e = chunk_es[l]
            n_chunks = int(np.ceil(t.n_entries / chunk_e))
            w = t.n_vertices if chunk_e >= t.n_entries else int(wins[i])
            self.chunks3d[l] = (chunk_e, n_chunks, w)
        # per-level output shifts keeping the int32 pooled sums exact even
        # for pathological hash buckets (vmax = largest vertex count of any
        # single entry, read off the cum tables by a 1-entry window query)
        vmax = np.asarray(ctx.max_window_pts([1] * (len(ctx.ctx_levels_3d) +
                                                    len(ctx.ctx_levels_2d))))
        self.m_shift3, self.m_scale3 = {}, {}
        self.m_shift2, self.m_scale2 = {}, {}
        for i, l in enumerate(ctx.ctx_levels_3d):
            s = max(0, int(vmax[i]).bit_length() + intctx.OVL_BITS + 14 - 30)
            self.m_shift3[l] = s
            self.m_scale3[l] = intctx.M_SCALE >> s
        for j, l in enumerate(ctx.ctx_levels_2d):
            s = max(0, int(vmax[len(ctx.ctx_levels_3d) + j]).bit_length() + 14 - 30)
            self.m_shift2[l] = s
            self.m_scale2[l] = intctx.M_SCALE >> s

    # ------------------------------------------------------------- the pools
    # Each pool finishes the probability math on the device (K9c, in the
    # pool's own launch) and hands back one buffer (pq uint16, sign bits
    # uint8, covered bool): 2 + 1/F + 1 bytes per symbol, pulled in one copy
    # (intctx.pull_probs), instead of the 12 of raw msum, wsum and values.
    def _pool3d(self, level, ip, sign3, cache, pg_q, start_e, with_bits=True):
        chunk_e, _, w = self.chunks3d[level]
        return self.ctx.pool_3d_probs_int(ip, sign3, cache, level, pg_q, start_e, chunk_e, w,
                                          self.m_shift3[level], self.m_scale3[level], with_bits)

    def _pool2d(self, level, ip, sign2, pg_q, plane_q, mask2d_ax, with_bits=True):
        t = self.ctx.tables2d[level]
        return self.ctx.pool_2d_probs_int(ip, sign2, level, pg_q, plane_q, mask2d_ax, 0,
                                          t.n_entries, t.n_points, self.m_shift2[level],
                                          self.m_scale2[level], with_bits)

    def _check_pools(self):
        """Raise if a pool queued since the last check broke its kernel's
        precondition (one host sync; nothing on the CPU, whose twin raises
        at once)."""
        if self.ctx.device.type == "cuda":
            intctx.raise_on_pool_faults(self.ctx.device)

    def _frac(self, sign3, cache, ax):
        return self.ctx.frac_plane_int(sign3, cache["pn"][ax]) if self.cfg.use_dimension_wise \
            else None

    @staticmethod
    def _stats(table: torch.Tensor, spec):
        """Per-level +-1 sums (exact, int64: the global-Pg numerators) and the
        MSB-first packed sign bits (np.unpackbits order) of one table."""
        sums = torch.stack([lv.to(torch.int32).sum(dtype=torch.int64)
                            for lv in table.split(list(spec.level_sizes))])
        bits = (table > 0).reshape(-1).to(torch.int32)
        pad = (-bits.numel()) % 8
        if pad:
            bits = torch.cat([bits, bits.new_zeros(pad)])
        weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                               device=table.device)
        packed = (bits.reshape(-1, 8) * weights).sum(1).to(torch.uint8)
        return sums, packed

    def _int_params(self, ent_params):
        """Quantized context MLPs as int32 tensors on the model's device, from
        a ContextParams or a nested dict of arrays in cnc_tpu's layout."""
        if isinstance(ent_params, nn.Module):
            ent_params = ContextModels.ent_params_to_numpy(ent_params)
        return _to_device_tree(intctx.quantize_ctx_params(ent_params), self.ctx.device)

    @staticmethod
    def _pg_from_sum(s: int, ttl: int) -> float:
        """Global Pg of one level from its exact +-1 sum (global_pg_bits
        numerator, ops/entropy.py): pos/ttl, single-rounded to float32 —
        identical to dividing the exact integers in float32 directly, and
        exactly representable through the bundle's float32 pgs array."""
        return float(np.float32((ttl + int(s)) / 2.0 / ttl))

    @staticmethod
    def _analytic_bits(bits: np.ndarray, pq: np.ndarray) -> float:
        p = np.clip(pq.astype(np.float64) / 65536.0, P_CLIP, 1 - P_CLIP)
        return float(np.sum(np.where(bits > 0, -np.log2(p), -np.log2(1 - p))))

    def _chunk_bounds(self, level):
        """(want_lo, want_hi, clamped_start) per chunk of one 3D level."""
        t = self.ctx.tables3d[level]
        chunk_e, n_chunks, _ = self.chunks3d[level]
        out = []
        for c in range(n_chunks):
            want_lo = c * chunk_e
            want_hi = min((c + 1) * chunk_e, t.n_entries)
            out.append((want_lo, want_hi, min(want_lo, t.n_entries - chunk_e)))
        return out

    def _is_global_3d(self, l):
        return l in self.cfg.skip_levels_3d or l >= self.ctx.pg_level

    def _is_global_2d(self, l):
        return l in self.cfg.skip_levels_2d or l >= self.ctx.pg_level_2d

    # ---------------------------------------------------------------- encode
    def encode(self, ent_params, tables: Mapping[str, torch.Tensor], binaries: torch.Tensor,
               out_dir: str, prefix: str = "b", cache=None):
        """Write bitstreams; returns (pgs_dict, analytic_MB, actual_MB).

        `tables` are the binarized (+-1) tables {'xyz','xy','xz','yz'} on the
        model's device.  `cache`: a precomputed refresh_cache_int(binaries),
        for encode and decode back to back on the same occupancy."""
        ctx = self.ctx
        os.makedirs(out_dir, exist_ok=True)
        coder.get_lib()          # build the native coder before the workers start
        if cache is None:
            cache = ctx.refresh_cache_int(binaries)
        ip = self._int_params(ent_params)
        pgs: Dict[str, float] = {}
        checks: Dict[str, object] = {}
        est_bits = 0.0
        actual_bits = 0
        # host-side range coding overlaps the device's later pools (the
        # ctypes coder call releases the GIL)
        workers = concurrent.futures.ThreadPoolExecutor(max_workers=8)
        pending = []

        def path(name):
            return os.path.join(out_dir, f"{prefix}_{name}.b")

        def code_one(name, bits, pq):
            stream = coder.encode_bits(bits, pq)
            with open(path(name), "wb") as fh:
                fh.write(stream)
            return (name, hashlib.sha256(bits.tobytes()).hexdigest(),
                    self._analytic_bits(bits, pq), len(stream) * 8)

        def write(name, bits, pq):
            pending.append(workers.submit(code_one, name, np.ascontiguousarray(bits, np.uint8),
                                          pq))

        def write_global(name, bits, pg):
            write(name, bits, coder.quantize_probs(np.full(bits.size, np.float64(pg))))

        # every table's signs are known at encode time, so every pool (all 3D
        # chunks of all levels, 3 planes x ctx levels, the 3 frac planes) is
        # queued on the device before the first host pull
        f = self.cfg.n_features
        st3 = self._stats(tables["xyz"], ctx.spec3)
        st2 = {ax: self._stats(tables[ax], ctx.spec2) for ax in AXES}
        sign3 = intctx.sign_table(tables["xyz"])
        sums3 = st3[0].cpu().numpy()
        for l in range(ctx.spec3.n_levels):
            pgs[f"3D{l}"] = self._pg_from_sum(sums3[l], ctx.spec3.level_sizes[l] * f)
        outs3 = {}
        for l in range(ctx.spec3.n_levels):
            if not self._is_global_3d(l):
                pg_q = intctx.quantize_pg(pgs[f"3D{l}"])
                outs3[l] = [self._pool3d(l, ip, sign3, cache, pg_q, start)
                            for (_, _, start) in self._chunk_bounds(l)]
        plane_qs = {ax: self._frac(sign3, cache, ax) for ax in AXES}
        pool_outs = {}
        for ai, ax in enumerate(AXES):
            sign2 = intctx.sign_table(tables[ax])
            sums2 = st2[ax][0].cpu().numpy()
            for l in range(ctx.spec2.n_levels):
                pg = self._pg_from_sum(sums2[l], ctx.spec2.level_sizes[l] * f)
                pgs[f"{ax}{l}"] = pg
                if not self._is_global_2d(l):
                    pool_outs[(ax, l)] = self._pool2d(l, ip, sign2, intctx.quantize_pg(pg),
                                                      plane_qs[ax], cache["mask2d"][ai])

        # --- host pulls, in stream order
        self._check_pools()
        bits3 = np.unpackbits(st3[1].cpu().numpy())
        for l in range(ctx.spec3.n_levels):
            off, size = ctx.spec3.offsets[l], ctx.spec3.level_sizes[l]
            if self._is_global_3d(l):
                write_global(f"3D{l}", bits3[off * f:(off + size) * f], pgs[f"3D{l}"])
            else:
                self._pull_ctx3d_level(outs3[l], l, write)
        for ax in AXES:
            bits2 = np.unpackbits(st2[ax][1].cpu().numpy())
            for l in range(ctx.spec2.n_levels):
                off, size = ctx.spec2.offsets[l], ctx.spec2.level_sizes[l]
                if self._is_global_2d(l):
                    write_global(f"{ax}{l}", bits2[off * f:(off + size) * f], pgs[f"{ax}{l}"])
        for (ax, l), out in pool_outs.items():
            pq, cov, vbits = intctx.pull_probs(out)
            write(f"{ax}{l}", vbits[cov].reshape(-1), pq[cov].reshape(-1))

        for fut in pending:
            name, digest, eb, ab = fut.result()
            checks[name] = digest
            est_bits += eb
            actual_bits += ab
        workers.shutdown()
        checks["__format__"] = intctx.FORMAT_VERSION
        with open(os.path.join(out_dir, f"{prefix}_checks.json"), "w") as fh:
            json.dump(checks, fh, indent=0)
        return pgs, est_bits / 8 / 1024 / 1024, actual_bits / 8 / 1024 / 1024

    def _pull_ctx3d_level(self, outs, level, write):
        """Pull one level's chunk outputs and range-code them."""
        _, n_chunks, _ = self.chunks3d[level]
        for c, ((want_lo, want_hi, start), out) in \
                enumerate(zip(self._chunk_bounds(level), outs)):
            sl = slice(want_lo - start, want_hi - start)
            pq, cov, vbits = intctx.pull_probs(out)
            cov = cov[sl]
            write(f"3D{level}_{c}" if n_chunks > 1 else f"3D{level}",
                  vbits[sl][cov].reshape(-1), pq[sl][cov].reshape(-1))

    # ---------------------------------------------------------------- decode
    def decode(self, ent_params, binaries: torch.Tensor, pgs: Mapping[str, float], in_dir: str,
               prefix: str = "b", cache=None) -> Dict[str, torch.Tensor]:
        """Reconstruct all four tables from the bitstreams (lossless): float32
        +-1 tables on the model's device.

        Every decoded stream's symbol bits are checked against the sha256
        recorded at encode time ({prefix}_checks.json); any mismatch raises:
        a desynced range decode must never silently ship."""
        ctx = self.ctx
        dev = ctx.device
        checks_path = os.path.join(in_dir, f"{prefix}_checks.json")
        if not os.path.exists(checks_path):
            raise FileNotFoundError(
                f"{checks_path} missing: this bitstream directory predates "
                "the integer codec (round 3) or is incomplete — re-encode "
                "with the current codec; decoding without checksums could "
                "silently ship a desynced reconstruction")
        with open(checks_path) as fh:
            checks = json.load(fh)
        ver = checks.pop("__format__", None)
        if ver != intctx.FORMAT_VERSION:
            raise ValueError(
                f"bitstream format v{ver} != codec format "
                f"v{intctx.FORMAT_VERSION}: the integer context pipeline "
                "changed since this bundle was encoded — re-encode it")
        if cache is None:
            cache = ctx.refresh_cache_int(binaries)
        ip = self._int_params(ent_params)
        bad: List[str] = []

        def read(name):
            with open(os.path.join(in_dir, f"{prefix}_{name}.b"), "rb") as fh:
                return fh.read()

        def verify(name, bits):
            want = checks.get(name)
            if want is not None and hashlib.sha256(
                    np.ascontiguousarray(bits, np.uint8).tobytes()).hexdigest() != want:
                bad.append(name)

        def decode_global(name, size, pg):
            pq = coder.quantize_probs(np.full(size, np.float64(pg)))
            bits = coder.decode_bits(read(name), pq)
            verify(name, bits)
            return bits.astype(np.int32) * 2 - 1

        def put(rec, idx, sym):
            """rec[idx] = sym, one index_copy_ (idx unique)."""
            if idx.size:
                rec.index_copy_(0, torch.from_numpy(idx.astype(np.int64)).to(dev),
                                torch.from_numpy(sym).to(dev))

        f = self.cfg.n_features
        rec3 = torch.ones((ctx.spec3.total_entries, f), dtype=torch.int32, device=dev)
        for l in range(ctx.spec3.n_levels):
            off, size = ctx.spec3.offsets[l], ctx.spec3.level_sizes[l]
            pg = float(pgs[f"3D{l}"])
            if self._is_global_3d(l):
                sym = decode_global(f"3D{l}", size * f, pg)
                rec3[off:off + size] = torch.from_numpy(sym.reshape(size, f)).to(dev)
            else:
                self._decode_ctx3d_level(ip, rec3, cache, l, pg, read, verify, put)

        recs = {"xyz": rec3}
        # the three planes are independent decode chains (each level's
        # context reads only its plane's coarser levels plus rec3), so the 2D
        # decode runs level-major: every level, all three planes' pools are
        # queued before any is pulled
        rec2s = {ax: torch.ones((ctx.spec2.total_entries, f), dtype=torch.int32, device=dev)
                 for ax in AXES}
        plane_qs = {ax: self._frac(rec3, cache, ax) for ax in AXES}
        for l in range(ctx.spec2.n_levels):
            off, size = ctx.spec2.offsets[l], ctx.spec2.level_sizes[l]
            if self._is_global_2d(l):
                for ax in AXES:
                    sym = decode_global(f"{ax}{l}", size * f, float(pgs[f"{ax}{l}"]))
                    rec2s[ax][off:off + size] = torch.from_numpy(sym.reshape(size, f)).to(dev)
                continue
            t = ctx.tables2d[l]
            outs = {ax: self._pool2d(l, ip, rec2s[ax], intctx.quantize_pg(float(pgs[f"{ax}{l}"])),
                                     plane_qs[ax], cache["mask2d"][ai], with_bits=False)
                    for ai, ax in enumerate(AXES)}
            self._check_pools()
            for ax in AXES:
                pq, cov, _ = intctx.pull_probs(outs[ax])
                pq = pq[cov].reshape(-1)
                name = f"{ax}{l}"
                bits = coder.decode_bits(read(name), pq)
                verify(name, bits)
                put(rec2s[ax], t.offset + ctx.entry_values_np("2d", l)[cov],
                    (bits.astype(np.int32) * 2 - 1).reshape(-1, f))
        recs.update(rec2s)
        if bad:
            raise ValueError(
                f"codec desync: decoded symbols of stream(s) {sorted(bad)} "
                "do not match the checksums recorded at encode time — the "
                "bitstream directory is corrupt or was written by an "
                "incompatible codec version")
        return {k: v.to(torch.float32) for k, v in recs.items()}

    def _decode_ctx3d_level(self, ip, rec3, cache, level, pg, read, verify, put):
        """Decode one context level into rec3, in place.

        The level -> level dependency is strict (context reads the decoded
        coarser levels), but within a level every chunk's context depends
        only on rec3 as it stands: all chunk pools are queued first, and the
        decoded symbols land in one index_copy_ at the level's end."""
        ctx = self.ctx
        t = ctx.tables3d[level]
        f = self.cfg.n_features
        _, n_chunks, _ = self.chunks3d[level]
        pg_q = intctx.quantize_pg(pg)
        evals = ctx.entry_values_np("3d", level)
        bounds = self._chunk_bounds(level)
        outs = [self._pool3d(level, ip, rec3, cache, pg_q, start, with_bits=False)
                for (_, _, start) in bounds]
        self._check_pools()
        idx_all, sym_all = [], []
        for c, ((want_lo, want_hi, start), out) in enumerate(zip(bounds, outs)):
            sl = slice(want_lo - start, want_hi - start)
            pq, cov, _ = intctx.pull_probs(out)
            cov = cov[sl]
            pq = pq[sl][cov].reshape(-1)
            suffix = f"3D{level}_{c}" if n_chunks > 1 else f"3D{level}"
            bits = coder.decode_bits(read(suffix), pq)
            verify(suffix, bits)
            idx_all.append(t.offset + evals[want_lo:want_hi][cov])
            sym_all.append((bits.astype(np.int32) * 2 - 1).reshape(-1, f))
        if idx_all:
            put(rec3, np.concatenate(idx_all), np.concatenate(sym_all))


# ----------------------------------------------------------------- bundling
def _leaves(tree: Mapping, path=()):
    """(path, leaf) pairs in sorted-key order (jax.tree's order for dicts)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def quantize_mlp_params(params_tree: Mapping, digits: int = 13):
    """Min/interval quantization of MLP weights (driver quantize_params,
    train_CNC_nerf_synthetic.py:30-50), in numpy on float32 arrays as
    cnc_tpu's.  Returns (MB, MB_orig, quantized tree of the same nesting)."""
    bits = 0
    bits_orig = 0
    out: Dict = {}
    for path, p in _leaves(params_tree):
        p = p.detach().cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        mn, mx = p.min(), p.max()
        scales = 2 ** digits - 1
        interval = (mx - mn) / scales + 1e-6
        q = np.floor((p - mn) / interval)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (q * interval + mn).astype(np.float32)
        bits += digits * p.size + 64
        bits_orig += 32 * p.size
    return bits / 8 / 1024 / 1024, bits_orig / 8 / 1024 / 1024, out


def save_bundle(out_dir: str, pgs: Mapping[str, float], ent_params, mlp_params, binaries,
                extra_meta: Optional[dict] = None):
    """Make the bitstream directory self-contained: the Pg dictionary, the
    context-model weights, the rendering MLPs and the occupancy grid in
    meta.npz (leaves under the keys cnc_tpu's checkpoint._flatten writes),
    the config in meta.json.

    ent_params: a ContextParams or cnc_tpu's nested dict; mlp_params: a
    RadianceField or {"mlp_base": ..., "mlp_head": ...} of arrays."""
    from ..models import radiance_field as rf
    from ..utils import checkpoint as ckpt

    if isinstance(ent_params, nn.Module):
        ent_params = ContextModels.ent_params_to_numpy(ent_params)
    if isinstance(mlp_params, nn.Module):
        mlp_params = rf.mlp_params_to_numpy(mlp_params)
    b = binaries.detach().cpu().numpy() if isinstance(binaries, torch.Tensor) \
        else np.asarray(binaries)
    payload = {
        "pgs_keys": np.asarray(list(pgs.keys())),
        "pgs_vals": np.asarray([pgs[k] for k in pgs], np.float32),
        "binaries": np.packbits(b.reshape(-1)),
        "binaries_shape": np.asarray(b.shape),
    }
    payload.update(ckpt._flatten(ent_params, "ent"))
    payload.update(ckpt._flatten(mlp_params, "mlp"))
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(out_dir, "meta.npz"), **payload)
    if extra_meta:
        with open(os.path.join(out_dir, "meta.json"), "w") as fh:
            json.dump(extra_meta, fh, indent=1)


def load_bundle(out_dir: str):
    """Read the bundle back: (pgs, ent_params, mlp_params, binaries), the
    params as nested dicts of numpy arrays in cnc_tpu's layout and the
    occupancy grid as a numpy bool array."""
    from ..utils import checkpoint as ckpt

    with np.load(os.path.join(out_dir, "meta.npz"), allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    pgs = {str(k): float(v) for k, v in zip(data["pgs_keys"], data["pgs_vals"])}
    shape = tuple(int(x) for x in data["binaries_shape"])
    n = int(np.prod(shape))
    binaries = np.unpackbits(data["binaries"])[:n].reshape(shape).astype(bool)
    return pgs, ckpt._nest(data, "ent"), ckpt._nest(data, "mlp"), binaries


def bundle_size_mb(out_dir: str) -> float:
    total = 0
    for f in pathlib.Path(out_dir).iterdir():
        if f.suffix == ".b" or f.name == "meta.npz":
            total += f.stat().st_size
    return total / 1024 / 1024
