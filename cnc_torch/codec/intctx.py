"""Deterministic integer context inference for the codec path.

Port of `cnc_tpu/codec/intctx.py`, with the same constants and
FORMAT_VERSION.  The range coder desyncs if encode and decode disagree on a
single quantized probability, so the codec's whole probability computation
is re-expressed in integers, identical in every process, on every device and
in both packages:

  * interpolation weights from exact integer divmod on lattice coordinates
    (per-axis 5-bit fixed point),
  * the context MLPs in fixed point (weights rounded once on the host with
    float64 `rint`, activations at 1/256 steps, LeakyReLU as an integer
    multiply and floor division),
  * overlap-area pooling weights from integer summed-area pools,
  * per-entry pooling with int32 sums,
  * the final uint16 coder probability from one exact division.

Every `//` here floors, as JAX's does on int32 (torch's `//` floors too; the
CUDA kernels use one `floordiv` helper, since C++ division truncates).

Two kinds of function live here.  The plain twins keep cnc_tpu's order of
operations in torch int32 (`int_encode_levels`, `int_encode_plane`,
`int_apply_ctx3d/2d`, `segment_sum_int`, `device_pq`, `int_frac_plane`,
`int_overlap_grid`); they are the CPU path and the oracle the kernels are
held to on the card.  The dispatching wrappers (`int_ctx_pool`, one codec
pool: the context encode, the MLP and the pooling of a window's kept rows;
`int_ctx_pool_pq`, the same pool finished into the coder's probabilities
(K9c) in the same launch; `frac_plane` K7i) take the plain twins for CPU
tensors and launch the kernels of csrc/int_context.cu and csrc/pn_hist.cu
for CUDA tensors.  `int_encode`, `int_mlp_pool` and `int_pq`, the encode,
the MLP with its pooling over whole windows and K9c alone, are twins only
(`int_ctx_pool_plain` is built from the first two) and refuse CUDA
tensors.  The host steps that define the format
(`quantize_ctx_params`, `quantize_pg`, `host_pq`, the overlap grid's bounds)
stay numpy float64 / int64, copied as they are.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops import hash_ops

# EVERY constant and arithmetic step below is bitstream-format-defining:
# changing any of them desyncs decode of existing bundles (the per-stream
# checksums catch it loudly).  Bump FORMAT_VERSION on any change, in both
# packages.
FORMAT_VERSION = 3

Q_AXIS = 32            # per-axis interp weight quantization (5 bits)
Q_FEAT = 256           # feature scale: 1.0 == 256
Q_W = 512              # MLP weight scale
H_CLIP = 1 << 12       # hidden activation clip (+-16.0 at Q_FEAT)
M_SHIFT = 6            # acc3 (scale Q_FEAT*Q_W) >> 6 -> output scale 2**11
M_SCALE = Q_FEAT * Q_W >> M_SHIFT   # == 2048
M_CLIP = 1 << 14       # output clip (+-8.0 at M_SCALE)
W_MAX = 7.9            # quantizable MLP |weight| bound (keeps acc < 2**30)
OVL_BITS = 6           # overlap pooling weights in [1, 63]

# one context level of an integer encode: (resolution, table offset, table
# size, offset of its mask grid in the flat mask)
LevelMeta = Tuple[int, int, int, int]


# ------------------------------------------------------------ param quant
def quantize_ctx_params(ent_params: Mapping) -> Dict:
    """Fixed-point context-MLP weights, rounded ONCE on the host.

    `ent_params` is the nested mapping of arrays in cnc_tpu's layout
    ({"ctx3d": {"l0": {"w", "b"}, ...}, "ctx2d": {"1": {...}}}).  np.rint on
    float64 is a single correctly-rounded IEEE op per element, so any machine
    derives the identical integer weights from the float32 params stored in
    the bundle.
    """
    def q(leaf, scale):
        a = np.asarray(leaf, np.float64)
        m = float(np.max(np.abs(a))) if a.size else 0.0
        if m > W_MAX:
            raise ValueError(
                f"context-MLP weight magnitude {m:.2f} exceeds {W_MAX}; "
                "int codec path would overflow — retrain or rescale")
        return np.rint(a * scale).astype(np.int32)

    out = {"ctx3d": {}, "ctx2d": {}}
    for lname, lin in ent_params["ctx3d"].items():
        out["ctx3d"][lname] = {"w": q(lin["w"], Q_W), "b": q(lin["b"], Q_FEAT * Q_W)}
    for lvl, lin in ent_params["ctx2d"].items():
        out["ctx2d"][str(lvl)] = {"w": q(lin["w"], Q_W), "b": q(lin["b"], Q_FEAT * Q_W)}
    return out


def quantize_pg(pg: float) -> int:
    """Global-probability feature at Q_FEAT (host float64 rint)."""
    return int(np.rint(np.float64(pg) * Q_FEAT))


def sign_table(tbl: torch.Tensor) -> torch.Tensor:
    """float (+-1) table -> int32 sign table (+1 where > 0)."""
    return torch.where(tbl > 0, 1, -1).to(torch.int32)


# ------------------------------------------------------------- int interp
def _axis_interp(c: torch.Tensor, rf: int, rc: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact lattice->lattice interp: coord c on an rf-grid evaluated on an
    rc-grid.  x = ((2c-1)(rc-2) + (rf-2)) / (2(rf-2)); returns (floor(x),
    round(frac(x) * Q_AXIS)) as int32.  The numerator is negative at c = 0
    when the target grid is finer; `//` floors it."""
    den = 2 * (rf - 2)
    num = (2 * c - 1) * (rc - 2) + (rf - 2)
    pgc = num // den
    rem = num - pgc * den
    fq = (rem * Q_AXIS + den // 2) // den
    return pgc.to(torch.int32), fq.to(torch.int32)


def _oob(coords: torch.Tensor, rf: int) -> torch.Tensor:
    oob = torch.zeros(coords.shape[0], dtype=torch.bool, device=coords.device)
    for ax in range(coords.shape[1]):
        oob = oob | (coords[:, ax] == 0) | (coords[:, ax] >= rf - 1)
    return oob


def int_encode_levels(coords: torch.Tensor, rf: int, sign_tbl: torch.Tensor,
                      levels: Sequence[LevelMeta], occ_mask: torch.Tensor,
                      touched: Optional[Dict[str, List[torch.Tensor]]] = None) -> torch.Tensor:
    """Integer context features for lattice vertices against coarser levels.

    coords [N, D] int32 lattice coords of the level being coded (res rf);
    sign_tbl [total, F] int32 +-1; levels: per context level (rc, offset,
    hashmap_size, mask_offset); occ_mask the flat bool per-corner masks.
    Returns [N, len(levels)*F] int32 features at Q_FEAT, level-major, zero at
    out-of-bounds vertices (coord 0 or rf-1 on any axis).  `touched`, when
    given, collects what a kernel must read: under "mask" the mask indices of
    the corners off the border, under "rows" the table rows of the corners
    that pass the mask too.
    """
    n, d = coords.shape
    f = sign_tbl.shape[-1]
    dev = coords.device
    oob = _oob(coords, rf)
    feats = []
    for (rc, offset, hs, moff) in levels:
        pgc_l, fq_l = [], []
        for ax in range(d):
            pgc, fq = _axis_interp(coords[:, ax], rf, rc)
            pgc_l.append(pgc)
            fq_l.append(fq)
        acc = torch.zeros((n, f), dtype=torch.int32, device=dev)
        wsum = torch.zeros(n, dtype=torch.int32, device=dev)
        for corner in range(1 << d):
            cc = []
            w = torch.ones(n, dtype=torch.int32, device=dev)
            for ax in range(d):
                if (corner >> ax) & 1:
                    cc.append(torch.clamp(pgc_l[ax] + 1, max=rc - 1))
                    w = w * fq_l[ax]
                else:
                    cc.append(pgc_l[ax])
                    w = w * (Q_AXIS - fq_l[ax])
            # pgc can be -1 at oob vertices (coord 0 when rc > rf); those rows
            # are zeroed below, but every gather index is clamped in bounds
            cc = torch.clamp(torch.stack(cc, -1), 0, rc - 1)
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            for ax in range(d):
                valid = valid & (cc[:, ax] != 0) & (cc[:, ax] != rc - 1)
            flat = cc[:, 0].long()
            for ax in range(1, d):
                flat = flat * rc + cc[:, ax]
            if touched is not None:
                touched.setdefault("mask", []).append((moff + flat)[valid])
            valid = valid & occ_mask[moff + flat]
            idx = hash_ops.grid_index(cc, rc, hs)
            if touched is not None:
                touched.setdefault("rows", []).append((idx + offset)[valid])
            w = torch.where(valid, w, 0)
            rows = torch.clamp(torch.where(valid, idx + offset, 0), 0, sign_tbl.shape[0] - 1)
            acc = acc + w[:, None] * sign_tbl.index_select(0, rows)
            wsum = wsum + w
        feat = torch.where(wsum[:, None] > 0,
                           (acc * Q_FEAT) // torch.clamp(wsum, min=1)[:, None], 0)
        feats.append(torch.where(oob[:, None], 0, feat))
    if not feats:
        return torch.zeros((n, 0), dtype=torch.int32, device=dev)
    return torch.cat(feats, dim=-1)


def int_encode_plane(coords: torch.Tensor, rf: int, plane_q: torch.Tensor, pn_res: int,
                     occ_mask: torch.Tensor, mask_offset: int,
                     touched: Optional[Dict[str, List[torch.Tensor]]] = None) -> torch.Tensor:
    """Integer bilinear lookup of a dense x-fastest plane (values at Q_FEAT):
    the dimension-wise prior read.  [N, F] int32.  `touched` as in
    `int_encode_levels` ("mask", and the plane's rows under "plane_rows")."""
    n = coords.shape[0]
    f = plane_q.shape[-1]
    dev = coords.device
    oob = _oob(coords, rf)
    interp = [_axis_interp(coords[:, ax], rf, pn_res) for ax in range(2)]
    acc = torch.zeros((n, f), dtype=torch.int32, device=dev)
    wsum = torch.zeros(n, dtype=torch.int32, device=dev)
    for corner in range(4):
        cc, w = [], torch.ones(n, dtype=torch.int32, device=dev)
        for ax in range(2):
            pgc, fq = interp[ax]
            if (corner >> ax) & 1:
                cc.append(torch.clamp(pgc + 1, max=pn_res - 1))
                w = w * fq
            else:
                cc.append(pgc)
                w = w * (Q_AXIS - fq)
        cc = torch.clamp(torch.stack(cc, -1), 0, pn_res - 1).long()
        valid = ((cc[:, 0] != 0) & (cc[:, 0] != pn_res - 1) &
                 (cc[:, 1] != 0) & (cc[:, 1] != pn_res - 1))
        midx = mask_offset + cc[:, 0] * pn_res + cc[:, 1]
        if touched is not None:
            touched.setdefault("mask", []).append(midx[valid])
        valid = valid & occ_mask[midx]
        # dense x-fastest table index (hash_ops.dense_index convention)
        idx = cc[:, 0] + cc[:, 1] * pn_res
        if touched is not None:
            touched.setdefault("plane_rows", []).append(idx[valid])
        w = torch.where(valid, w, 0)
        rows = torch.clamp(torch.where(valid, idx, 0), 0, plane_q.shape[0] - 1)
        acc = acc + w[:, None] * plane_q.index_select(0, rows)
        wsum = wsum + w
    feat = torch.where(wsum[:, None] > 0, acc // torch.clamp(wsum, min=1)[:, None], 0)
    return torch.where(oob[:, None], 0, feat)


# ------------------------------------------------------------- int MLPs
def _int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[N,K]@[K,M] in int32 by an unrolled K loop (exact by construction;
    K <= 33 everywhere, every partial sum < 2**30 under W_MAX)."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int32, device=x.device)
    for k in range(w.shape[0]):
        acc = acc + x[:, k:k + 1] * w[k][None, :]
    return acc


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around, as XLA's int32 ops
    wrap (done explicitly: torch leaves int32 overflow to the C++ compiler)."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _int_leaky(x: torch.Tensor) -> torch.Tensor:
    # alpha = 41/4096 ~ 0.01 (the float path's LeakyReLU slope).  x * 41
    # leaves int32 for hidden sums below -2**31/41 (weights near W_MAX); the
    # format is XLA's wrapped product, so it wraps here too
    return torch.where(x >= 0, x, _wrap_int32(x.long() * 41) // 4096)


def int_apply_ctx3d(ip: Mapping, x: torch.Tensor) -> torch.Tensor:
    """Fixed-point MLP(3F+1 -> 32 -> 32 -> F); input at Q_FEAT, output at
    M_SCALE (clipped to +-M_CLIP)."""
    h = _int_leaky(_int_matmul(x, ip["l0"]["w"]) + ip["l0"]["b"][None, :])
    h = torch.clamp(h // Q_W, -H_CLIP, H_CLIP)
    h = _int_leaky(_int_matmul(h, ip["l1"]["w"]) + ip["l1"]["b"][None, :])
    h = torch.clamp(h // Q_W, -H_CLIP, H_CLIP)
    out = _int_matmul(h, ip["l2"]["w"]) + ip["l2"]["b"][None, :]
    return torch.clamp(out // (1 << M_SHIFT), -M_CLIP, M_CLIP)


def int_apply_ctx2d(ip: Mapping, level: int, x: torch.Tensor) -> torch.Tensor:
    lin = ip[str(level)]
    out = _int_matmul(x, lin["w"]) + lin["b"][None, :]
    return torch.clamp(out // (1 << M_SHIFT), -M_CLIP, M_CLIP)


# --------------------------------------------------------- overlap weights
@functools.lru_cache(maxsize=None)
def _overlap_bounds(r: int, rb: int):
    """The footprint bounds of int_overlap_grid, host float64 (format-defining)."""
    c = np.arange(r, dtype=np.float64)
    scale_re = 1.0 / (r - 2.0)
    pn = (c - 0.5) * scale_re
    a_f = np.clip(pn - scale_re, 0.0, 1.0) * rb
    b_f = np.clip(pn + scale_re, 0.0, 1.0) * rb
    a_i = np.clip(np.floor(a_f), 0, rb - 1).astype(np.int32)
    b_i = np.clip(np.floor(b_f), 0, rb - 1).astype(np.int32)
    a_q = np.rint((a_f - a_i) * Q_AXIS).astype(np.int32)
    b_q = np.rint((b_f - b_i) * Q_AXIS).astype(np.int32)
    a_i1 = np.minimum(a_i + 1, rb)
    b_i1 = np.minimum(b_i + 1, rb)
    span = int(np.max(b_i - a_i)) + 1
    return a_i, a_i1, a_q, b_i, b_i1, b_q, span


def int_overlap_grid(binaries: torch.Tensor, resolution: int, rb: int) -> torch.Tensor:
    """Integer overlap-volume pooling weights for one 3D context level.

    The footprint bounds are quantized once on the host (float64, identical
    everywhere) to Q_AXIS sub-steps and three separable pools run in int32.
    Returns flat [r**3] weights (last axis fastest) in [0, 2**OVL_BITS).
    Runs once per cache build: three integer cumulative sums, plain torch.
    """
    r = resolution
    dev = binaries.device
    a_i, a_i1, a_q, b_i, b_i1, b_q, span = _overlap_bounds(r, rb)
    idx = {k: torch.from_numpy(v.astype(np.int64)).to(dev)
           for k, v in (("a_i", a_i), ("a_i1", a_i1), ("b_i", b_i), ("b_i1", b_i1))}
    qw = {k: torch.from_numpy(v).to(dev).reshape(r, 1, 1) for k, v in (("a", a_q), ("b", b_q))}

    def pool0(x):
        s = torch.cumsum(x, dim=0, dtype=torch.int32)
        s = torch.cat([torch.zeros_like(s[:1]), s], dim=0)

        def at(i0, i1, q):
            return s[idx[i0]] * (Q_AXIS - qw[q]) + s[idx[i1]] * qw[q]

        return at("b_i", "b_i1", "b") - at("a_i", "a_i1", "a")

    # static per-axis bound tracking: values stay <= bound, so the in-pool
    # cumsum*weight product stays <= bound * rb * Q_AXIS; shifting the bound
    # to 2**12 after each axis keeps that product under 2**24
    val = binaries.to(torch.int32)
    bound = 1
    for _ in range(3):
        val = torch.movedim(pool0(val), 0, -1)
        bound = bound * Q_AXIS * span
        if bound > (1 << 18):
            s = bound.bit_length() - 12
            val = val // (1 << s)
            bound >>= s
    # final: bring the (conservative) bound under 2**OVL_BITS
    s = max(0, bound.bit_length() - OVL_BITS)
    return (val // (1 << s)).reshape(-1).contiguous()


# ------------------------------------------------------------- frac plane
def int_frac_plane(sign3: torch.Tensor, pn_ax: Mapping, fine_offset: int, pn_res: int,
                   f: int) -> torch.Tensor:
    """Integer dimension-wise prior plane [pn_res**2, F] at Q_FEAT
    (pn_frac_plane's codec-side twin: full coverage, integer sign counts),
    laid out x-fastest with a zero border."""
    scale = pn_res - 2
    eidx = pn_ax["entry_idx"]
    bounds = pn_ax["bounds"].long()
    n = pn_ax["n"]
    cap = eidx.shape[0]
    valid = torch.arange(cap, device=eidx.device) < torch.clamp(n, max=cap)
    rows = torch.clamp(fine_offset + eidx.long(), 0, sign3.shape[0] - 1)
    svals = (sign3.index_select(0, rows) > 0).to(torch.int32)
    svals = torch.where(valid[:, None], svals, 0)
    cols = []
    for fi in range(f):
        cs = torch.cat([torch.zeros(1, dtype=torch.int32, device=eidx.device),
                        torch.cumsum(svals[:, fi], 0, dtype=torch.int32)])
        cols.append(cs[bounds[1:]] - cs[bounds[:-1]])
    pos = torch.stack(cols, -1)                                # [scale**2, F]
    cnt = (bounds[1:] - bounds[:-1]).to(torch.int32)[:, None]
    frac_q = (pos * Q_FEAT) // torch.clamp(cnt, min=1)
    plane = torch.nn.functional.pad(frac_q.reshape(scale, scale, f), (0, 0, 1, 1, 1, 1))
    return plane.transpose(0, 1).reshape(-1, f).contiguous()


# --------------------------------------------------------------- pooling
def segment_sum_int(x: torch.Tensor, seg: torch.Tensor, valid: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Int32 per-segment sums (exact => order-independent => deterministic);
    rows not valid, or whose id lies outside [0, num_segments), drop."""
    live = valid & (seg >= 0) & (seg < num_segments)
    seg_safe = torch.where(live, seg.long(), num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(x.shape[1:]), dtype=torch.int32,
                      device=x.device)
    mask = live if x.dim() == 1 else live[:, None]
    return out.index_add_(0, seg_safe, torch.where(mask, x, 0).to(torch.int32))[:num_segments]


def host_pq(msum: np.ndarray, wsum: np.ndarray, m_scale: int) -> np.ndarray:
    """uint16 coder probabilities from integer pooled sums (one int64 host
    division; pooled p = msum / (wsum * m_scale), pq = floor(p * 65536))."""
    num = msum.astype(np.int64) * 65536
    den = np.maximum(wsum.astype(np.int64), 1) * m_scale
    if msum.ndim == 2:
        den = den[:, None]
    return np.clip(num // den, 1, 65535).astype(np.uint16)


def device_pq(msum: torch.Tensor, wsum: torch.Tensor, m_scale: int) -> torch.Tensor:
    """host_pq as cnc_tpu computes it on the device: a chunked restoring long
    division over uint32 lanes (held here in int64 tensors, every value in
    [0, 2**32)), bit-identical to host_pq wherever wsum * m_scale < 2**27
    (the per-level m_shift budget)."""
    den = torch.clamp(wsum.long(), min=1) * m_scale
    if msum.dim() == 2:
        den = den[:, None]
    pos = msum > 0
    m = torch.where(pos, msum.long(), 0)
    # p >= 1 (msum >= den) clips to 65535; below, the quotient fits uint16
    sat = m >= den
    r = torch.where(sat, 0, m)
    q = torch.zeros_like(r)
    for c in (5, 5, 5, 1):      # 16 = 5+5+5+1; r < den < 2**27 => r<<5 fits
        r = r << c
        qc = r // den
        r = r - qc * den
        q = (q << c) | qc
    q = torch.where(sat, 65535, torch.clamp(q, 1, 65535))
    return torch.where(pos, q, 1).to(torch.uint16)


def pq_int64(msum: torch.Tensor, wsum: torch.Tensor, m_scale: int) -> torch.Tensor:
    """host_pq's formula in torch int64 ops (the yardstick K9c is timed against)."""
    den = torch.clamp(wsum.long(), min=1) * m_scale
    num = msum.long() * 65536
    return torch.clamp(num // (den[:, None] if msum.dim() == 2 else den), 1, 65535
                       ).to(torch.uint16)


# ====================================================== dispatching wrappers
def unpack_coords(packed: torch.Tensor, d: int, rf: int) -> torch.Tensor:
    """[N] int32 packed vertex ids -> [N, D] int32 lattice coords: the flat
    index with the last axis fastest (3D), or (x << 16) | y (2D)."""
    p = packed.long()
    if d == 3:
        c = torch.stack([p // (rf * rf), (p // rf) % rf, p % rf], -1)
    else:
        c = torch.stack([p >> 16, p & 0xFFFF], -1)
    return c.to(torch.int32)


def int_encode(packed: torch.Tensor, d: int, rf: int, sign_tbl: torch.Tensor,
               levels: Sequence[LevelMeta], occ_mask: torch.Tensor,
               plane: Optional[Tuple[torch.Tensor, int, int]] = None) -> torch.Tensor:
    """Integer context features of N vertices of an rf-lattice (the twin of
    the encode inside `int_ctx_pool`).

    packed [N] int32 vertex ids (see `unpack_coords`), sign_tbl [T, F] int32
    +-1, levels the context levels (`LevelMeta`), occ_mask the flat bool
    per-corner masks; plane, for a 2D level with the dimension-wise prior,
    (plane_q [pn_res**2, F] int32, pn_res, its mask offset).  Returns
    [N, len(levels)*F (+F)] int32 at Q_FEAT: `int_encode_levels`, then
    `int_encode_plane`.  CPU tensors only: on the card the encode runs inside
    `int_ctx_pool`'s kernel.
    """
    _refuse_cuda("int_encode", packed)
    return _int_encode_plain(packed, d, rf, sign_tbl, levels, occ_mask, plane)


def _int_encode_plain(packed, d, rf, sign_tbl, levels, occ_mask, plane=None, touched=None):
    coords = unpack_coords(packed, d, rf)
    feats = int_encode_levels(coords, rf, sign_tbl, levels, occ_mask, touched)
    if plane is not None:
        plane_q, pn_res, moff = plane
        feats = torch.cat([feats, int_encode_plane(coords, rf, plane_q, pn_res, occ_mask, moff,
                                                   touched)], dim=-1)
    return feats


def int_mlp_pool(ip: Mapping, level: Optional[int], feats: torch.Tensor, pg_q: int,
                 m_shift: int, mask: torch.Tensor, slots: torch.Tensor, n_e: int,
                 ovl: Optional[torch.Tensor] = None, pos: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-point context MLP and the per-entry integer pooling (the
    twin of the MLP and pooling inside `int_ctx_pool`).

    ip the quantized params ({"ctx3d": ..., "ctx2d": ...} of int32 tensors);
    level None for the 3D MLP (`int_apply_ctx3d`), else the 2D level
    (`int_apply_ctx2d`); feats [w, n] int32 (the MLP's input less the pg_q
    column); mask [w] bool, the rows that pool (window validity folded in);
    slots [w] entry ids in [0, n_e), sorted; ovl/pos, for overlap pooling,
    the level's int overlap grid and each row's flat lattice index.  Each
    row's weight is max(ovl[pos], 1) (or 1) where mask, else 0; its output
    floor-divided by 2**m_shift and scaled by the weight adds into its entry.
    Returns (msum [n_e, F] int32, wsum [n_e] int32).  CPU tensors only.
    """
    _refuse_cuda("int_mlp_pool", feats)
    return _int_mlp_pool_plain(ip, level, feats, pg_q, m_shift, mask, slots, n_e, ovl, pos)


def _int_mlp_pool_plain(ip, level, feats, pg_q, m_shift, mask, slots, n_e, ovl=None, pos=None):
    w = feats.shape[0]
    x = torch.cat([feats, torch.full((w, 1), pg_q, dtype=torch.int32, device=feats.device)], -1)
    mean = (int_apply_ctx3d(ip["ctx3d"], x) if level is None
            else int_apply_ctx2d(ip["ctx2d"], level, x))
    mean = mean // (1 << m_shift)
    if ovl is not None:
        wgt = torch.where(mask, torch.clamp(ovl[pos.long()], min=1), 0).to(torch.int32)
    else:
        wgt = mask.to(torch.int32)
    msum = segment_sum_int(mean * wgt[:, None], slots, mask, n_e)
    wsum = segment_sum_int(wgt, slots, mask, n_e)
    return msum, wsum


def _refuse_cuda(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        raise ValueError(f"{name}: a plain twin with no kernel of its own; on the card the "
                         "codec's pools run through int_ctx_pool and int_ctx_pool_pq")


def lattice_index(ids: torch.Tensor, d: int, rf: int) -> torch.Tensor:
    """[N] int64 flat lattice indices of packed vertex ids, last axis fastest
    (the layout of the mask grids): the id itself in 3D, x * rf + y in 2D."""
    p = ids.long()
    return p if d == 3 else (p >> 16) * rf + (p & 0xFFFF)


def int_ctx_pool(ip: Mapping, level: Optional[int], ids: torch.Tensor, slots: torch.Tensor,
                 start_e: int, n_e: int, rf: int, occ_mask: torch.Tensor, mask_off: int,
                 sign_tbl: torch.Tensor, levels: Sequence[LevelMeta], pg_q: int, m_shift: int,
                 plane: Optional[Tuple[torch.Tensor, int, int]] = None,
                 ovl: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pool of the codec: the integer pooled sums of a run of entries.

    level None pools a 3D level through the 3D MLP, else the 2D `level`
    through its Linear.  ids [n] int32 the packed vertex ids of the entries
    [start_e, start_e + n_e) of one level (the window's own rows; see
    `unpack_coords`); slots [n] int32 their entry ids (start_e not yet
    subtracted), sorted.  A row is kept where occ_mask[mask_off +
    lattice_index(id)]; each kept row is encoded against `levels` (and
    `plane`) as `int_encode` does, run through the fixed-point MLP with pg_q
    as its last input, floor-divided by 2**m_shift, scaled by its weight
    (max(ovl[id], 1) with `ovl`, else 1) and added into its entry, as
    `int_mlp_pool` does.  Returns (msum [n_e, F], wsum [n_e]) int32.

    The kept rows' entries must lie in [start_e, start_e + n_e) and not
    decrease: the twin raises where they do not; the kernel sets a word of
    its device that `raise_on_pool_faults` reads and raises on (the codec
    reads it where it pulls the pools' results; no host sync here).  CPU
    tensors take the twin (`int_ctx_pool_plain`), CUDA tensors the kernel of
    csrc/int_context.cu (one launch).
    """
    if ids.is_cuda:
        return _int_ctx_pool_cuda(ip, level, ids, slots, start_e, n_e, rf, occ_mask, mask_off,
                                  sign_tbl, levels, pg_q, m_shift, plane, ovl)
    return int_ctx_pool_plain(ip, level, ids, slots, start_e, n_e, rf, occ_mask, mask_off,
                              sign_tbl, levels, pg_q, m_shift, plane, ovl)


def int_ctx_pool_plain(ip, level, ids, slots, start_e, n_e, rf, occ_mask, mask_off, sign_tbl,
                       levels, pg_q, m_shift, plane=None, ovl=None, touched=None):
    """`int_ctx_pool`'s twin: select the kept rows, then `_int_encode_plain`
    and `_int_mlp_pool_plain` over them.  `touched` as in
    `int_encode_levels`, for the kept rows."""
    d = 3 if level is None else 2
    keep = occ_mask[mask_off + lattice_index(ids, d, rf)]
    ids_k = ids[keep]
    slots_k = (slots[keep] - start_e).to(torch.int32)
    if slots_k.numel() and (bool((slots_k < 0).any()) or bool((slots_k >= n_e).any())
                            or bool((slots_k[1:] < slots_k[:-1]).any())):
        raise ValueError("int_ctx_pool: the kept rows' entries must lie in [start_e, start_e + "
                         "n_e) and must not decrease")
    feats = _int_encode_plain(ids_k, d, rf, sign_tbl, levels, occ_mask, plane, touched)
    kept = torch.ones(ids_k.shape[0], dtype=torch.bool, device=ids.device)
    return _int_mlp_pool_plain(ip, level, feats, pg_q, m_shift, kept, slots_k, n_e, ovl,
                               ids_k if ovl is not None else None)


class PoolProbs(tuple):
    """One finished pool, the triple (pq [n_e, F] uint16, covered [n_e] bool,
    bits [n_e, F] uint8 or None) that `int_pq` returns, as views of `raw`:
    one uint8 buffer that holds them (pq, bits, covered) and goes to the
    host in one copy (`pull_probs`)."""
    raw: torch.Tensor

    def __new__(cls, pq, covered, bits, raw):
        self = super().__new__(cls, (pq, covered, bits))
        self.raw = raw
        return self

    pq = property(lambda self: self[0])
    covered = property(lambda self: self[1])
    bits = property(lambda self: self[2])


def _probs_views(raw: torch.Tensor, n_e: int, f: int, with_bits: bool) -> PoolProbs:
    nb = f * n_e if with_bits else 0
    pq = raw[:2 * f * n_e].view(torch.uint16).view(n_e, f)
    bits = raw[2 * f * n_e:2 * f * n_e + nb].view(n_e, f) if with_bits else None
    covered = raw[2 * f * n_e + nb:2 * f * n_e + nb + n_e].view(torch.bool)
    return PoolProbs(pq, covered, bits, raw)


def pull_probs(p: PoolProbs) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """(pq, covered, bits or None) of a finished pool as numpy arrays, in one
    copy to the host."""
    raw = p.raw.cpu().numpy()
    n_e, f = p.pq.shape
    nb = f * n_e if p.bits is not None else 0
    pq = raw[:2 * f * n_e].view(np.uint16).reshape(n_e, f)
    bits = raw[2 * f * n_e:2 * f * n_e + nb].reshape(n_e, f) if p.bits is not None else None
    return pq, raw[2 * f * n_e + nb:2 * f * n_e + nb + n_e].view(np.bool_), bits


def int_ctx_pool_pq(ip: Mapping, level: Optional[int], ids: torch.Tensor, slots: torch.Tensor,
                    start_e: int, n_e: int, rf: int, occ_mask: torch.Tensor, mask_off: int,
                    sign_tbl: torch.Tensor, levels: Sequence[LevelMeta], pg_q: int,
                    m_shift: int, m_scale: int,
                    plane: Optional[Tuple[torch.Tensor, int, int]] = None,
                    ovl: Optional[torch.Tensor] = None, tbl_offset: int = 0,
                    evals: Optional[torch.Tensor] = None) -> PoolProbs:
    """One pool of the codec finished into the coder's probabilities:
    `int_ctx_pool`'s sums, then K9c (`int_pq`: pq with m_scale, covered and,
    with `evals`, the sign bits of sign_tbl's rows tbl_offset + evals [n_e]).

    The window must hold exactly the rows of its entries: slots run from
    start_e to start_e + n_e - 1 by steps of 0 or 1 (every entry has a row).
    The twin raises where they do not; the kernel checks the kept rows only
    (`int_ctx_pool`'s fault word, `raise_on_pool_faults`), and where the
    rest fails its outputs are undefined.  CPU
    tensors take the twins (`int_ctx_pool_plain`, then `_int_pq_plain`),
    CUDA tensors one launch of csrc/int_context.cu's pool, whose blocks
    finish their entries after their pooling.  Returns a `PoolProbs`.
    """
    fin = (int(m_scale), int(tbl_offset), evals)
    if ids.is_cuda:
        return _int_ctx_pool_cuda(ip, level, ids, slots, start_e, n_e, rf, occ_mask, mask_off,
                                  sign_tbl, levels, pg_q, m_shift, plane, ovl, fin)
    _check_window(slots, start_e, n_e)
    msum, wsum = int_ctx_pool_plain(ip, level, ids, slots, start_e, n_e, rf, occ_mask, mask_off,
                                    sign_tbl, levels, pg_q, m_shift, plane, ovl)
    pq, covered, bits = _int_pq_plain(msum, wsum, m_scale,
                                      sign_tbl if evals is not None else None, tbl_offset, evals)
    parts = [pq.view(torch.uint8).reshape(-1)] + ([bits.reshape(-1)] if bits is not None else [])
    raw = torch.cat(parts + [covered.view(torch.uint8)])
    return _probs_views(raw, n_e, sign_tbl.shape[1], bits is not None)


def _check_window(slots: torch.Tensor, start_e: int, n_e: int) -> None:
    step = slots[1:].long() - slots[:-1].long()
    if slots.shape[0] < n_e or (n_e and (
            int(slots[0]) != start_e or int(slots[-1]) != start_e + n_e - 1
            or bool(((step < 0) | (step > 1)).any()))):
        raise ValueError("int_ctx_pool_pq: the window's rows must be exactly those of entries "
                         "[start_e, start_e + n_e), sorted, each entry with at least one")


def int_pq(msum: torch.Tensor, wsum: torch.Tensor, m_scale: int,
           sign_tbl: Optional[torch.Tensor] = None, offset: int = 0,
           evals: Optional[torch.Tensor] = None):
    """K9c: the coder's uint16 probabilities from the pooled sums, each
    entry's coverage, and (with sign_tbl and evals) its symbols' sign bits.

    Returns (pq [n_e, F] uint16 = host_pq(msum, wsum, m_scale),
    covered [n_e] bool = wsum > 0, bits [n_e, F] uint8 = sign_tbl[offset +
    evals] > 0, or None), through the twins (`device_pq`).  CPU tensors
    only: on the card K9c runs in `int_ctx_pool_pq`'s launch.
    """
    _refuse_cuda("int_pq", msum)
    return _int_pq_plain(msum, wsum, m_scale, sign_tbl, offset, evals)


def _int_pq_plain(msum, wsum, m_scale, sign_tbl=None, offset=0, evals=None):
    bits = None
    if sign_tbl is not None:
        rows = torch.clamp(offset + evals.long(), 0, sign_tbl.shape[0] - 1)
        bits = (sign_tbl.index_select(0, rows) > 0).to(torch.uint8)
    return device_pq(msum, wsum, m_scale), wsum > 0, bits


def frac_plane(sign3: torch.Tensor, pn_ax: Mapping, fine_offset: int, pn_res: int,
               f: int) -> torch.Tensor:
    """K7i: the integer dimension-wise prior plane (`int_frac_plane`).  CPU
    tensors take the twin, CUDA tensors the integer mode of csrc/pn_hist.cu."""
    if sign3.is_cuda:
        return _frac_plane_cuda(sign3, pn_ax, fine_offset, pn_res, f)
    return int_frac_plane(sign3, pn_ax, fine_offset, pn_res, f)


# ------------------------------------------------------------ the launches
MAX_CTX_LEVELS = 4       # csrc/int_context.cu kMaxCtx
HIDDEN = 32              # csrc/int_context.cu kHidden, the 3D MLP's hidden width


def _check_int(name, *tensors):
    kernels.require_cuda(name, *tensors)
    for t in tensors:
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name}: expects int32 tensors, got {t.dtype}")


def _mlp_layers(ip, level):
    if level is None:
        return [ip["ctx3d"][k] for k in ("l0", "l1", "l2")]
    return [ip["ctx2d"][str(level)]]


# the packed weights of each MLP by the id of its first weight tensor: (a
# weak reference to that tensor, the ids and versions of all its tensors,
# the buffer, the widths).  Packing per call costs four device operations a
# pool (1.2 device ms over a pass's 126 pools on the H100).
_packed_cache: Dict[int, tuple] = {}


def _packed_params(ip, level, dev):
    """The layers' int32 weights and biases in one buffer on the device
    (w [in, out] row-major, then b, layer by layer), and the layer widths;
    made once per MLP while its tensors live unchanged."""
    layers = _mlp_layers(ip, level)
    leaves = [t for l in layers for t in (l["w"], l["b"])]
    stamp = tuple((id(t), t._version) for t in leaves)
    hit = _packed_cache.get(id(leaves[0]))
    if hit is not None and hit[0]() is leaves[0] and hit[1] == stamp and hit[2].device == dev:
        return hit[2], hit[3]
    for key in [k for k, v in _packed_cache.items() if v[0]() is None]:
        del _packed_cache[key]
    dims = [int(layers[0]["w"].shape[0])] + [int(l["w"].shape[1]) for l in layers]
    buf = torch.cat([torch.cat([l["w"].reshape(-1), l["b"].reshape(-1)]) for l in layers])
    buf = buf.to(dev, torch.int32).contiguous()
    _packed_cache[id(leaves[0])] = (weakref.ref(leaves[0]), stamp, buf, dims)
    return buf, dims


_interp_tables: Dict[tuple, torch.Tensor] = {}


def interp_table(rf: int, targets: Sequence[int], device) -> torch.Tensor:
    """The kernel's per-axis interpolation table: for each target grid rc in
    `targets` (the context levels' resolutions, then the prior plane's) and
    each coordinate c in [0, rf), `_axis_interp`'s (pgc, fq) packed as
    pgc * 64 + fq (fq in [0, Q_AXIS], pgc >= -1: `>> 6` and `& 63` unpack
    it).  [len(targets) * rf] int32, made once per device and grids."""
    key = (str(device), rf, tuple(targets))
    tab = _interp_tables.get(key)
    if tab is None:
        c = torch.arange(rf, dtype=torch.int64)
        parts = []
        for rc in targets:
            pgc, fq = _axis_interp(c, rf, rc)
            parts.append(pgc.long() * 64 + fq.long())
        tab = (torch.cat(parts) if parts else c[:0]).to(torch.int32)
        _interp_tables[key] = tab = tab.to(device)
    return tab


class _PoolWork:
    """Per device and stream: the kernel's block records and its finish
    counter (the kernel leaves it 0).  The launches that share them, being
    on one stream, run one at a time."""

    def __init__(self, device):
        words = kernels.lib().cnc_int_ctx_pool_scratch()
        self.records = torch.empty(words, dtype=torch.int32, device=device)
        self.counter = torch.zeros(1, dtype=torch.int32, device=device)


_pool_work: Dict[Tuple[torch.device, int], _PoolWork] = {}
# per device: the word every int_ctx_pool launch there sets when the kept
# rows' entries leave their range or decrease (set only)
_pool_faults: Dict[torch.device, torch.Tensor] = {}


def _pool_fault_word(device) -> torch.Tensor:
    key = torch.device(device)
    if key.index is None:
        key = torch.device(key.type, torch.cuda.current_device())
    word = _pool_faults.get(key)
    if word is None:
        word = _pool_faults[key] = torch.zeros(1, dtype=torch.int32, device=key)
    return word


def raise_on_pool_faults(device) -> None:
    """Raise (and clear the word) if an int_ctx_pool launch on the CUDA
    `device` met kept rows whose entries left their range or decreased
    since the word was last read; one host sync."""
    word = _pool_fault_word(device)
    if int(word[0]):
        word.zero_()
        raise ValueError("int_ctx_pool: the kept rows' entries must lie in [start_e, start_e + "
                         "n_e) and must not decrease")


def _int_ctx_pool_cuda(ip, level, ids, slots, start_e, n_e, rf, occ_mask, mask_off, sign_tbl,
                       levels, pg_q, m_shift, plane, ovl, fin=None):
    """One launch: (msum, wsum) views of one zeroed buffer or, with fin =
    (m_scale, tbl_offset, evals or None), a PoolProbs whose raw bytes follow
    the sums in that buffer."""
    d = 3 if level is None else 2
    plane_q = plane[0] if plane is not None else None
    evals = fin[2] if fin is not None else None
    _check_int("int_ctx_pool", ids, slots, sign_tbl, plane_q, ovl, evals)
    kernels.require_cuda("int_ctx_pool", ids, occ_mask)
    n, f, k = ids.shape[0], sign_tbl.shape[1], len(levels)
    dev = ids.device
    if occ_mask.dtype != torch.bool or slots.shape != (n,) or ids.dim() != 1:
        raise ValueError("int_ctx_pool: ids and slots [n] and a bool mask")
    if f not in (2, 4) or k > MAX_CTX_LEVELS or (d == 3 and (plane is not None or k < 1)):
        raise ValueError(f"int_ctx_pool: F = 2 or 4; in 3D 1 to {MAX_CTX_LEVELS} context levels "
                         f"and no plane, in 2D 0 to {MAX_CTX_LEVELS}")
    if sign_tbl.data_ptr() % (4 * f) or (plane_q is not None and (
            plane_q.data_ptr() % (4 * f) or plane_q.shape[1] != f)):
        raise ValueError(f"int_ctx_pool: tables of {4 * f}-byte aligned rows of F ints")
    params, dims = _packed_params(ip, level, dev)
    n_in = k * f + (f if plane is not None else 0) + 1
    want = [n_in, HIDDEN, HIDDEN, f] if d == 3 else [n_in, f]
    if dims != want:
        raise ValueError(f"int_ctx_pool: the MLP's widths {dims} differ from the kernel's {want}")
    if fin is not None and (n < n_e or fin[0] < 1 or (evals is not None and evals.shape != (n_e,))):
        raise ValueError("int_ctx_pool_pq: a row or more an entry, m_scale >= 1 and evals [n_e]")
    # the sums, then (finishing) the outputs from a 16-byte boundary: one
    # allocation and one memset a pool
    head = -(-n_e * (f + 1) * 4 // 16) * 16
    n_out = n_e * (3 * f + 1 if evals is not None else 2 * f + 1) if fin is not None else 0
    buf = torch.zeros(-(-(head + n_out) // 4), dtype=torch.int32, device=dev)
    msum, wsum = buf[:n_e * f].view(n_e, f), buf[n_e * f:n_e * (f + 1)]
    probs = None
    if fin is not None:
        probs = _probs_views(buf.view(torch.uint8)[head:head + n_out], n_e, f, evals is not None)
    if n == 0 or n_e == 0:
        return (msum, wsum) if fin is None else probs
    targets = [int(l[0]) for l in levels] + ([int(plane[1])] if plane is not None else [])
    tab = interp_table(rf, targets, dev)
    arr = lambda vals, ct: (ct * MAX_CTX_LEVELS)(*(list(vals) + [0] * (MAX_CTX_LEVELS - k)))
    res = arr((int(l[0]) for l in levels), ctypes.c_int)
    offs = arr((int(l[1]) for l in levels), ctypes.c_longlong)
    sizes = arr((int(l[2]) for l in levels), ctypes.c_longlong)
    moffs = arr((int(l[3]) for l in levels), ctypes.c_longlong)
    pn_res, plane_moff = (plane[1], plane[2]) if plane is not None else (0, 0)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    work = _pool_work.get(key)
    if work is None:
        work = _pool_work[key] = _PoolWork(dev)
    fault = _pool_fault_word(dev)
    p = kernels.ptr
    m_scale, tbl_offset = (fin[0], fin[1]) if fin is not None else (0, 0)
    kernels.call("cnc_int_ctx_pool", p(ids), p(slots), n, int(start_e), n_e, d, rf,
                 p(occ_mask), occ_mask.shape[0], int(mask_off), p(sign_tbl), sign_tbl.shape[0],
                 f, k, res, offs, sizes, moffs, p(plane_q), pn_res, plane_moff, p(tab),
                 p(params), params.numel(), int(pg_q), int(m_shift), p(ovl),
                 ovl.shape[0] if ovl is not None else 0, p(msum), p(wsum), p(work.records),
                 p(work.counter), p(fault), *((p(probs.pq), p(probs.covered), p(probs.bits))
                                              if fin is not None else (None,) * 3),
                 p(evals), tbl_offset, m_scale)
    kernels.launches["int_ctx_pool"] += 1
    if fin is None:
        return msum, wsum
    kernels.launches["int_pq"] += 1
    return probs


def _frac_plane_cuda(sign3, pn_ax, fine_offset, pn_res, f):
    eidx, bounds, n = pn_ax["entry_idx"], pn_ax["bounds"], pn_ax["n"]
    _check_int("pn_hist_int", sign3, eidx, bounds, n)
    scale = pn_res - 2
    if sign3.shape[1] != f or f not in (2, 4) or sign3.data_ptr() % (4 * f) or pn_res < 3 \
            or bounds.shape != (scale * scale + 1,) or n.numel() != 1 or eidx.dim() != 1 \
            or eidx.numel() < 1:
        raise ValueError("pn_hist_int: a sign table of 4F-byte aligned rows of F = 2 or 4 ints, "
                         "entry_idx [cap >= 1], bounds [(pn_res - 2)**2 + 1] and a one-element "
                         "count")
    plane = torch.empty((pn_res * pn_res, f), dtype=torch.int32, device=sign3.device)
    kernels.call("cnc_pn_hist_int", kernels.ptr(sign3), int(fine_offset), sign3.shape[0],
                 kernels.ptr(eidx), kernels.ptr(bounds), kernels.ptr(n), eidx.shape[0], pn_res,
                 f, kernels.ptr(plane))
    kernels.launches["pn_hist_int"] += 1
    return plane
