"""A frozen copy of the port's CNC context models, float path only, on
its plain twins (the benchmark's reference; see `twins/__init__.py`).

Reference CNC_context_models, examples/utils_bpp_acc.py:193-706: every
ragged structure is precomputed once into static sorted tables (vertex lists
sorted by hash entry, with per-vertex entry ordinals), so the per-step work
is gathers, pooled sums and dense math: 3D context levels over a sampled
entry window each, masked by the occupancy prior, compacted to a static
budget, encoded at mixed levels, pooled per entry by overlap-area weights
and billed with the Bernoulli model; the 2D tri-plane levels over their
block lattices; the dimension-wise prior's sign-fraction planes.  Skip
levels and levels beyond Pg_level are billed at the level's global
Bernoulli probability.  No data-parallel group and no codec here.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .config import EntropyConfig, GridSpec
from . import context_ops as cops
from . import encoding as enc
from . import entropy as ent_ops
from . import hash_ops
from . import scatter_ops
from . import threefry
from .device import resolve_device
from .radiance_field import Linear

AXES = ("xy", "xz", "yz")
_AXIS_DIMS = ((0, 1), (0, 2), (1, 2))


class Level3DTable(NamedTuple):
    """Static per-level vertex->entry metadata (utils_bpp_acc.py:296-348).

    The array data lives in the CONCATENATED buffers of
    ContextModels.table_arrays['3d'] (pos_flat / vert_entry sorted by entry;
    entry_values / cum padded to e_max per level); the static offsets here
    locate this level's slice.
    """
    level: int
    resolution: int
    offset: int                # into the flat hash table (spec offsets)
    n_entries: int             # exact distinct entries (data-dependent)
    n_vertices: int
    sample_n: int
    max_win_pts: int
    v_off: int                 # start into concat pos_flat / vert_entry
    e_off: int                 # start into concat entry_values
    c_off: int                 # start into concat cum (this level: e_max+1)
    e_max: int                 # padded entry capacity = min(table, V)


class Level2DTable(NamedTuple):
    """Static block-lattice metadata shared by the three planes (same
    concatenated-buffer layout as Level3DTable, in table_arrays['2d'])."""
    level: int
    resolution: int
    offset: int
    tile: int                  # T = (res-2)/Rb
    n_points: int
    n_entries: int
    sample_n: int
    max_win_pts: int
    v_off: int
    e_off: int
    c_off: int
    e_max: int


def _window_slices(a: Mapping[str, torch.Tensor], names, v_off: int, start_v: int, end_v: int,
                   w: int, v_total: int):
    """Slice [start_v, start_v+w) of each named level buffer, end-safe.

    A window of static capacity w whose start lies near the end of the
    level's vertex segment would run past the level (and, for the last
    level, past the buffer).  The start is clamped to min(start_v,
    v_total - w) and a `valid` mask marks the true [start_v, end_v) window
    inside the shifted slice, so callers stay exact for every window
    position.  Shifted-in head elements carry slots of earlier entries
    (clipped by callers) and are valid=False.
    """
    start_c = min(start_v, v_total - w)
    outs = [a[n][v_off + start_c:v_off + start_c + w] for n in names]
    i = torch.arange(w, device=outs[0].device)
    shift = start_v - start_c
    valid = (i >= shift) & (i < shift + (end_v - start_v))
    return outs, valid


class ContextParams(nn.Module):
    """The context MLPs: `ctx3d` (l0..l2, MLP(kF+1 -> 32 -> 32 -> F),
    LeakyReLU, utils_bpp_acc.py:378-384) and `ctx2d` (one Linear per context
    level, :386-393), each layer with `w` stored [in, out]."""

    def __init__(self, ctx3d: Mapping[str, Linear], ctx2d: Mapping[str, Linear]):
        super().__init__()
        self.ctx3d = nn.ModuleDict(ctx3d)
        self.ctx2d = nn.ModuleDict(ctx2d)


class ContextModels:
    """CNC entropy model over four binarized hash tables.

    Hosts the static tables, the occupancy cache and the differentiable
    training rate estimate.  Lives on `device` (default cuda; raises when
    there is none and `device="cpu"` was not asked for).
    """

    def __init__(self, ecfg: EntropyConfig, spec3: GridSpec, spec2: GridSpec, device=None):
        self.cfg = ecfg
        self.spec3 = spec3
        self.spec2 = spec2
        self.rb = ecfg.Rb
        self.device = resolve_device(device)
        f = ecfg.n_features
        assert spec3.n_features == f and spec2.n_features == f

        pg3 = ecfg.Pg_level
        if pg3 < 0 or pg3 >= spec3.n_levels:
            pg3 = spec3.n_levels
        self.pg_level = max(pg3, 1)
        pg2 = ecfg.Pg_level_2D
        if pg2 < 0 or pg2 >= spec2.n_levels:
            pg2 = spec2.n_levels
        self.pg_level_2d = max(pg2, 1)

        self.ctx_levels_3d = [l for l in range(self.pg_level) if l not in ecfg.skip_levels_3d]
        # context encodes read the k strictly-coarser levels (utils_bpp_acc.py
        # :684-685); the reference guarantees l >= k via its skip levels
        for l in self.ctx_levels_3d:
            if l < ecfg.max_context_layer_num:
                raise ValueError(
                    f"3D context level {l} < max_context_layer_num "
                    f"{ecfg.max_context_layer_num}; add it to skip_levels_3d")
        self.ctx_levels_2d = [l for l in range(self.pg_level_2d) if l not in ecfg.skip_levels_2d]

        self._build_tables()

        # totals for the extrapolation (utils_bpp_acc.py:350-366)
        self.ttl_entries_valid_3d = sum(self.tables3d[l].n_entries for l in self.ctx_levels_3d)
        self.ttl_sample_valid_3d = sum(self.tables3d[l].sample_n for l in self.ctx_levels_3d)
        self.v_window_total = sum(self.tables3d[l].max_win_pts for l in self.ctx_levels_3d)

        # finest-level info for the dimension-wise prior
        self.fine_res = spec3.resolutions[-1]          # 514
        self.fine_offset = spec3.offsets[-2]
        self.fine_size = spec3.level_sizes[-1]
        self.pn_res = self.fine_res                    # frac plane resolution

    # ----------------------------------------------------------- table build
    def _level_plans(self):
        """Static per-level build plans (ctx 3D levels then ctx 2D levels)."""
        plans = []
        for l in self.ctx_levels_3d:
            r = self.spec3.resolutions[l]
            tbl = self.spec3.level_sizes[l]
            v = r ** 3
            plans.append(dict(kind="3d", level=l, r=r, tbl=tbl, v=v, dense=v <= tbl,
                              e_max=min(tbl, v)))
        rb = self.rb
        for l in self.ctx_levels_2d:
            r = self.spec2.resolutions[l]
            tile = (r - 2) // rb
            assert (r - 2) % rb == 0, "2D resolutions must be multiples of Rb"
            p = rb * rb * (tile + 2) ** 2
            # the 2D block lattice revisits boundary coords (blocks overlap
            # by 2), so even "dense" levels are non-injective -> sort path
            plans.append(dict(kind="2d", level=l, r=r, tbl=self.spec2.level_sizes[l], v=p,
                              dense=False, tile=tile, e_max=min(self.spec2.level_sizes[l], p)))
        return plans

    _coords_2d = staticmethod(cops.coords_2d)

    def _fused_build_impl(self):
        """Every level's sorted vertex tables, level by level.

        Returns a dict of concatenated arrays (per kind) plus the exact entry
        count per plan.  The shuffles of the dense 3D levels and of the 2D
        levels use a fixed per-level threefry seed, so both codec sides (and
        both packages) rebuild the same order.  The sort is stable: within
        one entry, vertices stay in ascending vertex id.  The most vertices
        of one entry, per hashed plan, go to `self.longest_segments`."""
        dev = self.device
        rb = self.rb
        out3 = {"pos_flat": [], "vert_entry": [], "entry_values": [], "cum": []}
        out2 = {"coords": [], "block_id": [], "vert_entry": [], "entry_values": [], "cum": []}
        n_entries = []
        self.longest_segments = {}
        as_dev = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)
        for p in self._level_plans():
            if p["dense"]:
                # dense 3D level: grid_index is a bijection onto [0, V);
                # shuffled entry order for unbiased window sampling
                perm = as_dev(threefry.permutation(1234 + p["level"], p["v"]))
                part = cops.dense_level(perm, p["r"])
                n_entries.append(torch.tensor(p["v"], dtype=torch.int32, device=dev))
            else:
                perm = inv = None
                d, tile = (3, 0) if p["kind"] == "3d" else (2, p["tile"])
                if p["kind"] == "2d":
                    # shuffle the entry ORDER so sampled entry windows aren't
                    # raster slabs on dense 2D levels
                    perm_np = threefry.permutation(4321 + p["level"], p["tbl"])
                    inv_np = np.empty_like(perm_np)
                    inv_np[perm_np] = np.arange(p["tbl"])
                    perm, inv = as_dev(perm_np), as_dev(inv_np)
                part = cops.level_tables(p["v"], d, p["r"], p["tbl"], p["e_max"], dev, tile, rb,
                                         perm, inv)
                self.longest_segments[(p["kind"], p["level"])] = part.pop("longest")
                n_entries.append(part.pop("n_entries").reshape(()))
            dst = out3 if p["kind"] == "3d" else out2
            for k in dst:
                dst[k].append(part[k])
            del part
        res = {"n_entries": torch.stack(n_entries) if n_entries
               else torch.zeros(0, dtype=torch.int32, device=dev)}
        for prefix, out in (("3d_", out3), ("2d_", out2)):
            for k in out:
                if out[k]:
                    parts = out[k]
                    out[k] = None
                    res[prefix + k] = torch.cat(parts)
                    del parts
        return res

    def _all_tables_in_plan_order(self):
        return ([self.tables3d[l] for l in self.ctx_levels_3d] +
                [self.tables2d[l] for l in self.ctx_levels_2d])

    def max_window_pts(self, sample_ns: Sequence[int]) -> np.ndarray:
        """Exact max vertex-window sizes for per-plan window lengths (plan
        order: ctx 3D levels then ctx 2D levels): win(i) = cum[i+sn] - cum[i]
        maximized over starts i <= n_e - sn."""
        outs = []
        for sn, t in zip(sample_ns, self._all_tables_in_plan_order()):
            cum = self._cum_np["3d" if isinstance(t, Level3DTable) else "2d"]
            c = cum[t.c_off:t.c_off + t.e_max + 1].astype(np.int64)
            idx = np.arange(t.e_max + 1)
            upper = c[np.minimum(idx + int(sn), t.e_max)]
            ok = idx <= t.n_entries - int(sn)
            outs.append(int(np.max(np.where(ok, upper - c, 0))))
        return np.asarray(outs, np.int32)

    def _build_tables(self):
        ecfg, spec3, spec2 = self.cfg, self.spec3, self.spec2
        plans = self._level_plans()

        # static concat offsets per plan
        offs = {"3d": {"v": 0, "e": 0, "c": 0}, "2d": {"v": 0, "e": 0, "c": 0}}
        meta = []
        for p in plans:
            o = offs[p["kind"]]
            meta.append(dict(v_off=o["v"], e_off=o["e"], c_off=o["c"]))
            o["v"] += p["v"]
            o["e"] += p["e_max"]
            o["c"] += p["e_max"] + 1

        res = self._fused_build_impl()
        n_entries = res["n_entries"].cpu().numpy()

        self._arrays3d = {k: res["3d_" + k] for k in ("pos_flat", "vert_entry", "entry_values",
                                                       "cum") if "3d_" + k in res}
        self._arrays2d = {k: res["2d_" + k] for k in ("coords", "block_id", "vert_entry",
                                                       "entry_values", "cum") if "2d_" + k in res}
        # host copy of the cumulative vertex counts: window bounds are host
        # integers, so a window is a view and a step needs no device read
        empty = np.zeros(0, np.int32)
        self._cum_np = {"3d": self._arrays3d["cum"].cpu().numpy() if self._arrays3d else empty,
                        "2d": self._arrays2d["cum"].cpu().numpy() if self._arrays2d else empty}

        self.tables3d: Dict[int, Level3DTable] = {}
        self.tables2d: Dict[int, Level2DTable] = {}
        for i, (p, m) in enumerate(zip(plans, meta)):
            e = int(n_entries[i])
            if p["kind"] == "3d":
                self.tables3d[p["level"]] = Level3DTable(
                    level=p["level"], resolution=p["r"], offset=spec3.offsets[p["level"]],
                    n_entries=e, n_vertices=p["v"], sample_n=0, max_win_pts=0,
                    v_off=m["v_off"], e_off=m["e_off"], c_off=m["c_off"], e_max=p["e_max"])
            else:
                self.tables2d[p["level"]] = Level2DTable(
                    level=p["level"], resolution=p["r"], offset=spec2.offsets[p["level"]],
                    tile=p["tile"], n_points=p["v"], n_entries=e, sample_n=0, max_win_pts=0,
                    v_off=m["v_off"], e_off=m["e_off"], c_off=m["c_off"], e_max=p["e_max"])

        # ---- proportional entry sampling quotas (utils_bpp_acc.py:350-352)
        entry_counts = []
        for l in range(self.pg_level):
            if l in self.cfg.skip_levels_3d:
                r = spec3.resolutions[l]
                entry_counts.append(min(spec3.level_sizes[l], r ** 3))
            else:
                entry_counts.append(self.tables3d[l].n_entries)
        counts_arr = np.asarray(entry_counts, np.float64)
        sample = np.round(counts_arr * (self.cfg.sample_num / counts_arr.sum()))
        if sample[-1] > counts_arr[-1]:
            sample = counts_arr
        sample = sample.astype(np.int64)
        sn3 = {}
        for l in self.ctx_levels_3d:
            t = self.tables3d[l]
            sn3[l] = max(1, int(min(sample[l], t.n_entries)))

        # ---- 2D quotas (None = full lattice per step)
        sn2cfg = getattr(ecfg, "sample_num_2d", None)
        sn2 = {}
        tot2 = sum(self.tables2d[l].n_entries for l in self.ctx_levels_2d)
        for l in self.ctx_levels_2d:
            t = self.tables2d[l]
            if sn2cfg:
                sn2[l] = max(1, min(int(round(t.n_entries * sn2cfg / tot2)), t.n_entries))
            else:
                sn2[l] = t.n_entries

        # ---- exact window capacities
        sns = ([sn3[l] for l in self.ctx_levels_3d] + [sn2[l] for l in self.ctx_levels_2d])
        wins = self.max_window_pts(sns)
        i = 0
        for l in self.ctx_levels_3d:
            t = self.tables3d[l]
            w = t.n_vertices if sn3[l] >= t.n_entries else int(wins[i])
            self.tables3d[l] = t._replace(sample_n=sn3[l], max_win_pts=w)
            i += 1
        for l in self.ctx_levels_2d:
            t = self.tables2d[l]
            w = t.n_points if sn2[l] >= t.n_entries else int(wins[i])
            self.tables2d[l] = t._replace(sample_n=sn2[l], max_win_pts=w)
            i += 1

    # ---------------------------------------------------------- table access
    @property
    def table_arrays(self) -> Dict:
        """Concatenated vertex-table tensors; per-level slices are located by
        the static offsets in Level3DTable / Level2DTable."""
        return {"3d": self._arrays3d, "2d": self._arrays2d}

    # --------------------------------------------------------------- params
    def _param_shapes(self):
        f = self.cfg.n_features
        k = self.cfg.max_context_layer_num
        ctx3d = {"l0": (f * k + 1, 32), "l1": (32, 32), "l2": (32, f)}
        ctx2d = {}
        for l in self.ctx_levels_2d:
            cln = min(l, k)
            ctx2d[str(l)] = (f * (cln + int(self.cfg.use_dimension_wise)) + 1, f)
        return ctx3d, ctx2d

    def init_params(self, generator: Optional[torch.Generator] = None) -> ContextParams:
        """Fresh context MLPs, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for W and b,
        drawn from `generator` (seed 0 when None) on its device and moved to
        the model's."""
        g = generator if generator is not None else torch.Generator().manual_seed(0)

        def linear(fan_in, fan_out):
            bound = 1.0 / math.sqrt(fan_in)
            draw = lambda shape: ((torch.rand(shape, generator=g, device=g.device) * 2.0 - 1.0)
                                  * bound).to(self.device)
            return Linear(draw((fan_in, fan_out)), draw((fan_out,)))

        ctx3d, ctx2d = self._param_shapes()
        return ContextParams({k: linear(*s) for k, s in ctx3d.items()},
                             {k: linear(*s) for k, s in ctx2d.items()})

    def param_count(self, params: ContextParams) -> int:
        return sum(p.numel() for p in params.parameters())

    def apply_ctx3d(self, p, x):
        h = nn.functional.leaky_relu(p["l0"](x), 0.01)
        h = nn.functional.leaky_relu(p["l1"](h), 0.01)
        return p["l2"](h)

    def apply_ctx2d(self, p, level, x):
        return p[str(level)](x)

    # ---------------------------------------------------------------- cache

    def _check_binaries(self, binaries):
        # Rb is BOTH the entropy block size and the occupancy resolution the
        # footprint/pn machinery assumes (reference couples them the same
        # way, utils_bpp_acc.py:194-228 with binary_vxl 128^3 and Rb=128).
        if tuple(binaries.shape) != (self.rb,) * 3:
            raise ValueError(
                f"occupancy grid shape {tuple(binaries.shape)} != (Rb,)*3 with "
                f"Rb={self.rb}: EntropyConfig.Rb must equal RenderConfig.occ_resolution")

    def refresh_cache(self, binaries: torch.Tensor) -> Dict:
        """The occupancy-dependent cache: per-corner mask grids of every
        level (K8) as bools, overlap weights of the
        context levels, and the pn coord lists.  Nothing here is
        differentiated."""
        self._check_binaries(binaries)
        with torch.no_grad():
            return self._refresh_impl(binaries.to(self.device))

    def _refresh_impl(self, binaries):
        dev = self.device
        cache = {}
        bin2d = torch.stack([binaries.any(dim=2),    # xy
                             binaries.any(dim=1),    # xz
                             binaries.any(dim=0)])   # yz
        cache["bin2d"] = bin2d
        # flat per-corner mask grids over ALL levels: the encoder and pooling
        # gather ONE bool per corner
        offs = self.mask3d_offsets
        m3_total = offs[-1] + self.spec3.resolutions[-1] ** 3
        mask3d = torch.empty(m3_total, dtype=torch.bool, device=dev)
        cache["ovl"] = {}
        for l, r in enumerate(self.spec3.resolutions):
            ctx_level = l in self.ctx_levels_3d
            _, o = cops.footprint_grids(binaries, r, with_overlap=ctx_level,
                                        mask_out=mask3d[offs[l]:offs[l] + r ** 3])
            if ctx_level:
                cache["ovl"][str(l)] = o
        cache["mask3d"] = mask3d
        cache["mask2d"] = self._mask2d(bin2d)
        cache["pn"] = self._refresh_pn_coords(binaries)
        return cache

    def _mask2d(self, bin2d):
        """[3, sum r^2] per-corner footprint masks of the three planes (K8)."""
        offs2 = self.mask2d_offsets
        m2_total = offs2[-1] + self.mask2d_resolutions[-1] ** 2
        mask2d = torch.empty(3, m2_total, dtype=torch.bool, device=bin2d.device)
        for ai in range(3):
            for o2, r in zip(offs2, self.mask2d_resolutions):
                cops.footprint_grids(bin2d[ai], r, mask_out=mask2d[ai, o2:o2 + r * r])
        return mask2d

    @property
    def mask3d_offsets(self):
        """Per-3D-level start offsets into the flat cache['mask3d']."""
        offs = [0]
        for r in self.spec3.resolutions:
            offs.append(offs[-1] + r ** 3)
        return tuple(offs[:-1])

    @property
    def mask2d_resolutions(self):
        """Resolutions covered by cache['mask2d'] per axis: every 2D level
        plus (if absent) the dimension-wise prior's plane resolution."""
        res = list(self.spec2.resolutions)
        if self.pn_res not in res:
            res.append(self.pn_res)
        return tuple(res)

    @property
    def mask2d_offsets(self):
        offs = [0]
        for r in self.mask2d_resolutions:
            offs.append(offs[-1] + r ** 2)
        return tuple(offs[:-1])

    @property
    def pn_mask_offset(self):
        return self.mask2d_offsets[self.mask2d_resolutions.index(self.pn_res)]

    def _refresh_pn_coords(self, binaries):
        """Dilated occupied coord lists sorted by projected bin (per axis).

        Replaces get_idx_coords2 (utils_bpp_acc.py:498-512): occupied cells
        upsampled x(scale/Rb) and dilated by one fine cell, then +1 shift
        into the (scale+2)-resolution lattice.  The coord list is compacted
        (K3) to a static cap and reduced to per-axis (bin-sorted hashed
        finest-level entry indices + static bin boundaries).
        """
        rb = self.rb
        scale = self.pn_res - 2                       # 512
        assert scale % rb == 0, "finest 3D resolution-2 must be a multiple of Rb"
        t = scale // rb
        cap = self.cfg.pn_coords_cap
        # dense dilated mask on the scale^3 lattice (coords 1..scale after
        # the +1 shift; border coords are dropped by cnt_np_embed anyway)
        dil = binaries
        for axis in range(3):
            dil = dil.repeat_interleave(t, dim=axis)
        for axis in range(3):
            pad = [0, 0] * 3
            pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
            p = nn.functional.pad(dil, pad)
            n = dil.shape[axis]
            dil = p.narrow(axis, 0, n) | p.narrow(axis, 1, n) | p.narrow(axis, 2, n)
            del p
        # dil[i,j,k] true => lattice coord (i+1, j+1, k+1) is in the list
        src, n = scatter_ops.compact_mask_indices(dil.reshape(-1), cap)
        del dil
        src = src.long()
        valid = torch.arange(cap, device=src.device) < torch.clamp(n, max=cap)
        coords = torch.stack([src // (scale * scale) + 1, (src // scale) % scale + 1,
                              src % scale + 1], dim=-1)    # lattice coords 1..scale
        eidx = hash_ops.grid_index(coords, self.pn_res, self.fine_size)
        eidx = torch.where(valid, eidx, 0).to(torch.int32)
        arange_bins = torch.arange(scale * scale + 1, dtype=torch.int32, device=src.device)
        out = {}
        for ax, (a, b) in zip(AXES, _AXIS_DIMS):
            bins = ((coords[:, a] - 1) * scale + (coords[:, b] - 1)).to(torch.int32)
            bins = torch.where(valid, bins, scale * scale)   # park invalid at end
            bins_s, order = torch.sort(bins, stable=True)
            del bins
            out[ax] = {"entry_idx": eidx[order], "n": n,
                       "bounds": torch.searchsorted(bins_s, arange_bins).to(torch.int32)}
            del bins_s, order
        return out

    # ------------------------------------------------- dimension-wise prior
    def pn_frac_plane(self, table3d_q: torch.Tensor, pn_ax: Dict,
                      sample_cap: Optional[int] = None) -> torch.Tensor:
        """Positive-sign fraction plane [pn_res**2, F] (x-fastest flat).

        get_pn_embed_frac (utils_bpp_acc.py:515-530): histogram the signs of
        the finest-level entries at the cached coords, per projected bin;
        frac = pos/(pos+neg+1e-6); zero border ring (K7, one launch on the
        card: `ops/context_ops.pn_frac_plane`).  With `sample_cap`, a
        stride-sampled subset estimates the fraction (training speed knob;
        the codec always passes None)."""
        args = (table3d_q, self.fine_offset, pn_ax["entry_idx"], pn_ax["bounds"], pn_ax["n"],
                self.pn_res)
        return cops.pn_frac_plane(*args, sample_cap)

    # ---------------------------------------------------------- entry windows
    def draw_starts(self, generator: torch.Generator) -> Dict:
        """One step's entry-window starts, drawn from `generator`:
        {"3d": {level: start_e}, "2d": {(axis index, level): start_e}}, with
        start_e = round((n_entries - sample_n) * u) in float32, half to even,
        as cnc_tpu rounds its own uniform draws."""
        keys3 = list(self.ctx_levels_3d)
        keys2 = [(ai, l) for ai in range(3) for l in self.ctx_levels_2d]
        u = torch.rand(len(keys3) + len(keys2), generator=generator,
                       device=generator.device).cpu().numpy().astype(np.float32)
        starts = {"3d": {}, "2d": {}}
        for i, l in enumerate(keys3):
            starts["3d"][l] = self.start_from_uniform(self.tables3d[l], u[i])
        for i, (ai, l) in enumerate(keys2):
            starts["2d"][(ai, l)] = self.start_from_uniform(self.tables2d[l], u[len(keys3) + i])
        return starts

    @staticmethod
    def start_from_uniform(t, u) -> int:
        """round((n_entries - sample_n) * u) in float32, half to even."""
        return int(np.round(np.float32(t.n_entries - t.sample_n) * np.float32(u)))

    def _slice_3d_windows(self, starts: Mapping[int, int]):
        """Per-level entry windows -> padded vertex windows (views of the
        concatenated buffers at the static v_off/e_off/c_off offsets; cum
        values are level-local vertex positions)."""
        parts = []
        a = self._arrays3d
        cum = self._cum_np["3d"]
        for l in self.ctx_levels_3d:
            t = self.tables3d[l]
            start_e = int(starts[l])
            if not 0 <= start_e <= t.n_entries - t.sample_n:
                raise ValueError(f"3D level {l}: window start {start_e} outside "
                                 f"[0, {t.n_entries - t.sample_n}]")
            start_v = int(cum[t.c_off + start_e])
            end_v = int(cum[t.c_off + start_e + t.sample_n])
            (pos, ve), vvalid = _window_slices(a, ("pos_flat", "vert_entry"), t.v_off, start_v,
                                               end_v, t.max_win_pts, t.n_vertices)
            evals = a["entry_values"][t.e_off + start_e:t.e_off + start_e + t.sample_n]
            parts.append(dict(level=l, pos=pos, slot=ve - start_e, valid=vvalid,
                              start_e=start_e, entry_values=evals))
        return parts

    @property
    def total_param_count(self) -> int:
        """Static count behind bits-per-param (3 planes + 3D grid)."""
        f = self.cfg.n_features
        return (3 * self.spec2.total_entries + self.spec3.total_entries) * f

    # ------------------------------------------------------------- the rate
    def rate_bits_2d(self, ent_params: ContextParams, tables: Mapping[str, torch.Tensor],
                     starts: Mapping[Tuple[int, int], int], cache: Dict):
        """Total estimated bits of the three tri-plane tables (differentiable
        in the tables and the context MLPs).  `starts` maps (axis index,
        level) to the entry-window start of each 2D context level
        (`draw_starts(...)["2d"]`)."""
        cfg = self.cfg
        ttl_bits = 0.0
        fine_table = tables["xyz"]
        for ai, ax in enumerate(AXES):
            tbl2 = tables[ax]
            if cfg.use_dimension_wise:
                src = fine_table if cfg.pn_frac_grad else fine_table.detach()
                frac_plane = self.pn_frac_plane(src, cache["pn"][ax],
                                                sample_cap=cfg.pn_frac_sample_cap)
            else:
                frac_plane = None
            # split, not sliced: its backward is one concatenation, where a
            # slice's backward fills a whole table of zeros per level
            for l, level_slice in enumerate(tbl2.split(list(self.spec2.level_sizes))):
                pg_n, bits_n, _ = ent_ops.global_pg_bits(level_slice)
                if l in self.ctx_levels_2d:
                    bits_n = self._bits_2d_level(ent_params, tbl2, l, pg_n, frac_plane,
                                                 cache["bin2d"][ai], cache["mask2d"][ai],
                                                 starts[(ai, l)], None)
                ttl_bits = ttl_bits + bits_n
        return ttl_bits

    def rate_bits_3d(self, ent_params: ContextParams, tbl3: torch.Tensor,
                     starts: Mapping[int, int], cache: Dict, with_util: bool = False):
        """Total estimated bits of the 3D grid table (differentiable).  With
        `with_util`, also returns the ctx-vertex budget utilization (masked
        vertices / v_ctx_cap; > 1 means drops).  `starts` maps each 3D
        context level to its entry-window start (`draw_starts(...)["3d"]`)."""
        ttl_bits = 0.0
        pg_by_level = {}
        for l, level_slice in enumerate(tbl3.split(list(self.spec3.level_sizes))):
            pg_n, bits_n, _ = ent_ops.global_pg_bits(level_slice)
            pg_by_level[l] = pg_n
            if l in self.cfg.skip_levels_3d or l >= self.pg_level:
                ttl_bits = ttl_bits + bits_n
        sampled, util = self._bits_3d_sampled(ent_params, tbl3, pg_by_level, cache, starts)
        ttl_bits = ttl_bits + sampled
        return (ttl_bits, util) if with_util else ttl_bits

    # ------------------------------------------------------- 2D level pooling
    def pool_2d_level(self, ent_params, tbl2, level, pg_n, frac_plane, bin2d, mask2d, start_e,
                      n_e, w, mask2d_bits=None):
        """Per-entry pooled context probabilities for one 2D level window.

        `mask2d` is one axis's row of cache['mask2d'], `mask2d_bits` the same
        row of cache['mask2d_bits'] (needed on the card, where the encodes
        read it).  Returns (pooled [n_e,F], covered [n_e], values_q [n_e,F]).
        Shared by the training rate estimate (sampled window) and the codec
        (full coverage: start_e=0, n_e=n_entries, w=n_points).
        """
        cfg = self.cfg
        t = self.tables2d[level]
        a = self._arrays2d
        cum = self._cum_np["2d"]
        start_e = int(start_e)
        start_v = int(cum[t.c_off + start_e])
        end_v = int(cum[t.c_off + start_e + n_e])
        (coords, slots), valid = _window_slices(a, ("coords", "vert_entry"), t.v_off, start_v,
                                                end_v, w, t.n_points)
        slots = slots - start_e
        evals = a["entry_values"][t.e_off + start_e:t.e_off + start_e + n_e]

        xi = (coords >> 16).long()
        yi = (coords & 0xFFFF).long()
        # per-corner FOOTPRINT mask: the codec covers every corner whose
        # footprint box touches occupancy (a strict superset of block
        # occupancy near boundaries), so the training rate bills the same set
        occ_block = mask2d[self.mask2d_offsets[level] + xi * t.resolution + yi] & valid
        pts = torch.stack([xi.float() - 0.5, yi.float() - 0.5], dim=-1) / (t.resolution - 2.0)

        cln = min(level, cfg.max_context_layer_num)
        # ctx_grad=False: the coarser-level context lookups become constants
        # of the rate graph (their scatter-heavy backward is skipped); the
        # coded entries keep their direct bernoulli-bits gradient below
        ctx_src = tbl2 if cfg.ctx_grad else tbl2.detach()
        slots = torch.clamp(slots, 0, n_e - 1)
        cap = cfg.v_ctx_cap_2d
        if cap is not None and cap < w:
            # compact the footprint-masked rows to a static context budget:
            # only masked rows enter the pooling, so encoding ONLY them is
            # exact whenever the budget holds all of them; beyond-budget rows
            # are dropped from the pooling entirely, like the 3D path
            src, total = scatter_ops.compact_mask_indices(occ_block, cap)
            src = src.long()
            cvalid = torch.arange(cap, device=src.device) < torch.clamp(total, max=cap)
            pts = pts[src]
            # src ascends, so slots[src] stays sorted-contiguous per entry
            slots = slots[src]
            rows, cnt_src, pool_valid = cap, cvalid, cvalid
        else:
            rows, cnt_src, pool_valid = w, occ_block, occ_block
        feats = [enc.grid_encode(pts, ctx_src, self.spec2, level - cln, level, occ_mask=mask2d,
                                 mask_offsets=self.mask2d_offsets, occ_bits=mask2d_bits)]
        if frac_plane is not None:
            feats.append(enc.grid_encode_given_table(pts, frac_plane, self.pn_res,
                                                     occ_mask=mask2d,
                                                     mask_offset=self.pn_mask_offset,
                                                     occ_bits=mask2d_bits))
        feats.append(pg_n.reshape(1, 1).expand(rows, 1))
        mean = self.apply_ctx2d(ent_params.ctx2d, level, torch.cat(feats, dim=-1))
        # the mean over each entry's pooled rows (K6m): the count is the sum
        # of cnt_src over them, which is 1 on every pooled row
        pooled, covered = cops.segment_mean(mean, cnt_src.float(), slots, pool_valid, n_e, 1.0)
        values_q = tbl2.index_select(0, t.offset + evals.long())
        return pooled, covered, values_q

    def _bits_2d_level(self, ent_params, tbl2, level, pg_n, frac_plane, bin2d, mask2d, start_e,
                       mask2d_bits):
        """Context-model bits of one 2D level over a sampled entry window."""
        t = self.tables2d[level]
        if not 0 <= int(start_e) <= t.n_entries - t.sample_n:
            raise ValueError(f"2D level {level}: window start {start_e} outside "
                             f"[0, {t.n_entries - t.sample_n}]")
        pooled, covered, values_q = self.pool_2d_level(
            ent_params, tbl2, level, pg_n, frac_plane, bin2d, mask2d, start_e, t.sample_n,
            t.max_win_pts, mask2d_bits)
        bits = ent_ops.bernoulli_bits(values_q, pooled)
        bits = torch.where(covered[:, None], bits, 0.0).sum()
        # extrapolate the sampled window to the whole level (exact when
        # sample_num_2d is None => window == full level)
        return bits * (t.n_entries / t.sample_n)

    # ------------------------------------------------------- 3D level pooling
    def pool_3d_level(self, ent_params, tbl3, cache, level, pg_n, start_e, n_e, w):
        """Per-entry pooled context probabilities for one 3D level window.

        Static level (context = levels [level-k, level)); used by the
        codec's chunked full-coverage passes.  Returns (pooled, covered,
        values_q).
        """
        cfg = self.cfg
        t = self.tables3d[level]
        a = self._arrays3d
        cum = self._cum_np["3d"]
        r = t.resolution
        start_e = int(start_e)
        start_v = int(cum[t.c_off + start_e])
        end_v = int(cum[t.c_off + start_e + n_e])
        (pos, slots), valid = _window_slices(a, ("pos_flat", "vert_entry"), t.v_off, start_v,
                                             end_v, w, t.n_vertices)
        slots = slots - start_e
        evals = a["entry_values"][t.e_off + start_e:t.e_off + start_e + n_e]
        pos = pos.long()

        mask = cache["mask3d"][self.mask3d_offsets[level] + pos] & valid
        ovl = cache["ovl"][str(level)][pos]
        ovl_w = torch.clamp(torch.floor(ovl * 1000.0), min=1.0)

        xyz = torch.stack([pos // (r * r), (pos // r) % r, pos % r], dim=-1)
        pts = (xyz.float() - 0.5) / (r - 2.0)
        k = cfg.max_context_layer_num
        ctx = enc.grid_encode(pts, tbl3, self.spec3, level - k, level, occ_mask=cache["mask3d"],
                              mask_offsets=self.mask3d_offsets, occ_bits=None)
        ctx = torch.cat([ctx, pg_n.reshape(1, 1).expand(w, 1)], dim=-1)
        mean = self.apply_ctx3d(ent_params.ctx3d, ctx)

        slots = torch.clamp(slots, 0, n_e - 1)
        # K6m: the overlap-weighted mean (the weight is 0 off the mask), or
        # the plain mean over the masked rows; either way an entry is covered
        # where a masked row lands, as where the weights' sum is positive
        if cfg.use_overlap_area_pool:
            wgt = torch.where(mask, ovl_w, 0.0)
            pooled, covered = cops.segment_mean(mean, wgt, slots, valid, n_e, 1e-9,
                                                weighted=True)
        else:
            pooled, covered = cops.segment_mean(mean, mask.float(), slots, mask, n_e, 1.0)
        values_q = tbl3.index_select(0, t.offset + evals.long())
        return pooled, covered, values_q

    # ------------------------------------------------------- 3D level bits
    def _bits_3d_sampled(self, ent_params, tbl3, pg_by_level, cache, starts):
        cfg = self.cfg
        parts = self._slice_3d_windows(starts)
        if not parts:
            return 0.0, 0.0
        # concat vertex windows (static total size)
        pos = torch.cat([p["pos"] for p in parts]).long()
        dev = pos.device
        levels = torch.cat([torch.full((p["pos"].shape[0],), p["level"], dtype=torch.int32,
                                       device=dev) for p in parts])
        base = 0
        slots = []
        for p in parts:
            slots.append(p["slot"] + base)
            base += self.tables3d[p["level"]].sample_n
        slot = torch.cat(slots)
        e_total = base

        # occupancy mask + overlap from dense cached grids (1 gather each)
        masks, ovls = [], []
        for p in parts:
            l = p["level"]
            pl = p["pos"].long()
            masks.append(cache["mask3d"][self.mask3d_offsets[l] + pl] & p["valid"])
            ovls.append(cache["ovl"][str(l)][pl])
        mask = torch.cat(masks)
        # int(x*1000) clamp(min=1) like the reference pooling weights
        ovl_w = torch.clamp(torch.floor(torch.cat(ovls) * 1000.0), min=1.0)

        # compact masked vertices to the context budget (K3); vertices beyond
        # the budget are dropped from the pooling entirely (their zero means
        # must not dilute the per-entry probabilities)
        cap = cfg.v_ctx_cap
        src, total = scatter_ops.compact_mask_indices(mask, cap)
        src = src.long()
        cvalid = torch.arange(cap, device=dev) < torch.clamp(total, max=cap)
        # static-budget utilization; > 1 means vertices were DROPPED
        ctx_util = total.to(torch.float32) / cap

        clev = levels[src]
        cpos = pos[src]
        res_arr = torch.tensor(self.spec3.resolutions, dtype=torch.int64, device=dev)[clev.long()]
        xyz = torch.stack([cpos // (res_arr * res_arr), (cpos // res_arr) % res_arr,
                           cpos % res_arr], dim=-1)
        pts = (xyz.float() - 0.5) / (res_arr.float() - 2.0)[:, None]
        k = cfg.max_context_layer_num
        # see pool_2d_level: ctx_grad=False skips the context-gather backward
        ctx_src = tbl3 if cfg.ctx_grad else tbl3.detach()
        ctx = enc.grid_encode_diff_levels(pts, ctx_src, self.spec3, clev - k, k,
                                          occ_mask=cache["mask3d"],
                                          mask_offsets=self.mask3d_offsets,
                                          occ_bits=None)
        pg_arr = torch.stack([pg_by_level[l] for l in range(self.spec3.n_levels)])
        # each vertex's level probability: 2^21 rows of a dozen values, so the
        # gradient is summed per run of equal levels (K6), not row by row
        pg_rows = cops.segment_gather(pg_arr, clev, torch.ones_like(cvalid))
        ctx = torch.cat([ctx, pg_rows[:, None]], dim=-1)
        mean = self.apply_ctx3d(ent_params.ctx3d, ctx)

        # pool directly in the COMPACTED layout (K6m, as in pool_3d_level):
        # src enumerates exactly the kept (masked, in-budget) vertices in
        # ascending window order, so slot[src] stays sorted-contiguous per
        # entry over the live rows (the padding past the count repeats
        # slot[src[0]] on rows that are not live); the weights are >= 1 on
        # the kept rows
        cslot = slot[src]
        if cfg.use_overlap_area_pool:
            cw = torch.where(cvalid, ovl_w[src], 0.0)
            pooled, exist = cops.segment_mean(mean, cw, cslot, cvalid, e_total, 1e-9,
                                              weighted=True)
        else:
            pooled, exist = cops.segment_mean(mean, cvalid.float(), cslot, cvalid, e_total, 1.0)

        evals = torch.cat([p["entry_values"].long() + self.tables3d[p["level"]].offset
                           for p in parts])
        # index_select: its backward adds with atomics, where the backward of
        # tbl3[evals] sorts the indices first
        values_q = tbl3.index_select(0, evals)
        bits = ent_ops.bernoulli_bits(values_q, pooled)
        bits = torch.where(exist[:, None], bits, 0.0).sum()
        # extrapolation (utils_bpp_acc.py:700)
        return bits / self.ttl_sample_valid_3d * self.ttl_entries_valid_3d, ctx_util
