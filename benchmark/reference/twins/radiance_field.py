"""Frozen copy of `cnc_torch/models/radiance_field.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

The CNC radiance field: binarized 3D hash grid + three 2D tri-plane grids.

Port of `cnc_tpu/models/radiance_field.py` (reference
NGPRadianceField_mygrid_2D3D, ngp.py:365-645):

  density branch: 3D grid (12 levels) (+) xy/xz/yz 2D grids (4 levels each)
  (+) 63-dim sine positional embedding -> Linear(159->160) -> ReLU ->
  Linear(160->1+geo_feat); density = trunc_exp(h0 - 1) * inside-aabb selector.

  color branch: SH degree-4 direction encoding (16) (+) geo_feat ->
  3-layer 160-wide MLP -> sigmoid.

`RadianceField` holds the four tables and the two MLPs with cnc_tpu's
parameter layout (`w` stored [in, out]), so `params_from_jax` carries
cnc_tpu's param pytree across and both packages compute the same field.  The
functions below take the field, as cnc_tpu's take its params.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .config import ModelConfig
from . import encoding as enc
from . import sh as sh_ops
from . import ste as ste_ops
from .device import resolve_device

TABLES = ("xyz", "xy", "xz", "yz")


class Linear(nn.Module):
    """y = x @ w + b with w stored [in, out], as cnc_tpu's `linear`."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def _uniform(shape, bound: float, generator: torch.Generator,
             device: torch.device) -> torch.Tensor:
    # drawn on the generator's device, then moved: a seed gives the same
    # weights whichever device the field lives on
    u = torch.rand(shape, generator=generator, device=generator.device)
    return ((u * 2.0 - 1.0) * bound).to(device)


def mlp_dims(cfg: ModelConfig) -> Tuple[int, int]:
    pe_dim = 3 + 3 * 2 * cfg.pe_num_freqs
    base_in = cfg.grid_3d.output_dim + 3 * cfg.grid_2d.output_dim + pe_dim
    head_in = cfg.sh_degree ** 2 + cfg.geo_feat_dim
    return base_in, head_in


class RadianceField(nn.Module):
    """The four hash tables and the two MLPs of one CNC field.

    Weights are drawn from `generator` (seed 0 when None).
    """

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)

        def make(path, shape, bound):
            return _uniform(shape, bound, g, device)

        def linear(mlp, name, fan_in, fan_out):
            # U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for W and b (torch nn.Linear default)
            bound = 1.0 / math.sqrt(fan_in)
            return Linear(make((mlp, name, "w"), (fan_in, fan_out), bound),
                          make((mlp, name, "b"), (fan_out,), bound))

        g3, g2 = cfg.grid_3d, cfg.grid_2d
        std = 1e-4  # GridEncoder.reset_parameters (ngp.py:221-223)
        self.cfg = cfg
        self.tables = nn.ParameterDict({
            k: nn.Parameter(make((k,), (spec.total_entries, spec.n_features), std))
            for k, spec in (("xyz", g3), ("xy", g2), ("xz", g2), ("yz", g2))})
        base_in, head_in = mlp_dims(cfg)
        n = cfg.n_neurons
        self.mlp_base = nn.ModuleDict({
            "l0": linear("mlp_base", "l0", base_in, n),
            "l1": linear("mlp_base", "l1", n, 1 + cfg.geo_feat_dim),
        })
        self.mlp_head = nn.ModuleDict({
            "l0": linear("mlp_head", "l0", head_in, n),
            "l1": linear("mlp_head", "l1", n, n),
            "l2": linear("mlp_head", "l2", n, 3),
        })

    def forward(self, aabb: torch.Tensor, positions: torch.Tensor,
                directions: torch.Tensor, tables: Optional[Dict] = None):
        return forward(self, self.cfg, aabb, positions, directions, tables)


def quantized_tables(field: RadianceField, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Apply the configured STE quantizer to all four hash tables."""
    mode = ("ste_binary" if cfg.ste_binary else
            "ste_multistep" if cfg.ste_multistep else
            "add_noise" if cfg.add_noise else "none")
    if mode == "add_noise":
        raise NotImplementedError("add_noise tables come with training; "
                                  "CNC drivers use ste_binary")
    return {k: ste_ops.quantize_embedding(field.tables[k], mode, cfg.Q) for k in TABLES}


def encode_position(field: RadianceField, cfg: ModelConfig, x01: torch.Tensor,
                    tables: Optional[Dict] = None) -> torch.Tensor:
    """Grid + plane + sine features for normalized positions in [0,1]^3
    (compose_3D_2D_embed, ngp.py:620-645)."""
    t = tables if tables is not None else quantized_tables(field, cfg)
    g3, g2 = cfg.grid_3d, cfg.grid_2d
    return torch.cat([
        enc.grid_encode(x01, t["xyz"], g3),
        enc.grid_encode(x01[:, [0, 1]], t["xy"], g2),
        enc.grid_encode(x01[:, [0, 2]], t["xz"], g2),
        enc.grid_encode(x01[:, [1, 2]], t["yz"], g2),
        sh_ops.sine_embed(x01, cfg.pe_num_freqs),
    ], dim=-1)


def query_density(field: RadianceField, cfg: ModelConfig, aabb: torch.Tensor,
                  x_world: torch.Tensor, return_feat: bool = False,
                  tables: Optional[Dict] = None):
    """Density (+ optional geo features) at world positions (ngp.py:514-536)."""
    if cfg.unbounded:
        raise NotImplementedError("the reference has no unbounded-scene contraction")
    lo, hi = aabb[:3], aabb[3:]
    x01 = (x_world - lo) / (hi - lo)
    selector = ((x01 > 0.0) & (x01 < 1.0)).all(dim=-1)
    h = torch.relu(field.mlp_base["l0"](encode_position(field, cfg, x01, tables)))
    h = field.mlp_base["l1"](h)
    density = ste_ops.trunc_exp(h[..., 0] - 1.0) * selector
    if return_feat:
        return density, h[..., 1:]
    return density


def query_rgb(field: RadianceField, cfg: ModelConfig, dirs: torch.Tensor,
              geo_feat: torch.Tensor) -> torch.Tensor:
    """View-dependent color head (ngp.py:538-552)."""
    if cfg.use_viewdirs:
        sh = sh_ops.sh_encode((dirs + 1.0) / 2.0, cfg.sh_degree)
        h = torch.cat([sh, geo_feat], dim=-1)
    else:
        h = geo_feat
    h = torch.relu(field.mlp_head["l0"](h))
    h = torch.relu(field.mlp_head["l1"](h))
    return torch.sigmoid(field.mlp_head["l2"](h))


def forward(field: RadianceField, cfg: ModelConfig, aabb: torch.Tensor,
            positions: torch.Tensor, directions: torch.Tensor,
            tables: Optional[Dict] = None):
    """rgb, sigma at sample positions (ngp.py:554-566)."""
    density, geo = query_density(field, cfg, aabb, positions, return_feat=True,
                                 tables=tables)
    return query_rgb(field, cfg, directions, geo), density

