"""The CNC radiance field: binarized 3D hash grid + three 2D tri-plane grids.

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
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops import encoding as enc
from ..ops import sh as sh_ops
from ..ops import ste as ste_ops
from ..utils import profiling, threefry
from ..utils.device import resolve_device

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


def _from_numpy(params: Mapping, path: Tuple[str, ...], shape,
                device: torch.device) -> torch.Tensor:
    src = params
    for k in path:
        src = src[k]
    t = torch.from_numpy(np.array(src, dtype=np.float32))  # a writable copy
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} does not match the "
                         f"config's {tuple(shape)}")
    return t.to(device)


def mlp_dims(cfg: ModelConfig) -> Tuple[int, int]:
    pe_dim = 3 + 3 * 2 * cfg.pe_num_freqs
    base_in = cfg.grid_3d.output_dim + 3 * cfg.grid_2d.output_dim + pe_dim
    head_in = cfg.sh_degree ** 2 + cfg.geo_feat_dim
    return base_in, head_in


def cnc_tpu_initial_params(cfg: ModelConfig, key) -> Dict:
    """cnc_tpu's `init_radiance_field(key, cfg)` as numpy float32 arrays,
    drawn with the port's threefry from the key's two words (no JAX): the
    key split ten ways, the tables U(-1e-4, 1e-4), each layer's key split
    for W and b, both U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with the bound in
    float32 (`1.0 / jnp.sqrt(fan_in)`).  `params_from_jax` loads the tree."""
    keys = threefry.split(key, 10)
    std = 1e-4

    def linear(k, fan_in, fan_out):
        kw, kb = threefry.split(k)
        bound = np.float32(1.0) / np.sqrt(np.float32(fan_in))
        return {"w": threefry.uniform(kw, (fan_in, fan_out), -bound, bound),
                "b": threefry.uniform(kb, (fan_out,), -bound, bound)}

    g3, g2 = cfg.grid_3d, cfg.grid_2d
    base_in, head_in = mlp_dims(cfg)
    n = cfg.n_neurons
    params = {k: threefry.uniform(keys[i], (spec.total_entries, spec.n_features), -std, std)
              for i, (k, spec) in enumerate((("xyz", g3), ("xy", g2), ("xz", g2), ("yz", g2)))}
    params["mlp_base"] = {"l0": linear(keys[4], base_in, n),
                          "l1": linear(keys[5], n, 1 + cfg.geo_feat_dim)}
    params["mlp_head"] = {"l0": linear(keys[6], head_in, n), "l1": linear(keys[7], n, n),
                          "l2": linear(keys[8], n, 3)}
    return params


class RadianceField(nn.Module):
    """The four hash tables and the two MLPs of one CNC field.

    Weights are drawn from `generator` (seed 0 when None), or, with `params`,
    taken from cnc_tpu's param pytree as numpy arrays (see `params_from_jax`).
    """

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 device=None, params: Optional[Mapping] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)

        def make(path, shape, bound):
            if params is None:
                return _uniform(shape, bound, g, device)
            return _from_numpy(params, path, shape, device)

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


def params_from_jax(np_params: Mapping, cfg: Optional[ModelConfig], device=None) -> nn.Module:
    """The port's field holding cnc_tpu's param pytree (as numpy arrays).

    A RadianceField for the keys `cnc_tpu.models.radiance_field.
    init_radiance_field` makes: "xyz", "xy", "xz", "yz", "mlp_base"/"l0"..
    "l1", "mlp_head"/"l0".."l2", each layer {"w": [in, out], "b": [out]}.
    The MLP fields' trees (`init_vanilla_nerf`'s "trunk", ..., "meta";
    `init_ndr_nerf`'s "blocks", "nerf") become `mlp_fields.VanillaNeRF` /
    `NDRField`, whose shapes the tree itself gives (`cfg` unused).
    """
    if "blocks" in np_params or "trunk" in np_params:
        from . import mlp_fields
        field = mlp_fields.NDRField if "blocks" in np_params else mlp_fields.VanillaNeRF
        return field(device=device, params=np_params)
    return RadianceField(cfg, device=device, params=np_params)


def contract_to_unisphere(x: torch.Tensor, aabb: torch.Tensor,
                          eps: float = 1e-6) -> torch.Tensor:
    """Mip-NeRF-360 scene contraction (reference ngp.py:337-361, ord=2),
    rescaled to [0,1]^3 for the hash grids."""
    lo, hi = aabb[:3], aabb[3:]
    x = (x - lo) / (hi - lo) * 2.0 - 1.0
    mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    mag = torch.clamp(mag, min=eps)
    x = torch.where(mag > 1.0, (2.0 - 1.0 / mag) * (x / mag), x)
    return x / 4.0 + 0.5


def quantized_tables(field: RadianceField, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Apply the configured STE quantizer to all four hash tables."""
    mode = ("ste_binary" if cfg.ste_binary else
            "ste_multistep" if cfg.ste_multistep else
            "add_noise" if cfg.add_noise else "none")
    if mode == "add_noise":
        raise NotImplementedError("add_noise tables come with training; "
                                  "CNC drivers use ste_binary")
    return {k: ste_ops.quantize_embedding(field.tables[k], mode, cfg.Q) for k in TABLES}


def _plane(x01: torch.Tensor, dims) -> torch.Tensor:
    """The points' coordinates on one plane.  The list index is copied
    from the host, and on the card that copy waits for the stream."""
    with profiling.span("sync/plane_index"):
        return x01[:, dims]


def uses_field_input(x01: torch.Tensor, tables: Mapping[str, torch.Tensor]) -> bool:
    """Whether `encode_position` builds the row in one K1f launch
    (`encoding.field_input`): on the card, when no gradient is to reach the
    tables or the positions (grad mode off, or none of them requires grad).
    Otherwise the composition runs: the training render under autograd, and
    the plain twin on the CPU."""
    return x01.is_cuda and not (torch.is_grad_enabled() and (
        x01.requires_grad or any(tables[k].requires_grad for k in TABLES)))


def encode_position(field: RadianceField, cfg: ModelConfig, x01: torch.Tensor,
                    tables: Optional[Dict] = None) -> torch.Tensor:
    """Grid + plane + sine features for normalized positions in [0,1]^3
    (compose_3D_2D_embed, ngp.py:620-645)."""
    t = tables if tables is not None else quantized_tables(field, cfg)
    if uses_field_input(x01, t):
        return enc.field_input(x01.contiguous(), [t[k].contiguous() for k in TABLES],
                               cfg.grid_3d, cfg.grid_2d, cfg.pe_num_freqs)
    return composed_position(cfg, x01, t)


def composed_position(cfg: ModelConfig, x01: torch.Tensor,
                      tables: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """`encode_position`'s row as a composition: four encodes (K1 on the
    card), three plane indices, `sine_embed` and one concatenation.  The
    training render's path under autograd, the plain twin on the CPU, and
    K1f's yardstick on the card."""
    t, g3, g2 = tables, cfg.grid_3d, cfg.grid_2d
    return torch.cat([
        enc.grid_encode(x01, t["xyz"], g3),
        enc.grid_encode(_plane(x01, [0, 1]), t["xy"], g2),
        enc.grid_encode(_plane(x01, [0, 2]), t["xz"], g2),
        enc.grid_encode(_plane(x01, [1, 2]), t["yz"], g2),
        sh_ops.sine_embed(x01, cfg.pe_num_freqs),
    ], dim=-1)


def query_density(field: RadianceField, cfg: ModelConfig, aabb: torch.Tensor,
                  x_world: torch.Tensor, return_feat: bool = False,
                  tables: Optional[Dict] = None):
    """Density (+ optional geo features) at world positions (ngp.py:514-536)."""
    if cfg.unbounded:
        x01 = contract_to_unisphere(x_world, aabb)
    else:
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
    with profiling.span("render/field"):
        density, geo = query_density(field, cfg, aabb, positions, return_feat=True,
                                     tables=tables)
        return query_rgb(field, cfg, directions, geo), density


def replace_tables(field: RadianceField, new_tables: Mapping[str, torch.Tensor]) -> None:
    """Swap in decoded hash tables (update_embedding_params, ngp.py:507-512).

    In place, unlike cnc_tpu's pure version: the field owns its tables.
    """
    with torch.no_grad():
        for k in TABLES:
            field.tables[k].copy_(new_tables[k])


def split_mlp_params(field: RadianceField) -> Dict[str, torch.Tensor]:
    """Non-embedding parameters, by name (the 13-bit MLP quantization path,
    driver train_CNC_nerf_synthetic.py:508-556)."""
    return {name: p for name, p in field.named_parameters() if not name.startswith("tables.")}


def mlp_params_to_numpy(field: RadianceField) -> Dict:
    """The two MLPs in cnc_tpu's `split_mlp_params` layout, as numpy arrays:
    {"mlp_base": {"l0": {"w": [in, out], "b"}, ...}, "mlp_head": {...}} (the
    inverse of `params_from_jax` for the MLPs; what a bundle stores)."""
    def mlp(m):
        return {k: {"w": lin.w.detach().cpu().numpy().copy(),
                    "b": lin.b.detach().cpu().numpy().copy()} for k, lin in m.items()}

    return {"mlp_base": mlp(field.mlp_base), "mlp_head": mlp(field.mlp_head)}
