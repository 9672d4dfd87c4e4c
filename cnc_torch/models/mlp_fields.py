"""Classic MLP radiance fields: vanilla NeRF, T-NeRF and the NDR warp field.

Port of `cnc_tpu/models/mlp_fields.py` (the reference's example fields,
examples/radiance_fields/mlp.py:14-395): an 8x256 trunk with a skip
connection after layer 4, a viewdir-conditioned color head, optional time
conditioning (D-NeRF / T-NeRF), and the NDR invertible-warp deformation
field (mlp.py:286-395, arXiv:2206.15258).  Unused by the CNC drivers;
provided so that nerfacc-style pipelines have their model family.

The fields are `nn.Module`s with cnc_tpu's parameter layout (each layer the
port's `Linear`, `w` stored [in, out]), so `params_from_jax` carries a
cnc_tpu init dict across and both packages compute the same field.  Plain
torch on the parameters' device: matrix products and elementwise maps, no
kernel of cnc_tpu's lies here.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..ops import sh as sh_ops
from ..utils.device import resolve_device
from .radiance_field import Linear


def _leaf(params: Optional[Mapping], path, shape, fill, device) -> torch.Tensor:
    """The array at `path` of a numpy param tree, or `fill()` without one."""
    if params is None:
        return fill().to(device)
    src = params
    for k in path:
        src = src[k]
    t = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{'/'.join(map(str, path))}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.to(device)


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    # drawn on the generator's device: a seed gives the same weights anywhere
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def _linear(g, params, path, fan_in, fan_out, device) -> Linear:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for W and b (torch nn.Linear's
    default, cnc_tpu's `_linear_init`)."""
    bound = 1.0 / math.sqrt(fan_in)
    return Linear(_leaf(params, path + ("w",), (fan_in, fan_out),
                        lambda: _uniform(g, (fan_in, fan_out), -bound, bound), device),
                  _leaf(params, path + ("b",), (fan_out,),
                        lambda: _uniform(g, (fan_out,), -bound, bound), device))


class VanillaNeRF(nn.Module):
    """The 8x256 NeRF MLP (mlp.py VanillaNeRFRadianceField); with
    `time_input`, the T-NeRF variant conditioned on a timestamp."""

    def __init__(self, generator: Optional[torch.Generator] = None, net_depth: int = 8,
                 net_width: int = 256, skip_layer: int = 4, pe_freqs: int = 10,
                 dir_freqs: int = 4, time_input: bool = False, device=None,
                 params: Optional[Mapping] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        if params is not None:
            meta = params["meta"]
            skip_layer, pe_freqs = int(meta["skip_layer"]), int(meta["pe_freqs"])
            dir_freqs, time_input = int(meta["dir_freqs"]), bool(meta["time_input"])
            net_depth = len(params["trunk"])
            net_width = int(np.shape(params["trunk"][0]["w"])[1])
        self.skip_layer, self.pe_freqs = skip_layer, pe_freqs
        self.dir_freqs, self.time_input = dir_freqs, time_input
        pos_dim = 3 + 3 * 2 * pe_freqs + (1 + 2 * 4 if time_input else 0)
        dir_dim = 3 + 3 * 2 * dir_freqs
        trunk, in_dim = [], pos_dim
        for i in range(net_depth):
            if i == skip_layer + 1:
                in_dim = net_width + pos_dim
            trunk.append(_linear(g, params, ("trunk", i), in_dim, net_width, device))
            in_dim = net_width
        self.trunk = nn.ModuleList(trunk)
        self.sigma = _linear(g, params, ("sigma",), net_width, 1, device)
        self.bottleneck = _linear(g, params, ("bottleneck",), net_width, net_width, device)
        self.rgb0 = _linear(g, params, ("rgb0",), net_width + dir_dim, net_width // 2, device)
        self.rgb1 = _linear(g, params, ("rgb1",), net_width // 2, 3, device)

    def forward(self, x: torch.Tensor, dirs: torch.Tensor, t: Optional[torch.Tensor] = None):
        return forward(self, x, dirs, t)


def _trunk(field: VanillaNeRF, x_enc: torch.Tensor) -> torch.Tensor:
    h = x_enc
    for i, layer in enumerate(field.trunk):
        if i == field.skip_layer + 1:
            h = torch.cat([h, x_enc], -1)
        h = torch.relu(layer(h))
    return h


def query_density(field: VanillaNeRF, x: torch.Tensor, t: Optional[torch.Tensor] = None,
                  return_feat: bool = False):
    """Density [N] at positions x [N, 3] (and times t [N, 1] for T-NeRF)."""
    enc = sh_ops.sine_embed(x, field.pe_freqs)
    if field.time_input:
        if t is None:
            raise ValueError("query_density: a time-conditioned field needs t")
        enc = torch.cat([enc, sh_ops.sine_embed(t, 4)], -1)
    h = _trunk(field, enc)
    sigma = torch.relu(field.sigma(h))[..., 0]
    if return_feat:
        return sigma, h
    return sigma


def forward(field: VanillaNeRF, x: torch.Tensor, dirs: torch.Tensor,
            t: Optional[torch.Tensor] = None):
    """(rgb [N, 3], sigma [N]) at positions x and view directions dirs."""
    sigma, h = query_density(field, x, t, return_feat=True)
    b = field.bottleneck(h)
    d_enc = sh_ops.sine_embed(dirs, field.dir_freqs)
    h2 = torch.relu(field.rgb0(torch.cat([b, d_enc], -1)))
    return torch.sigmoid(field.rgb1(h2)), sigma


# --------------------------------------------------------------- NDR field
# Invertible coordinate warp ahead of a static vanilla NeRF
# (NDRTNeRFRadianceField, mlp.py:286-395): three real-NVP-style coupling
# blocks, each lifting (uv, w) -> (R(-theta)(uv - t), w + dw) with dw, theta
# and t predicted from positional and time encodings, and a coordinate roll
# between blocks; the U(0, 1e-4) output layers start the warp at about the
# identity.

class SmallMLP(nn.Module):
    """Hidden ReLU layers and a U(0, 1e-4) output layer with zero bias
    (the reference's output_init, mlp.py:300-322)."""

    def __init__(self, g, params, path, in_dim: int, widths, out_dim: int, device):
        super().__init__()
        hidden, d = [], in_dim
        for i, w in enumerate(widths):
            hidden.append(_linear(g, params, path + ("hidden", i), d, w, device))
            d = w
        self.hidden = nn.ModuleList(hidden)
        self.out = Linear(
            _leaf(params, path + ("out", "w"), (d, out_dim),
                  lambda: _uniform(g, (d, out_dim), 0.0, 1e-4), device),
            _leaf(params, path + ("out", "b"), (out_dim,),
                  lambda: torch.zeros(out_dim), device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.hidden:
            h = torch.relu(layer(h))
        return self.out(h)


class NDRField(nn.Module):
    """The NDR deformation field over a vanilla NeRF (mlp.py:290-337)."""

    def __init__(self, generator: Optional[torch.Generator] = None, device=None,
                 params: Optional[Mapping] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        pe1 = 2 * (1 + 2 * 4)       # posi_encoder_1: 2-dim uv, 4 freqs, identity
        pe2 = 1 * (1 + 2 * 4)       # posi_encoder_2: 1-dim w
        te = 1 * (1 + 2 * 4)        # time encoder
        blocks = []
        for i in range(3):
            p = ("blocks", i)
            blocks.append(nn.ModuleDict({
                "warp1": SmallMLP(g, params, p + ("warp1",), pe1 + 64, (128, 128), 1, device),
                "warp2": SmallMLP(g, params, p + ("warp2",), pe2 + 64, (128,), 3, device),
                "time1": _linear(g, params, p + ("time1",), te, 64, device),
                "time2": _linear(g, params, p + ("time2",), te, 64, device),
            }))
        self.blocks = nn.ModuleList(blocks)
        self.nerf = VanillaNeRF(g, device=device,
                                params=None if params is None else params["nerf"])

    def forward(self, x: torch.Tensor, dirs: torch.Tensor, t: torch.Tensor):
        return ndr_forward(self, x, dirs, t)


def _ndr_block(block: nn.ModuleDict, x: torch.Tensor, t_enc: torch.Tensor) -> torch.Tensor:
    """One coupling block (mlp.py:339-357)."""
    uv, w = x[:, :2], x[:, 2:]
    dw = block["warp1"](torch.cat([sh_ops.sine_embed(uv, 4), block["time1"](t_enc)], -1))
    w = w + dw
    rt = block["warp2"](torch.cat([sh_ops.sine_embed(w, 4), block["time2"](t_enc)], -1))
    theta, tr = rt[:, 0], rt[:, 1:]
    c, s = torch.cos(theta), torch.sin(theta)
    d = uv - tr
    # R(-theta) @ (uv - t)  (euler2rot_2dinv, mlp.py:385-395)
    uv = torch.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], -1)
    return torch.cat([uv, w], -1)


def ndr_warp(field: NDRField, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x [N, 3], t [N, 1] timestamps -> warped coordinates (mlp.py:359-366)."""
    t_enc = sh_ops.sine_embed(t, 4)
    x = _ndr_block(field.blocks[0], x, t_enc)
    x = x[..., [1, 2, 0]]
    x = _ndr_block(field.blocks[1], x, t_enc)
    x = x[..., [2, 0, 1]]
    return _ndr_block(field.blocks[2], x, t_enc)


def ndr_query_density(field: NDRField, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return query_density(field.nerf, ndr_warp(field, x, t))


def ndr_forward(field: NDRField, x: torch.Tensor, dirs: torch.Tensor, t: torch.Tensor):
    return forward(field.nerf, ndr_warp(field, x, t), dirs)


def ndr_query_opacity(field: NDRField, generator: torch.Generator, x: torch.Tensor,
                      timestamps: torch.Tensor, step_size: float) -> torch.Tensor:
    """Random-timestamp opacity proxy (mlp.py:368-376): each point takes one
    of `timestamps`, drawn from `generator`."""
    idx = torch.randint(timestamps.shape[0], (x.shape[0],), generator=generator,
                        device=generator.device).to(timestamps.device)
    t = timestamps[idx].reshape(-1, 1)
    return ndr_query_density(field, x, t) * step_size

