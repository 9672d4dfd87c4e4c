"""Initial weights drawn from the seed, the same for the program and the
reference.

One generator on the device, one uniform draw for all the leaves of a
module, cut into leaves in the order of their names: a hash table
U(-1e-4, 1e-4) (the reference's GridEncoder init), a Linear's `w` [in, out]
and `b` U(-1/sqrt(in), 1/sqrt(in)) (torch's nn.Linear init, which both
packages use).  The program's module and the reference's copy of it name
their leaves alike, so both get the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

TABLE_BOUND = 1e-4
SALT = {"field": 0x5EED0001, "context": 0x5EED0002}


def bounds(module: torch.nn.Module) -> Dict[str, float]:
    """Each leaf's bound, by name."""
    shapes = {n: p.shape for n, p in module.named_parameters()}
    out = {}
    for name, shape in shapes.items():
        if name.startswith("tables."):
            out[name] = TABLE_BOUND
        elif name.endswith(".w"):
            out[name] = 1.0 / math.sqrt(shape[0])
        elif name.endswith(".b"):
            out[name] = 1.0 / math.sqrt(shapes[name[:-2] + ".w"][0])
        else:
            raise ValueError(f"no initial bound for leaf {name}")
    return out


def draw(module: torch.nn.Module, seed: int, part: str) -> Dict[str, torch.Tensor]:
    """The leaves' initial values on the module's device, by name."""
    params = dict(module.named_parameters())
    dev = next(iter(params.values())).device
    names = sorted(params)
    gen = torch.Generator(device=dev).manual_seed((seed ^ SALT[part]) % (1 << 63))
    u = torch.rand(sum(params[n].numel() for n in names), generator=gen, device=dev)
    b = bounds(module)
    out, off = {}, 0
    for n in names:
        k = params[n].numel()
        out[n] = ((u[off:off + k] * 2.0 - 1.0) * b[n]).reshape(params[n].shape)
        off += k
    return out


@torch.no_grad()
def load(module: torch.nn.Module, seed: int, part: str) -> None:
    params = dict(module.named_parameters())
    for name, value in draw(module, seed, part).items():
        params[name].copy_(value)
