"""Frozen copy of `cnc_torch/ops/sh.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

Closed-form real spherical harmonics and the sine positional embedding.

Port of `cnc_tpu/ops/sh.py` (tiny-cuda-nn's SphericalHarmonics encoding,
reference ngp.py:412-425, and the NeRF Embedder, ngp.py:569-617).
"""

from __future__ import annotations

import torch


def sh_encode(dirs01: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis (tcnn coefficient convention) of directions in [0, 1].

    Returns [..., degree**2].
    """
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be 1..4, got {degree}")
    d = dirs01 * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (x2 - y2),
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    return torch.stack(out, dim=-1)


def sine_embed(x: torch.Tensor, num_freqs: int = 10,
               include_input: bool = True) -> torch.Tensor:
    """NeRF positional encoding: [x], then sin and cos at 2**0 .. 2**(num_freqs-1).

    Output dim for 3-D input and 10 freqs: 3 + 3*2*10 = 63.
    """
    outs = [x] if include_input else []
    for i in range(num_freqs):
        f = float(2 ** i)
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)
