"""Frozen copy of `cnc_torch/ops/ste.py`, its plain path only (no CUDA kernel);
what follows is the original's description.

Straight-through estimators and clipped activations.

Port of `cnc_tpu/ops/ste.py`, as `torch.autograd.Function`s:
  * STE_binary (reference ngp.py:22-39): forward maps >=0 -> +1, <0 -> -1;
    backward passes the gradient only where the input lies in [-1, 1].
  * STE_multistep (ngp.py:41-47): round(x*Q)/Q with identity gradient.
  * trunc_exp (ngp.py:318-334): exp forward, backward g*exp(clamp(x, max=15)).
"""

from __future__ import annotations

import torch


class _SteBinary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


class _SteMultistep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q):
        return torch.round(x * q) / q

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def ste_binary(x: torch.Tensor) -> torch.Tensor:
    return _SteBinary.apply(x)


def ste_multistep(x: torch.Tensor, q: float) -> torch.Tensor:
    return _SteMultistep.apply(x, q)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def quantize_embedding(params: torch.Tensor, mode: str, q: float = 10.0) -> torch.Tensor:
    """Apply the configured table quantization (GridEncoder.forward, ngp.py:244-252).

    The training-time "add_noise" mode comes with training.
    """
    if mode == "ste_binary":
        return ste_binary(params)
    if mode == "ste_multistep":
        return ste_multistep(params, q)
    if mode == "none":
        return params
    raise ValueError(f"unknown quantize mode: {mode}")
