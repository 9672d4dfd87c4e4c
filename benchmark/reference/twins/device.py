"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`device`, or `cuda` when none is given.

    Never falls back to the CPU on its own: with no GPU and no explicit
    `device="cpu"` it raises, so a run that meant to use the card cannot
    quietly take the plain path.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run the "
                               "plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def normalize_device(device: Union[str, torch.device]) -> torch.device:
    """`device` with the current CUDA index filled in for a bare `cuda`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device

