"""Image quality metrics: MSE, PSNR, SSIM and LPIPS.

Port of `cnc_tpu/utils/metrics.py`: PSNR as the driver computes it
(train_CNC_nerf_synthetic.py:372), SSIM with an 11x11 gaussian window
(pytorch_ssim.py:8-120), and LPIPS through `utils/lpips.py`, which needs
VGG weights the repo does not ship: `lpips_fn` returns None when no weight
file is found (see `lpips.load_weights`' search paths), and the drivers
record "n/a".
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """-10 log10(mse)."""
    return -10.0 * torch.log(mse(a, b)) / math.log(10.0)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    g = torch.exp(-((torch.arange(size, device=device) - size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [H, W, C] images in [0, 1].

    The variance terms are small differences of window sums, so the
    convolutions must run in full float32 (no TF32 on the GPU).
    """
    c = img1.shape[-1]
    win = _gaussian_window(window_size, 1.5, img1.device).to(img1.dtype)
    kernel = win[None, None].expand(c, 1, window_size, window_size).contiguous()
    x = img1.permute(2, 0, 1)[None]  # NCHW
    y = img2.permute(2, 0, 1)[None]
    conv = lambda z: F.conv2d(z, kernel, padding=window_size // 2, groups=c)
    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = conv(x * x) - mu1_sq
    sigma2 = conv(y * y) - mu2_sq
    sigma12 = conv(x * y) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))
    return m.mean()


def lpips_fn(img1, img2) -> Optional[float]:
    """VGG16 LPIPS of two [H, W, 3] images; None when no weights are found."""
    from . import lpips
    return lpips.lpips(img1, img2)
