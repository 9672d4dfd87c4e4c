"""LPIPS (VGG16 flavor) with loadable weights.

Port of `cnc_tpu/utils/lpips_jax.py` (the pip `lpips` package the reference
drivers call, train_CNC_nerf_synthetic.py:296-298): a VGG16 backbone, unit
channel normalization of the five tap layers (relu1_2, relu2_2, relu3_3,
relu4_3, relu5_3), squared differences, learned non-negative 1x1 linear
heads, spatial means, summed.  VGG runs as `F.conv2d` / `F.max_pool2d` in
NCHW on the images' device (the images come in [H, W, 3], as cnc_tpu takes
them): this is no Pallas kernel in cnc_tpu, so the library convolutions
stay.  On the card a float32 convolution runs in TF32 unless
`torch.backends.cudnn.allow_tf32` is off; the callers that compare numbers
turn it off.

The repo ships no pretrained weights; they load from an npz written by
tools/export_lpips_weights.py, searched in this order:

  1. $CNC_LPIPS_WEIGHTS
  2. <repo>/data/lpips_vgg16.npz
  3. ~/.cache/cnc_tpu/lpips_vgg16.npz

Without weights `load_weights()` returns None and `lpips` returns None, which
callers record as "n/a" (never NaN).
"""

from __future__ import annotations

import functools
import os
import pathlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, tap after this conv?)
_VGG_PLAN = [
    (64, False), (64, True),                    # relu1_2
    (128, False), (128, True),                  # relu2_2
    (256, False), (256, False), (256, True),    # relu3_3
    (512, False), (512, False), (512, True),    # relu4_3
    (512, False), (512, False), (512, True),    # relu5_3
]
# the lpips scaling layer's constants (lpips/lpips.py ScalingLayer)
_SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def _search_paths():
    env = os.environ.get("CNC_LPIPS_WEIGHTS")
    if env:
        yield pathlib.Path(env)
    repo = pathlib.Path(__file__).resolve().parents[2]
    yield repo / "data" / "lpips_vgg16.npz"
    yield pathlib.Path.home() / ".cache" / "cnc_tpu" / "lpips_vgg16.npz"


@functools.lru_cache(maxsize=1)
def load_weights() -> Optional[Dict[str, np.ndarray]]:
    """The weights (conv{i}_w [kh, kw, in, out], conv{i}_b, lin{j}_w [C]) of
    the first file on the search path holding all of them, or None."""
    n_convs = len(_VGG_PLAN)
    n_taps = sum(1 for _, t in _VGG_PLAN if t)
    want = ({f"conv{i}_w" for i in range(n_convs)} | {f"conv{i}_b" for i in range(n_convs)}
            | {f"lin{j}_w" for j in range(n_taps)})
    for p in _search_paths():
        if p and p.exists():
            data = dict(np.load(str(p)))
            if want.issubset(data.keys()):
                return data
    return None


def _weights_on(w: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """The weights as tensors on `device`, convolutions as [out, in, kh, kw]."""
    out = {}
    for k, v in w.items():
        v = torch.from_numpy(np.asarray(v, np.float32))
        if k.endswith("_w") and v.dim() == 4:
            v = v.permute(3, 2, 0, 1)
        out[k] = v.contiguous().to(device)
    return out


def _features(w: Dict[str, torch.Tensor], img: torch.Tensor):
    """The five tap layers of images [N, 3, H, W] in [0, 1]."""
    shift = torch.as_tensor(_SHIFT, device=img.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=img.device)[None, :, None, None]
    h = (img * 2.0 - 1.0 - shift) / scale
    taps = []
    for i, (_, tap) in enumerate(_VGG_PLAN):
        h = torch.relu(F.conv2d(h, w[f"conv{i}_w"], w[f"conv{i}_b"], padding=1))
        if tap:
            taps.append(h)
            if len(taps) < 5:
                h = F.max_pool2d(h, 2, 2)
    return taps


def lpips(img1, img2, weights: Optional[Dict[str, np.ndarray]] = None) -> Optional[float]:
    """LPIPS distance of two [H, W, 3] images in [0, 1] (tensors or numpy
    arrays; tensors are compared on their device); None without weights."""
    w = weights if weights is not None else load_weights()
    if w is None:
        return None
    a = torch.as_tensor(img1, dtype=torch.float32)
    b = torch.as_tensor(img2, dtype=torch.float32).to(a.device)
    wt = _weights_on(w, a.device)
    with torch.no_grad():
        tx, ty = _features(wt, a.permute(2, 0, 1)[None]), _features(wt, b.permute(2, 0, 1)[None])
        total = 0.0
        for j, (fx, fy) in enumerate(zip(tx, ty)):
            nx = fx / torch.sqrt(torch.sum(fx ** 2, 1, keepdim=True) + 1e-10)
            ny = fy / torch.sqrt(torch.sum(fy ** 2, 1, keepdim=True) + 1e-10)
            d2 = (nx - ny) ** 2                                     # [1, C, H, W]
            lin = torch.clamp(wt[f"lin{j}_w"], min=0.0)[None, :, None, None]
            total = total + torch.mean(torch.sum(d2 * lin, 1))
    return float(total)
