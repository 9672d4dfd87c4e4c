"""The reference of the serving cells: chunks of a view's rays rendered in
plain torch (the frozen twins' eval loop: rounds of march, field and
composite from per-ray cursors), from the benchmark's own weights,
occupancy grid and rays."""

from __future__ import annotations

import torch

from ..harness import weights
from .twins import config as tconfig
from .twins import radiance_field as rf
from .twins import renderer


def field(cnc: dict, seed: int, device):
    cfg = tconfig.CNCConfig.from_dict(cnc)
    dev = torch.device(device)
    f = rf.RadianceField(cfg.model, torch.Generator(device=dev).manual_seed(0), device=dev)
    weights.load(f, seed, "field")
    return cfg, f


@torch.no_grad()
def chunk(cfg, f, binaries, rays_o, rays_d, tf32: bool = False):
    """(rgb [R,3], opacity [R,1], depth [R,1]) of one chunk of rays, by the
    eval loop's rounds; `tf32` computes the float32 matmuls in TF32 (the
    control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        dev = rays_o.device
        return renderer.render_rays_eval(f, cfg.model, cfg.render,
                                         torch.tensor(cfg.render.aabb, dtype=torch.float32,
                                                      device=dev),
                                         binaries.to(dev).bool(), rays_o, rays_d,
                                         torch.ones(3, device=dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
