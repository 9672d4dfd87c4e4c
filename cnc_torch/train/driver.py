"""The pipeline driver (port of `cnc_tpu/train/driver.py`).

Only `decode_bundle` is ported so far: it serves a compressed scene.
`run_pipeline`, `run_with_trainer`, the TSV row and the CLI come with port
slice 5.
"""

from __future__ import annotations

import json
import os
import time

import torch

from ..codec import codec as codec_mod
from ..config import CNCConfig
from ..models import context_models as cm
from ..models import radiance_field as rf
from ..utils.device import resolve_device


def decode_bundle(stream_dir: str, device=None, log_fn=print):
    """Rebuild a renderable radiance field from a self-contained bitstream
    directory, in a fresh process: the config from meta.json, the context
    and MLP weights and the occupancy grid from meta.npz, the hash tables
    decoded from the streams.  Reads bundles of either package.

    Returns (field: RadianceField, binaries: bool [R, R, R], cfg) on `device`
    (the card unless device="cpu"), ready for `render_image`."""
    dev = resolve_device(device)
    with open(os.path.join(stream_dir, "meta.json")) as fh:
        meta = json.load(fh)
    cfg = CNCConfig.from_dict(meta["config"])
    entropy = cm.ContextModels(cfg.entropy, cfg.model.grid_3d, cfg.model.grid_2d, device=dev)
    pgs, ent_params, mlp_params, binaries = codec_mod.load_bundle(stream_dir)
    binaries = torch.from_numpy(binaries).to(dev)
    codec = codec_mod.CNCCodec(entropy)
    t0 = time.time()
    rec = codec.decode(ent_params, binaries, pgs, stream_dir, prefix="b")
    log_fn(f"decoded bundle {stream_dir} in {time.time() - t0:.1f}s")
    tables = {k: v.cpu().numpy() for k, v in rec.items()}
    field = rf.params_from_jax({**tables, **mlp_params}, cfg.model, device=dev)
    return field, binaries, cfg
