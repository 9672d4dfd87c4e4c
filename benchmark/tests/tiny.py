"""Tiny versions of the cells, for the CPU tests: the harness's own code
at sizes this machine holds (the tests' tiny grids of the port's CPU
tests), the program on its plain twins."""

from __future__ import annotations

import copy
import dataclasses

from benchmark.harness import cells
from cnc_torch import config as tconfig

CELLS = [w["name"] for w in cells.manifest()["workloads"]]


def tiny_cnc(render=None) -> dict:
    ns = tconfig
    cfg = ns.CNCConfig(
        model=ns.ModelConfig(n_features_per_level=2, n_neurons=32,
                             resolutions_3d=(10, 18, 34, 66), resolutions_2d=(18, 34),
                             log2_hashmap_size=10, log2_hashmap_size_2D=8, pe_num_freqs=4),
        render=dataclasses.replace(ns.RenderConfig(), render_step_size=0.02, occ_resolution=16,
                                   sample_budget=1 << 13, march_block=32, eval_chunk_rays=256,
                                   **(render or {})),
        train=dataclasses.replace(ns.TrainConfig(), init_batch_size=256, min_ray_bucket=256,
                                  max_ray_bucket=2048, target_sample_batch_size=1 << 13,
                                  lmbda=2e-3, warmup_iters=20, lr_milestones=(60, 80)),
        entropy=ns.EntropyConfig(n_features=2, sample_num=500, max_context_layer_num=2,
                                 Pg_level=4, Pg_level_2D=2, skip_levels_3d=(0, 1),
                                 skip_levels_2d=(0,), Rb=16, pn_coords_cap=1 << 17,
                                 pn_frac_sample_cap=1 << 10, sample_num_2d=100,
                                 v_ctx_cap_2d=256, v_ctx_cap=1 << 11))
    return cfg.to_dict()


def workload(name: str) -> dict:
    """The cell's workload with its configuration cut to the tiny size."""
    wl = copy.deepcopy(cells.workload(name))
    render = wl["cfg"]["cnc_config"]["render"]
    wl["cfg"]["cnc_config"] = tiny_cnc({"aabb": tuple(render["aabb"]),
                                        "near_plane": render["near_plane"]})
    wl["cfg"].update(train_images=4, train_width=16, train_height=12)
    p = wl["params"]
    if wl["traffic"] == "train":
        p.update(rays=512, start_step=256, check_steps=3, warm_steps=2, trace_steps=2)
    else:
        p.update(width=20, height=16, views=3, warm_views=1, chunk=128, trace_views=2,
                 check_chunks=2)
    return wl
