"""cnc_torch's spans on the card: each host-device sync of a rate step and
of a view lies in a `cnc/sync/*` span, and the spans share the clock of
the card's operations.

Marked `gpu`: they need an NVIDIA GPU and nvcc, and skip without them.
They import neither JAX nor cnc_tpu:

    python -m pytest tests/test_torch_spans_gpu.py --noconftest -m gpu -q

torch's sync debug mode warns at every call that waits for the card (a
read to the host, a copy from pageable memory, a synchronise): two rate
steps through `Trainer.fit` and one view through `render_image` give as
many warnings as sync spans in a profiled run of the same work.  In a
profiled run of both, no device operation starts before the span its
launch call lies in started.
"""

import dataclasses
import json
import warnings

import pytest
import torch

from cnc_torch import kernels
from cnc_torch.config import CNCConfig, EntropyConfig, ModelConfig, RenderConfig, TrainConfig
from cnc_torch.data import scenes
from cnc_torch.models import context_models as cm
from cnc_torch.render import renderer
from cnc_torch.train.trainer import Trainer
from cnc_torch.utils import profiling

pytestmark = pytest.mark.gpu

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kernels.lib()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def trainer(dev):
    cfg = CNCConfig(
        model=ModelConfig(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34, 66),
                          resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=8,
                          pe_num_freqs=4),
        render=dataclasses.replace(RenderConfig(), render_step_size=0.02, occ_resolution=16,
                                   sample_budget=1 << 13, march_block=32, eval_chunk_rays=256),
        train=dataclasses.replace(TrainConfig(), init_batch_size=256, min_ray_bucket=256,
                                  max_ray_bucket=2048, target_sample_batch_size=1 << 13,
                                  lmbda=2e-3, warmup_iters=20, lr_milestones=(60, 80)),
        entropy=EntropyConfig(n_features=2, sample_num=500, max_context_layer_num=2,
                              Pg_level=4, Pg_level_2D=2, skip_levels_3d=(0, 1),
                              skip_levels_2d=(0,), Rb=16, pn_coords_cap=1 << 17,
                              pn_frac_sample_cap=1 << 10, sample_num_2d=100, v_ctx_cap=1 << 15))
    ds = scenes.ProceduralDataset("sphere", n_images=4, width=32, height=24, n_steps_gt=128,
                                  device=dev)
    tr = Trainer(cfg, ds, entropy=cm.ContextModels(cfg.entropy, cfg.model.grid_3d,
                                                   cfg.model.grid_2d))
    tr.fit(max_steps=3, log_every=0)            # warm: every shape and lazy set-up
    _view(tr)
    torch.cuda.synchronize()
    return tr


def _steps(tr):
    """Two rate steps through `fit` (the first refreshes the grid and the
    cache, as a continued run's first step does)."""
    tr.fit(max_steps=tr.step + 1, log_every=0)


def _view(tr):
    rays, _ = tr.dataset.image_and_rays(0)
    renderer.render_image(tr.field, tr.cfg.model, tr.cfg.render, tr.aabb, tr.occ_state.binaries,
                          rays.origins, rays.viewdirs, torch.ones(3, device=tr.device),
                          device=tr.device)


def _profiled(fn, tmp_path):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _sync_warnings(fn):
    """fn() under torch's sync debug mode: where each sync was called from."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


def test_spans_share_the_devices_clock(trainer, tmp_path):
    """The file's one profile of the card (a process's later profiles may
    stamp the card's operations less exactly): two rate steps and a view."""
    evs = _profiled(lambda: (_steps(trainer), _view(trainer)), tmp_path)
    by_corr = {}
    for e in evs:
        if e.get("cat") in DEVICE_CATS:
            by_corr.setdefault(e["args"].get("correlation"), []).append(e)
    spans = [e for e in evs if e.get("cat") == "user_annotation"
             and e["name"].startswith(profiling.PREFIX)]
    launches = [e for e in evs if e.get("cat") == "cuda_runtime"
                and by_corr.get(e["args"].get("correlation"))]
    early, checked = [], 0
    for s in spans:
        for e in launches:
            if e["tid"] == s["tid"] and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]:
                for op in by_corr[e["args"]["correlation"]]:
                    checked += 1
                    if op["ts"] < s["ts"]:
                        early.append((s["name"], op["name"][:60], s["ts"] - op["ts"]))
    assert checked > 1000 and early == []


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_every_sync_lies_in_a_sync_span(trainer, kind):
    fn = (lambda: _steps(trainer)) if kind == "train" else (lambda: _view(trainer))
    where = _sync_warnings(fn)
    profiling.recorded.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    spans = {k: n for k, n in profiling.recorded.items() if k.startswith("sync/")}
    assert len(where) == sum(spans.values()) > 0, (sorted(set(where)), spans)
