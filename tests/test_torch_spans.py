"""cnc_torch's spans (utils/profiling.span) on the CPU: the tree one tiny
rate step and one tiny view record under torch.profiler, the count kept
beside them, no range created while no profiler runs, and the same loss,
gradients, parameters and pixels with tracing on and off."""

import json
from collections import Counter

import pytest
import torch

from cnc_torch import config as tconfig
from cnc_torch.data import scenes as tscenes
from cnc_torch.render import renderer
from cnc_torch.utils import profiling

from test_torch_train_rate import _port_trainer, tiny_config

CHUNK = 96


@pytest.fixture(scope="module")
def dataset():
    return tscenes.ProceduralDataset("sphere", n_images=2, width=16, height=12, n_steps_gt=64,
                                     device="cpu")


def _trainer(dataset):
    return _port_trainer(tiny_config(tconfig), dataset)


def _step(tr):
    """One rate step through `fit`; its aux."""
    out = []
    tr.fit(max_steps=tr.step, log_every=0, step_callback=lambda s, aux: out.append(aux))
    return out[0]


def _view(tr, stats=None):
    """A 16 x 12 view of the trainer's field in chunks of CHUNK rays."""
    rays, _ = tr.dataset.image_and_rays(0)
    return renderer.render_image(tr.field, tr.cfg.model, tr.cfg.render, tr.aabb,
                                 tr.occ_state.binaries, rays.origins, rays.viewdirs,
                                 torch.ones(3), chunk=CHUNK, device="cpu", stats=stats)


def _traced(fn, tmp_path):
    """fn() under a CPU profiler: (its result, the trace's cnc/ spans sorted
    by start)."""
    profiling.recorded.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e for e in evs if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e["name"].startswith(profiling.PREFIX)), key=lambda e: e["ts"])
    return out, spans


def _named(spans, name):
    return [s for s in spans if s["name"] == profiling.PREFIX + name]


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _holder(span, spans, name):
    """The one span `name` that holds `span`."""
    found = [o for o in _named(spans, name) if _inside(span, o)]
    assert len(found) == 1, (span["name"], name, len(found))
    return found[0]


def test_rate_step_records_the_span_tree(dataset, tmp_path):
    tr = _trainer(dataset)
    ent = tr.entropy
    _, spans = _traced(lambda: _step(tr), tmp_path)
    step, = _named(spans, "train/step")
    for name in ("train/occupancy", "train/cache", "train/fetch", "train/render", "train/rate",
                 "train/backward", "train/update", "sync/draw_starts", "sync/level_resolutions",
                 "sync/host_scalar", "sync/step_end"):
        s, = _named(spans, name)
        assert _inside(s, step), name
    n_pg = 3 * len(ent.spec2.level_sizes) + len(ent.spec3.level_sizes)
    want = {"rate/pg_bits": n_pg, "rate/frac_plane": 3,
            "rate/window_2d": 3 * len(ent.ctx_levels_2d), "rate/sampled_3d": 1}
    for name, n in want.items():
        assert len(_named(spans, name)) == n, name
        for s in _named(spans, name):
            _holder(s, spans, "train/rate")
    for name in ("render/march", "render/field", "render/composite"):
        s, = _named(spans, name)
        _holder(s, spans, "train/render")
    # three plane indices a field query: the render's and the occupancy update's
    planes = _named(spans, "sync/plane_index")
    assert len(planes) == 6 and sum(_inside(p, _named(spans, "render/field")[0])
                                    for p in planes) == 3
    assert sum(n for k, n in profiling.recorded.items() if k.startswith("sync/")) == 4 + 6
    assert profiling.recorded == Counter(s["name"][len(profiling.PREFIX):] for s in spans)


def test_view_records_a_round_per_alive_test(dataset, tmp_path):
    tr = _trainer(dataset)
    _step(tr)
    stats = {}
    _, spans = _traced(lambda: _view(tr, stats), tmp_path)
    view, = _named(spans, "serve/view")
    chunks = _named(spans, "serve/chunk")
    assert len(chunks) == -(-16 * 12 // CHUNK) and all(_inside(c, view) for c in chunks)
    rounds, alive = _named(spans, "serve/round"), _named(spans, "sync/alive")
    # every round holds its chunk's alive test; a round that finds no ray
    # alive ends its chunk's loop and holds nothing else
    assert len(rounds) == len(alive)
    for r in rounds:
        _holder(r, spans, "serve/chunk")
    for a in alive:
        _holder(a, spans, "serve/round")
    full = [r for r in rounds if any(_inside(m, r) for m in _named(spans, "render/march"))]
    assert len(full) == stats["rounds"] and 0 < stats["rounds"] <= len(rounds)
    assert len(rounds) - len(full) <= len(chunks)
    for name in ("render/march", "render/field", "render/composite"):
        held = [_holder(s, spans, "serve/round") for s in _named(spans, name)]
        assert len(held) == stats["rounds"] and {id(r) for r in held} == {id(r) for r in full}
    for p in _named(spans, "sync/plane_index"):
        _holder(p, spans, "render/field")
    assert len(_named(spans, "sync/plane_index")) == 3 * stats["rounds"]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_no_range_without_a_profiler(dataset, tmp_path, monkeypatch, kind):
    tr = _trainer(dataset)
    if kind == "serve":
        _step(tr)
    run = (lambda: _step(tr)) if kind == "train" else (lambda: _view(tr))
    made = []
    real = torch.profiler.record_function

    def counted(*a, **kw):
        made.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    profiling.recorded.clear()
    run()
    assert made == [] and not profiling.recorded
    assert profiling.span("train/step") is profiling.span("serve/view", {"chunk": 0})
    _, spans = _traced(run, tmp_path)
    assert sorted(made) == sorted(s["name"] for s in spans) and len(made) > 5


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_tracing_leaves_the_numbers_bit_equal(dataset, tmp_path, kind):
    out = []
    for traced in (False, True):
        tr = _trainer(dataset)
        if kind == "train":
            run = lambda: _step(tr)
        else:
            _step(tr)
            run = lambda: _view(tr)
        got = _traced(run, tmp_path)[0] if traced else run()
        if kind == "train":
            named = {**{"field." + k: p for k, p in tr.field.named_parameters()},
                     **{"context." + k: p for k, p in tr.ent_params.named_parameters()}}
            got = {**{k: got[k] for k in ("mse", "bits_per_param")},
                   **{"grad." + k: p.grad for k, p in named.items()},
                   **{"param." + k: p.detach() for k, p in named.items()}}
        else:
            got = dict(zip(("rgb", "opacity", "depth"), got))
        out.append(got)
    plain, traced = out
    assert plain.keys() == traced.keys()
    for k in plain:
        if plain[k] is None:
            assert traced[k] is None, k
        else:
            assert torch.equal(plain[k], traced[k]), k
