"""A run with the timed path broken underneath reads `correct` false: the
harness's look for a card skipped, the rest of a run driven at the tiny
size on the CPU, once for each fault a cell can have (one card: no exchange
between chips to leave out)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import cells
from benchmark.tests import tiny
from cnc_torch.render import renderer
from cnc_torch.train import trainer as trainer_mod

SEED = 2 ** 33 + 99


def _run(name):
    torch.set_num_threads(4)
    wl = tiny.workload(name)
    return cells.traffic(wl["traffic"]).run(wl, SEED, 0.3, False, torch.device("cpu"),
                                            time.perf_counter())


def _no_update(self, use_entropy):
    """A step that returns its state unchanged."""


def _half_batch(orig):
    def render_terms(self, rays_o, rays_d, pixels, *a, **kw):
        h = rays_o.shape[0] // 2
        return orig(self, rays_o[:h], rays_d[:h], pixels[:h], *a, **kw)
    return render_terms


def _chunk_unrendered(orig):
    """Every chunk the window renders (the calls that count into `stats`)
    comes back as background only."""

    def eval_chunk(*a, **kw):
        rgb, op, dep = orig(*a, **kw)
        if kw.get("stats") is not None:
            return torch.ones_like(rgb), torch.zeros_like(op), torch.zeros_like(dep)
        return rgb, op, dep
    return eval_chunk


TRAIN = [n for n in tiny.CELLS if cells.workload(n)["traffic"] == "train"]
SERVE = [n for n in tiny.CELLS if cells.workload(n)["traffic"] == "serve"]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults_read_incorrect(monkeypatch, name, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(trainer_mod.Trainer, "_apply_update", _no_update)
    else:
        monkeypatch.setattr(trainer_mod.Trainer, "_render_terms",
                            _half_batch(trainer_mod.Trainer._render_terms))
    run = _run(name)
    assert not run.correct, run.numbers


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_answer_reads_incorrect(monkeypatch, name):
    monkeypatch.setattr(renderer, "render_rays_eval",
                        _chunk_unrendered(renderer.render_rays_eval))
    run = _run(name)
    assert not run.correct, run.numbers


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_a_sound_run_reads_correct(name):
    assert _run(name).correct
