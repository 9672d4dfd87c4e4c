"""The control on the card: the reference computed in TF32 (the nearest
precision below the configuration's float32 with TF32 off), put in the
program's place, reads `correct` false against each cell's limits, at a
size a test run holds (the tiny configuration), on three seeds.  The same
control at the cells' own sizes is `benchmark/calibrate.py`'s `control`
reading, which PERF.md gives.

    python -m pytest benchmark/tests/test_control_gpu.py -m gpu -q   (on the card)
"""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import cells, scenes
from benchmark.reference import compare, train_ref
from benchmark.tests import tiny

pytestmark = pytest.mark.gpu
SEEDS = (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return torch.device("cuda", 0)


def _inputs(wl, seed, device):
    c = wl["cfg"]
    r = c["cnc_config"]["render"]
    views = scenes.TrainViews(c["scene"], r["aabb"], c["train_images"], c["train_width"],
                              c["train_height"], seed, device)
    occs, binaries = scenes.occupancy(c["scene"], r["aabb"], r["occ_resolution"],
                                      r["render_step_size"], r["occ_thre"], device)
    return views, occs, binaries


@pytest.mark.parametrize("name", [n for n in tiny.CELLS
                                  if cells.workload(n)["traffic"] == "train"])
def test_training_control_reads_incorrect(card, name):
    wl = tiny.workload(name)
    p = wl["params"]
    for seed in SEEDS:
        views, occs, binaries = _inputs(wl, seed, card)
        args = (wl["cfg"]["cnc_config"], views, seed, p["start_step"], p["rays"], occs,
                binaries, p["check_steps"], card)
        numbers = compare.train(train_ref.steps(*args, tf32=True), train_ref.steps(*args),
                                cells.workload(name)["check"]["limits"])
        assert not compare.correct(numbers), numbers


@pytest.mark.parametrize("name", [n for n in tiny.CELLS
                                  if cells.workload(n)["traffic"] == "serve"])
def test_serving_control_reads_incorrect(card, name):
    wl = tiny.workload(name)
    p, c = wl["params"], wl["cfg"]
    sv = cells.traffic("serve")
    for seed in SEEDS:
        binaries = sv.grid(wl, card)
        rays = sv.view_rays(wl, seed, card)
        view, chunks = sv.check_sample(wl, seed, range(p["views"]))
        args = (c["cnc_config"], seed, binaries, rays[view], p["chunk"], chunks, card)
        numbers = compare.serve(sv.reference_chunks(*args, tf32=True), sv.reference_chunks(*args),
                                cells.workload(name)["check"]["limits"])
        assert not compare.correct(numbers), numbers
