"""The field's input row (`radiance_field.encode_position`) and its dispatch
between the composition and K1f, on the CPU.

On the CPU `encode_position` is the composition (four encodes, the plane
indices, `sine_embed`, one concatenation); on the card, for a query that no
gradient reaches, it is one launch of K1f (`encoding.field_input`).  These
tests hold the CPU row to the composition exactly, check the dispatch
predicate without a card (a tensor subclass that says it lies on the card)
and route a query to a stand-in for the wrapper.  The kernel itself is held
to the composition and to the plain twin on the card in
tests/test_torch_field_input_gpu.py.
"""

import pytest
import torch

from cnc_torch import kernels
from cnc_torch.config import ModelConfig
from cnc_torch.models import radiance_field as rf
from cnc_torch.ops import encoding as enc

SMALL = ModelConfig(n_features_per_level=2, n_neurons=32, resolutions_3d=(10, 18, 34),
                    resolutions_2d=(18, 34), log2_hashmap_size=10, log2_hashmap_size_2D=10,
                    pe_num_freqs=4)
CFGS = {"small": SMALL, "published": ModelConfig()}


class OnTheCard(torch.Tensor):
    """A CPU tensor that answers `is_cuda` as a card tensor does."""

    @property
    def is_cuda(self):
        return True


def _points(n, seed):
    """Uniform points in [0,1]^3, then rows outside it, on 0 and 1, with one
    coordinate outside and the rest inside, and a NaN."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, generator=g)
    x[0] = torch.tensor([0.0, 1.0, 0.5])
    x[1] = torch.tensor([1.0, 1.0, 1.0])
    x[2] = torch.tensor([0.0, 0.0, 0.0])
    x[3] = torch.tensor([-0.25, 0.5, 0.5])       # outside in x: the yz plane still reads
    x[4] = torch.tensor([0.5, 1.5, 0.5])         # outside in y: the xz plane still reads
    x[5] = torch.tensor([0.5, 0.5, -1e-7])       # outside in z: the xy plane still reads
    x[6] = torch.tensor([float("nan"), 0.5, 0.5])
    x[7] = torch.tensor([2.0, -3.0, 7.5])
    return x


def _field(cfg, seed=0):
    field = rf.RadianceField(cfg, torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():
        for k in rf.TABLES:        # a spread of values, as trained tables have
            field.tables[k].normal_(generator=torch.Generator().manual_seed(seed + 1))
    return field


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("name", list(CFGS))
def test_encode_position_on_the_cpu_is_the_composition(name, grad):
    cfg = CFGS[name]
    field = _field(cfg)
    x01 = _points(300, 3)
    kernels.reset_launches()
    with torch.set_grad_enabled(grad):
        got = rf.encode_position(field, cfg, x01)
        t = rf.quantized_tables(field, cfg)
        want = rf.composed_position(cfg, x01, t)
    width = rf.mlp_dims(cfg)[0]
    assert got.shape == (300, width) and got.requires_grad == grad
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert kernels.launches["field_input"] == 0
    # the NaN point (x): NaN sine features, and the yz plane still reads
    n_grid = width - 3 - 6 * cfg.pe_num_freqs
    o3, o2 = cfg.grid_3d.output_dim, cfg.grid_2d.output_dim
    assert bool(got[6, n_grid].isnan()) and bool(got[6, o3 + 2 * o2:n_grid].isfinite().all())


def test_the_planes_read_their_own_two_coordinates():
    """A point outside [0,1] in one axis keeps the plane of the other two."""
    cfg = SMALL
    field = _field(cfg)
    with torch.no_grad():
        row = rf.encode_position(field, cfg, _points(16, 4))
    o3, o2 = cfg.grid_3d.output_dim, cfg.grid_2d.output_dim
    planes = {name: row[:, o3 + i * o2:o3 + (i + 1) * o2] for i, name in
              enumerate(("xy", "xz", "yz"))}
    assert bool((row[3:6, :o3] == 0).all())                   # outside: no 3D feature
    for p, plane in ((3, "yz"), (4, "xz"), (5, "xy")):
        assert bool((planes[plane][p] != 0).any()), plane
        for other in set(planes) - {plane}:
            assert bool((planes[other][p] == 0).all()), (p, other)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("tables_grad", [False, True])
@pytest.mark.parametrize("points_grad", [False, True])
def test_dispatch_predicate(grad, tables_grad, points_grad):
    field = _field(SMALL)
    t = {k: v.detach().requires_grad_(tables_grad) for k, v in field.tables.items()}
    x = _points(8, 5).requires_grad_(points_grad)
    with torch.set_grad_enabled(grad):
        assert not rf.uses_field_input(x, t)          # the CPU: always the composition
        card_x = x.detach().as_subclass(OnTheCard).requires_grad_(points_grad)
        on_card = rf.uses_field_input(card_x, t)
    assert on_card == (not grad or not (tables_grad or points_grad))


def test_a_table_that_requires_grad_keeps_the_composition_under_grad_mode():
    field = _field(SMALL)
    x = _points(8, 6).as_subclass(OnTheCard)
    t = {k: v.detach() for k, v in field.tables.items()}
    t["yz"] = t["yz"].clone().requires_grad_()
    assert not rf.uses_field_input(x, t)
    with torch.no_grad():
        assert rf.uses_field_input(x, t)


@pytest.mark.parametrize("grad", [False, True])
def test_a_card_query_goes_to_the_wrapper_without_a_gradient(monkeypatch, grad):
    """encode_position calls K1f's wrapper once, with the four tables in
    the row's order, for a card tensor under no_grad, and returns what it
    returns; under grad mode with the field's own tables it composes.  (Both
    stand-ins compute on the plain CPU tensor.)"""
    cfg = SMALL
    field = _field(cfg)
    compose = rf.composed_position
    calls = []

    def wrapper(x01, tables, spec3, spec2, num_freqs):
        calls.append(("field_input", tables, spec3, spec2, num_freqs))
        return compose(cfg, x01.as_subclass(torch.Tensor), dict(zip(rf.TABLES, tables))) + 1.0

    def composed(cfg_, x01, tables):
        calls.append(("composed",))
        return compose(cfg_, x01.as_subclass(torch.Tensor), tables)

    monkeypatch.setattr(enc, "field_input", wrapper)
    monkeypatch.setattr(rf, "composed_position", composed)
    x = _points(40, 7)
    with torch.set_grad_enabled(grad):
        t = rf.quantized_tables(field, cfg)
        got = rf.encode_position(field, cfg, x.as_subclass(OnTheCard))
    if grad:
        assert calls == [("composed",)]
        want = compose(cfg, x, t)
    else:
        (name, tables, spec3, spec2, nf), = calls
        assert name == "field_input"
        assert all(torch.equal(a, t[k]) for a, k in zip(tables, rf.TABLES))
        assert (spec3, spec2, nf) == (cfg.grid_3d, cfg.grid_2d, cfg.pe_num_freqs)
        want = compose(cfg, x, t) + 1.0
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want, rtol=0, atol=0,
                               equal_nan=True)


def test_the_wrapper_refuses_cpu_tensors():
    field = _field(SMALL)
    with pytest.raises(ValueError, match="CUDA"):
        enc.field_input(_points(8, 8), [field.tables[k].detach() for k in rf.TABLES],
                        SMALL.grid_3d, SMALL.grid_2d, SMALL.pe_num_freqs)
