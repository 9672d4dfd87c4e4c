"""The table build's counting sort by entry (K10, csrc/vertex_tables.cu)
mirrored in numpy (tests/vertex_sort_cases.py) on the CPU.

The mirror takes the kernel's own steps: the keys by its multiply-and-shift
divisions and the uint32 hash, count, the tiled scan with its status words,
place in the order the atomics might claim the slots (ascending ids, blocks
racing each other, any order at all), the order pass's odd-even rounds and
bitonic sort per segment, and, above the cap, the tile sorts and merge
passes.  Its tables must be bit-equal to the plain twin
(`context_ops._level_tables_plain`: the keys, a stable torch.sort, the fill)
on random keys with empty keys, one key holding every vertex (above the
cap), segments on both sides of the cap, 2D levels with the entry
permutation and its inverse, and every hashed level of the small model as
tests/test_torch_context_tables.py builds it; and, concatenated over the
small model's plans, to cnc_tpu's `table_arrays`.  The divisions, the status
words' packing and the bitonic fallback are checked on their own, and the
order pass without its bitonic fallback fails on shuffled claims.
"""

import numpy as np
import pytest
import torch

from cnc_torch.ops import context_ops as cops
from cnc_torch.utils import threefry

import vertex_sort_cases as vc
from test_torch_context_tables import make_pair

CLAIMS = ("ascending", "racing blocks", "shuffled")


def _twin(v, d, r, size, e_max, tile=0, rb=0, perm=None, inv=None):
    on = lambda a: None if a is None else torch.from_numpy(a.astype(np.int32))
    return cops.level_tables(v, d, r, size, e_max, "cpu", tile, rb, on(perm), on(inv))


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            np.testing.assert_array_equal(np.asarray(got[k]), w.numpy().astype(np.int64),
                                          err_msg=k)
        else:
            assert int(got[k]) == int(w), k


@pytest.mark.parametrize("d", [2, 3])
def test_fast_division_is_exact(d):
    """common.cuh's fastdiv at every divisor the build uses and the edges of
    its range (0 <= n < 2^31)."""
    rng = np.random.default_rng(d)
    divisors = ([1, 2, 3, 7, 10, 18, 34, 66, 108, 130, 514, 514 * 514, 2 ** 16 + 1, 2 ** 20 - 1]
                if d == 3 else [1, 16, 128, 2, 4, 6, 18, 34, 36, 18 * 18, 34 * 34, 130, 514])
    for dv in divisors:
        n = np.concatenate([np.arange(0, 3 * dv + 3), [2 ** 31 - 1, 2 ** 31 - 2, 2 ** 30],
                            rng.integers(0, 2 ** 31, 2000), dv * rng.integers(0, 2 ** 31 // dv,
                                                                               500) - 1])
        n = n[(n >= 0) & (n < 2 ** 31)]
        np.testing.assert_array_equal(vc.fastdiv(n, vc.make_fastdiv(dv)), n // dv, err_msg=dv)


@pytest.mark.parametrize("level", [(3, 34, 1024), (3, 66, 1024), (3, 108, 1 << 19),
                                   (3, 514, 1 << 19), (2, 34, 256), (2, 130, 1 << 17)])
def test_keys_by_the_kernels_arithmetic(level):
    """vertex_key's index arithmetic against the twin's keys; at the
    flagship's 514^3 and 2D lattices on a stride of their ids."""
    d, r, size = level
    if d == 3:
        v, tile, rb = r ** 3, 0, 0
    else:
        rb = 16
        tile = (r - 2) // rb
        v = rb * rb * (tile + 2) ** 2
    perm = vc.perm_inv(size, 7)[0] if d == 2 else None
    if v > 1 << 22:                  # the flagship's finest level: every 97th id
        ids = torch.arange(0, v, 97, dtype=torch.int64)
        coords = torch.stack([ids // (r * r), (ids // r) % r, ids % r], -1)
        from cnc_torch.ops import hash_ops
        want = hash_ops.grid_index(coords, r, size).numpy()
        got = vc.vertex_keys(v, d, r, size, ids=ids.numpy())
    else:
        want = cops._vertex_keys_plain(v, d, r, size, tile, rb,
                                       None if perm is None else torch.from_numpy(perm),
                                       torch.device("cpu")).numpy()
        got = vc.vertex_keys(v, d, r, size, tile, rb, perm)
    np.testing.assert_array_equal(got, want)


def test_status_words_pack_at_their_limits():
    for flag, total, ords in ((1, 0, 0), (2, 2 ** 31 - 1, 2 ** 30 - 1), (1, 135_796_744, 524_288),
                              (2, 1, 2 ** 29)):
        w = vc.pack_status(flag, total, ords)
        assert w < 2 ** 64 and vc.unpack_status(w) == (flag, total, ords)


@pytest.mark.parametrize("claims", CLAIMS)
@pytest.mark.parametrize("name", vc.TABLE_CASES)
def test_count_sort_equals_the_twin(name, claims):
    v, d, r, size, e_max, tile, rb, perm, inv = vc.table_case(name)
    got, paths = vc.level_tables(v, d, r, size, e_max, tile, rb, perm, inv, claims,
                                 seed=len(name))
    _assert_equal(got, _twin(v, d, r, size, e_max, tile, rb, perm, inv))
    if name in ("segments across the cap", "one key holds every vertex"):
        assert paths["long"] > 0 and got["longest"] > vc.CAP
    else:
        assert paths["long"] == 0
    if name == "3D with empty keys":
        assert got["n_entries"] < e_max


def test_small_model_tables_equal_cnc_tpu():
    """Every plan of the small model: the hashed levels through the mirror
    (blocks racing), the dense ones through the twin, concatenated in plan
    order as the build does, equal cnc_tpu's tables."""
    jctx, tctx = make_pair()
    out = {"3d": {}, "2d": {}}
    n_entries = []
    for p in tctx._level_plans():
        if p["dense"]:
            perm = torch.from_numpy(threefry.permutation(1234 + p["level"], p["v"])
                                    .astype(np.int32))
            part = {k: t.numpy() for k, t in cops._dense_level_plain(perm, p["r"]).items()}
            n_entries.append(p["v"])
        else:
            d, tile = (3, 0) if p["kind"] == "3d" else (2, p["tile"])
            perm = inv = None
            if d == 2:
                perm, inv = vc.perm_inv(p["tbl"], 4321 + p["level"])
            part, _ = vc.level_tables(p["v"], d, p["r"], p["tbl"], p["e_max"], tile, tctx.rb,
                                      perm, inv, "racing blocks", seed=p["level"])
            n_entries.append(part["n_entries"])
        for k, a in part.items():
            if k not in ("n_entries", "longest"):
                out[p["kind"]].setdefault(k, []).append(np.asarray(a))
    for kind in ("3d", "2d"):
        want = jctx.table_arrays[kind]
        assert set(want) == set(out[kind])
        for k in want:
            np.testing.assert_array_equal(np.concatenate(out[kind][k]), np.asarray(want[k]),
                                          err_msg=f"{kind} {k}")
    assert [int(t.n_entries) for t in list(jctx.tables3d.values()) +
            list(jctx.tables2d.values())] == [int(n) for n in n_entries]


@pytest.mark.parametrize("n", [1, 2, 31, 33, 259, 1000, 1024])
def test_warp_sort_sorts_any_order(n):
    """The odd-even rounds alone on nearly sorted input, the bitonic network
    on any: both end sorted."""
    rng = np.random.default_rng(n)
    a = np.sort(rng.choice(1 << 30, n, replace=False))
    near = a.copy()
    for i in rng.integers(0, max(n - 1, 1), n // 8):
        near[i:i + 2] = near[i:i + 2][::-1]
    for x in (a, near, rng.permutation(a), a[::-1]):
        np.testing.assert_array_equal(vc.warp_sort(x), a)


def test_without_the_bitonic_fallback_shuffled_claims_fail():
    v, d, r, size, e_max, tile, rb, perm, inv = vc.table_case("small 3D hashed")
    got, _ = vc.level_tables(v, d, r, size, e_max, tile, rb, perm, inv, "shuffled", seed=1,
                             bitonic=False)
    want = _twin(v, d, r, size, e_max)
    assert not np.array_equal(got["pos_flat"], want["pos_flat"].numpy())
