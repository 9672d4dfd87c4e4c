"""The codec's finished pools (`intctx.int_ctx_pool_pq`: K9c in the pool's
own launch on the card) on the CPU.

  * The kernel's finish partition mirrored in numpy (tests/ctx_pool_cases.py
    `finish_partition`): the block whose span holds an entry's last row owns
    it; it finishes it after its own pooling when the entry's first row is
    in its span too, and the last block to finish takes the entry otherwise.
    Over windows of entries with 1 to 5,000 rows, one entry over many
    blocks, blocks whose rows belong to one entry, grids of 1 to 528 blocks
    and the flagship's chunk shapes, every entry of [0, n_e) is finished
    exactly once, and an entry finished inside a block has every row there.
    Each mutation of the rule (an off-by-one at r0, no hand-over to the last
    block, a hand-over at every boundary) breaks it on some case.
  * The finished pools equal the twins: `int_ctx_pool_plain`, then
    `_int_pq_plain`, and cnc_tpu's `device_pq` and sign tables, with every
    entry written through the mirror's partition and `finish_entry` (the
    kernel's int64 arithmetic), on every 3D chunk and 2D level of the tiny
    model, with no row kept and with every row kept; the one copy
    `pull_probs` makes gives the same arrays.
  * The window check: the twin raises, and the mirror of the kernel's row
    check says no, on windows with an empty entry, the wrong first or last
    entry, or entries that decrease; both pass the codec's windows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cnc_tpu.codec import intctx as jint
from cnc_torch.codec import codec as tcodec
from cnc_torch.codec import intctx as tint

import ctx_pool_cases as pc
from test_torch_context_tables import asymmetric_occupancy, make_pair, random_sign_tables

RESIDENT = (1, 2, 264)          # blocks a launch may hold: launch_pool takes twice as many


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes on a few cores: many small
    integer ops spread over every core's thread only contend, so this
    module's ops run on one thread (restored after it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def window_case(name, rng):
    """(counts [n_e] rows per entry) of one named window."""
    if name == "1 to 5,000 rows":
        return rng.integers(1, 5001, 60)
    if name == "one row an entry":            # a dense level's chunk
        return np.ones(3 * pc.TILE + 5, np.int64)
    if name == "one entry over many blocks":
        return np.array([3, 40 * pc.TILE + 11, 2, 1])
    if name == "one entry":
        return np.array([7 * pc.TILE - 1])
    if name == "entries ending at tile edges":
        return np.full(12, pc.TILE)
    if name == "two rows an entry, odd tail":
        return np.full(2 * pc.TILE + 3, 2)
    if name == "3D level-11 chunk":           # the flagship's 1,990,630 rows, 7,721 entries
        c = rng.multinomial(1_990_630 - 7_721, np.full(7_721, 1 / 7_721)) + 1
        return c
    if name == "2D level 3":                  # 1,638,400 rows, 131,072 entries
        return rng.multinomial(1_638_400 - 131_072, np.full(131_072, 1 / 131_072)) + 1
    raise ValueError(name)


WINDOWS = ("1 to 5,000 rows", "one row an entry", "one entry over many blocks", "one entry",
           "entries ending at tile edges", "two rows an entry, odd tail", "3D level-11 chunk",
           "2D level 3")
MUTATIONS = ("r0 off by one", "no hand-over", "hand-over at every boundary")


def _partition_faults(slots, start_e, n_e, spans, mutation=None):
    """What is wrong with the partition: entries finished other than once,
    and inside-finished entries with a row outside their block's span."""
    done = pc.finish_partition(slots, start_e, n_e, spans, mutation)
    times = np.bincount([e for e, _, _ in done], minlength=n_e)
    first = np.searchsorted(slots, np.arange(n_e) + start_e, side="left")
    last = np.searchsorted(slots, np.arange(n_e) + start_e, side="right") - 1
    outside = [e for e, b, phase in done if phase == "inside"
               and not spans[b][0] <= first[e] <= last[e] < spans[b][1]]
    return np.nonzero(times != 1)[0].tolist(), outside


@pytest.mark.parametrize("resident", RESIDENT)
@pytest.mark.parametrize("name", WINDOWS)
def test_every_entry_is_finished_once(name, resident):
    rng = np.random.default_rng(len(name) * 7 + resident)
    counts = window_case(name, rng)
    start_e = 13
    slots = pc.window_slots(counts, start_e)
    spans = pc.block_spans(slots.size, resident)
    assert pc.window_ok(slots, start_e, counts.size)
    wrong, outside = _partition_faults(slots, start_e, counts.size, spans)
    assert wrong == [] and outside == []
    # the last block takes at most one entry a block
    done = pc.finish_partition(slots, start_e, counts.size, spans)
    assert sum(phase == "last" for _, _, phase in done) <= len(spans) - 1


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_a_mutated_partition_fails(mutation):
    """Each mutation leaves some entry unfinished, finished twice, or
    finished inside a block before other blocks' rows are added."""
    broken = []
    for name in WINDOWS[:6]:
        for resident in RESIDENT:
            counts = window_case(name, np.random.default_rng(len(name) * 7 + resident))
            slots = pc.window_slots(counts, 0)
            spans = pc.block_spans(slots.size, resident)
            wrong, outside = _partition_faults(slots, 0, counts.size, spans, mutation)
            broken.append(bool(wrong or outside))
    assert any(broken)


def _finish_by_partition(msum, wsum, slots, start_e, n_e, m_scale, sign=None, evals=None,
                         offset=0, resident=2):
    """The kernel's outputs, entry by entry as its blocks write them; an
    entry no block writes keeps pq 0 (never a probability)."""
    f = msum.shape[1]
    pq = np.zeros((n_e, f), np.uint16)
    cov = np.zeros(n_e, bool)
    bits = np.zeros((n_e, f), np.uint8) if sign is not None else None
    for e, _, _ in pc.finish_partition(slots, start_e, n_e, pc.block_spans(len(slots), resident)):
        rows = None if sign is None else sign[np.clip(offset + evals[e], 0, len(sign) - 1)]
        pq[e], cov[e], b = pc.finish_entry(msum[e], wsum[e], m_scale, rows)
        if bits is not None:
            bits[e] = b
    return pq, cov, bits


def _model(**overrides):
    _, tctx = make_pair(max_points_per_chunk=1 << 13, **overrides)
    b = asymmetric_occupancy(seed=4)
    tc = tcodec.CNCCodec(tctx)
    tabs = {k: v.astype(np.int32) for k, v in random_sign_tables(tctx, seed=6).items()}
    params = tctx.init_params(torch.Generator().manual_seed(3))
    return dict(tctx=tctx, tc=tc, ip=tc._int_params(params),
                cache=tctx.refresh_cache_int(torch.from_numpy(b)), tabs=tabs)


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def model_no_plane():
    """Without the dimension-wise prior: the 2D Linear takes no plane."""
    return _model(use_dimension_wise=False)


def _check_finished(got, msum, wsum, slots, start_e, n_e, m_scale, sign, evals, offset):
    """got (a PoolProbs) against the twins, cnc_tpu and the partition mirror."""
    pq, cov, bits = got
    want_pq, want_cov, want_bits = tint._int_pq_plain(
        msum, wsum, m_scale, sign if evals is not None else None, offset, evals)
    assert torch.equal(pq, want_pq) and torch.equal(cov, want_cov)
    assert (bits is None) == (evals is None)
    if bits is not None:
        assert torch.equal(bits, want_bits)
    np.testing.assert_array_equal(
        pq.numpy(), np.asarray(jint.device_pq(jnp.asarray(msum.numpy()),
                                              jnp.asarray(wsum.numpy()), m_scale)))
    mirror = _finish_by_partition(msum.numpy(), wsum.numpy(), slots.numpy().astype(np.int64),
                                  start_e, n_e, m_scale,
                                  None if evals is None else sign.numpy(),
                                  None if evals is None else evals.numpy(), offset)
    pulled = tint.pull_probs(got)
    for a, b in zip(pulled, mirror):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert (mirror[0] > 0).all()


@pytest.mark.parametrize("keep", ["occupied", "none", "all"])
def test_finished_3d_pools_equal_the_twins(model, keep):
    tctx, tc, ip = model["tctx"], model["tc"], model["ip"]
    cache = dict(model["cache"])
    if keep != "occupied":
        cache["mask3d"] = torch.full_like(cache["mask3d"], keep == "all")
    sign3 = torch.from_numpy(model["tabs"]["xyz"])
    seen = 0
    for l in tctx.ctx_levels_3d:
        chunk_e, _, w = tc.chunks3d[l]
        for _, _, start in tc._chunk_bounds(l):
            with_bits = seen % 2 == 0
            got = tctx.pool_3d_probs_int(ip, sign3, cache, l, 131, start, chunk_e, w,
                                         tc.m_shift3[l], tc.m_scale3[l], with_bits)
            msum, wsum, evals = tctx.pool_3d_sums_int(ip, sign3, cache, l, 131, start, chunk_e,
                                                      w, tc.m_shift3[l])
            _, slots, _ = tctx._entry_rows("3d", l, start, chunk_e, w, "pos_flat")
            _check_finished(got, msum, wsum, slots, start, chunk_e, tc.m_scale3[l], sign3,
                            evals if with_bits else None, tctx.tables3d[l].offset)
            assert bool(got[1].any()) == (keep != "none")
            seen += 1
    assert seen > len(tctx.ctx_levels_3d)          # some level runs in chunks


@pytest.mark.parametrize("which", ["model", "model_no_plane"])
def test_finished_2d_pools_equal_the_twins(request, which):
    model = request.getfixturevalue(which)
    tctx, tc, ip, cache = model["tctx"], model["tc"], model["ip"], model["cache"]
    plane = tctx.cfg.use_dimension_wise
    sign3 = torch.from_numpy(model["tabs"]["xyz"])
    for ai, ax in enumerate(("xy", "xz", "yz")):
        sign2 = torch.from_numpy(model["tabs"][ax])
        plane_q = tctx.frac_plane_int(sign3, cache["pn"][ax]) if plane else None
        for l in tctx.ctx_levels_2d:
            t = tctx.tables2d[l]
            args = (ip, sign2, l, 97, plane_q, cache["mask2d"][ai], 0, t.n_entries, t.n_points,
                    tc.m_shift2[l])
            got = tctx.pool_2d_probs_int(*args, tc.m_scale2[l], with_bits=ai != 1)
            msum, cnt, evals = tctx.pool_2d_sums_int(*args)
            _, slots, _ = tctx._entry_rows("2d", l, 0, t.n_entries, t.n_points, "coords")
            _check_finished(got, msum, cnt, slots, 0, t.n_entries, tc.m_scale2[l], sign2,
                            evals if ai != 1 else None, t.offset)


def test_codec_windows_pass_the_window_check(model):
    tctx, tc = model["tctx"], model["tc"]
    for l in tctx.ctx_levels_3d:
        chunk_e, _, w = tc.chunks3d[l]
        for _, _, start in tc._chunk_bounds(l):
            _, slots, _ = tctx._entry_rows("3d", l, start, chunk_e, w, "pos_flat")
            assert pc.window_ok(slots.numpy(), start, chunk_e)
    for l in tctx.ctx_levels_2d:
        t = tctx.tables2d[l]
        _, slots, _ = tctx._entry_rows("2d", l, 0, t.n_entries, t.n_points, "coords")
        assert pc.window_ok(slots.numpy(), 0, t.n_entries)


@pytest.mark.parametrize("broken", ["an empty entry", "first entry", "last entry", "decrease",
                                    "fewer rows than entries"])
def test_broken_windows_are_refused(model, broken):
    """The twin raises where the kernel's row check sets the fault word."""
    tctx, tc, ip, cache = model["tctx"], model["tc"], model["ip"], model["cache"]
    l = tctx.ctx_levels_3d[-1]
    chunk_e, _, w = tc.chunks3d[l]
    start = tc._chunk_bounds(l)[0][2]
    (args, evals) = tctx._pool_3d_args(ip, torch.from_numpy(model["tabs"]["xyz"]), cache, l, 0,
                                       start, chunk_e, w, 0)
    args = list(args)
    slots = args[3].clone()
    n_e = chunk_e
    if broken == "an empty entry":
        slots[slots == start + 3] = start + 4
    elif broken == "first entry":
        slots[0] = start + 1
    elif broken == "last entry":
        n_e = chunk_e + 1
    elif broken == "decrease":
        slots[-2] = start + chunk_e - 2 if slots[-3] == start + chunk_e - 1 else slots[-2] - 1
    else:
        args[2], slots = args[2][:chunk_e - 1], slots[:chunk_e - 1]
    args[3], args[5] = slots, n_e
    assert not pc.window_ok(slots.numpy(), start, n_e)
    with pytest.raises(ValueError, match="exactly those of entries"):
        tint.int_ctx_pool_pq(*args[:13], tc.m_scale3[l], *args[13:])


def test_finish_quotient_is_the_floor():
    """The kernel's double-precision quotient with one correction step
    equals the exact floor over the whole operand range: sums up to 2^31 - 1,
    denominators from 1 to 2^42, quotients just below, at and above whole
    numbers."""
    rng = np.random.default_rng(11)
    m = rng.integers(1, 2 ** 31, 200_000, dtype=np.int64)
    den = np.exp2(rng.uniform(0, 42, 200_000)).astype(np.int64) + 1
    k = rng.integers(1, 2 ** 16, 50_000, dtype=np.int64)
    d2 = rng.integers(1, 2 ** 15, 50_000, dtype=np.int64)
    # m * 65536 = k * den + {-1, 0, 1}: quotients at and beside whole numbers
    edge_den = d2 * 65536
    edge_m = k * d2
    m = np.concatenate([m, edge_m, edge_m + 1, np.maximum(edge_m - 1, 1), [2 ** 31 - 1] * 3])
    den = np.concatenate([den, edge_den, edge_den, edge_den, [1, 3, 2 ** 42 - 1]])
    np.testing.assert_array_equal(pc.finish_quotient(m, den), (m * 65536) // den)


def test_window_check_mirror_on_numbers():
    ok = pc.window_slots(np.array([2, 1, 3]), 5)
    assert pc.window_ok(ok, 5, 3)
    assert not pc.window_ok(ok, 4, 3) and not pc.window_ok(ok, 5, 4)
    assert not pc.window_ok(np.array([5, 5, 7, 7]), 5, 3)
    assert not pc.window_ok(np.array([5, 6, 5, 7]), 5, 3)
    assert pc.window_ok(np.zeros(0, np.int64), 5, 0)


def test_int_pq_refuses_cuda_tensors(monkeypatch):
    """K9c has no launch of its own: int_pq is a twin and refuses the card."""
    t = torch.zeros(3, 2, dtype=torch.int32)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="int_ctx_pool_pq"):
        tint.int_pq(t, t[:, 0], 2048)
