"""cnc_torch's range coder against cnc_tpu's: the port's native coder (its own
copy of the C++ source, built into cnc_torch/_build/) and its Python mirror
write byte-identical streams to cnc_tpu's for the same bits and
probabilities, probabilities at 1 and 65535 included, and every stream
decodes back to its bits in both packages."""

import numpy as np
import pytest

from cnc_tpu.codec import coder as jcoder
from cnc_torch.codec import coder as tcoder


def _case(seed, n, kind):
    rng = np.random.default_rng(seed)
    bits = (rng.random(n) < 0.3).astype(np.uint8)
    if kind == "random":
        pq = rng.integers(1, 65536, n).astype(np.uint16)
    elif kind == "extremes":
        pq = np.where(rng.random(n) < 0.5, 1, 65535).astype(np.uint16)
    elif kind == "wrong_way":            # every symbol against its probability
        pq = np.where(bits > 0, 1, 65535).astype(np.uint16)
    else:                                # skewed, as trained contexts are
        pq = np.clip(rng.normal(60000, 4000, n), 1, 65535).astype(np.uint16)
        bits = (rng.random(n) < pq / 65536.0).astype(np.uint8)
    return bits, pq


CASES = [("random", 5000), ("extremes", 3000), ("wrong_way", 2000), ("skewed", 20000),
         ("random", 1), ("random", 0)]


def test_the_sources_are_the_same_coder():
    """The port's copy differs from cnc_tpu's only in its header comment."""
    strip = lambda path: [l for l in open(path).read().splitlines()
                          if l.strip() and not l.lstrip().startswith("//")]
    assert strip(tcoder.SOURCE) == strip(jcoder._NATIVE_DIR / "range_coder.cpp")


@pytest.mark.parametrize("kind,n", CASES)
def test_native_streams_equal_cnc_tpu(kind, n):
    bits, pq = _case(len(kind) + n, n, kind)
    want = jcoder.encode_bits(bits, pq, force_python=True)
    got = tcoder.encode_bits(bits, pq)
    assert got == want
    assert got == jcoder.encode_bits(bits, pq)              # cnc_tpu's native coder
    np.testing.assert_array_equal(tcoder.decode_bits(got, pq), bits)
    np.testing.assert_array_equal(jcoder.decode_bits(got, pq, force_python=True), bits)


@pytest.mark.parametrize("kind,n", CASES[:4])
def test_python_mirror_equals_native(kind, n):
    bits, pq = _case(100 + n, n, kind)
    stream = tcoder.encode_bits(bits, pq, force_python=True)
    assert stream == tcoder.encode_bits(bits, pq)
    np.testing.assert_array_equal(tcoder.decode_bits(stream, pq, force_python=True), bits)
    np.testing.assert_array_equal(tcoder.decode_bits(stream, pq), bits)


def test_quantize_probs_and_pm1_equal_cnc_tpu():
    rng = np.random.default_rng(3)
    p = np.concatenate([rng.random(4000), [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5, 1.5 / 65536]])
    np.testing.assert_array_equal(tcoder.quantize_probs(p), jcoder.quantize_probs(p))
    vals = np.where(rng.random(p.size) < p, 1.0, -1.0).astype(np.float32)
    stream = tcoder.encode_pm1(vals, p)
    assert stream == jcoder.encode_pm1(vals, p, force_python=True)
    np.testing.assert_array_equal(tcoder.decode_pm1(stream, p), vals)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No silent fall back to the mirror: a coder that does not build raises."""
    bad = tmp_path / "range_coder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tcoder, "SOURCE", bad)
    monkeypatch.setattr(tcoder, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(tcoder, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tcoder.encode_bits(np.ones(4, np.uint8), np.full(4, 30000, np.uint16))
    assert tcoder.encode_bits(np.ones(4, np.uint8), np.full(4, 30000, np.uint16),
                              force_python=True) == jcoder.encode_bits(
        np.ones(4, np.uint8), np.full(4, 30000, np.uint16), force_python=True)


def test_mismatched_lengths_are_refused():
    with pytest.raises(ValueError, match="probabilities"):
        tcoder.encode_bits(np.ones(5, np.uint8), np.full(4, 30000, np.uint16))
