"""Host-side binary range coder (torchac replacement).

Port of `cnc_tpu/codec/coder.py`.  The C++ coder (`cnc_torch/native/
range_coder.cpp`, the port's own copy of cnc_tpu's) is built with g++ on
first use into `cnc_torch/_build/` and loaded through ctypes.  Unlike
cnc_tpu, a failed build raises: at full width some twenty million symbols go
through the coder, and a silent fall back to the pure-Python mirror would
hide a broken build behind a run of many minutes.  The mirror (`_py_encode`,
`_py_decode`) is bit-exact with the native coder; it runs only when a caller
passes `force_python=True`, and serves as the plain twin in the tests.
Probabilities are quantized once in numpy (`quantize_probs`) and must be
byte-identical between encode and decode.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "range_coder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_TOP = 1 << 24


def build() -> Path:
    """Compile the coder (once per source and flags); returns the library path."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(repr(CXX_FLAGS).encode())
    out = BUILD_DIR / f"librange_coder_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_so = Path(tmp) / out.name
        res = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp_so)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("g++ failed to build the range coder:\n" + res.stdout + res.stderr)
        os.replace(tmp_so, out)
    return out


def get_lib(force_python: bool = False) -> Optional[ctypes.CDLL]:
    """The native coder, built and loaded on first call; None only when
    `force_python` asks for the Python mirror."""
    global _LIB
    if force_python:
        return None
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.rc_encode_bits.restype = ctypes.c_int64
            lib.rc_encode_bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_void_p, ctypes.c_int64]
            lib.rc_decode_bits.restype = ctypes.c_int64
            lib.rc_decode_bits.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                           ctypes.c_int64, ctypes.c_void_p]
            _LIB = lib
    return _LIB


def quantize_probs(p: np.ndarray) -> np.ndarray:
    """float P(+1) -> uint16 in [1, 65535]; shared by both codec sides."""
    p = np.asarray(p, np.float64)
    q = np.rint(p * 65536.0)
    return np.clip(q, 1, 65535).astype(np.uint16)


def encode_bits(bits: np.ndarray, probs_q: np.ndarray, force_python: bool = False) -> bytes:
    """Encode bits (0/1) with quantized P(1)=probs_q/65536."""
    bits = np.ascontiguousarray(np.asarray(bits, np.uint8))
    probs_q = np.ascontiguousarray(probs_q, dtype=np.uint16)
    n = bits.size
    if probs_q.size != n:
        raise ValueError(f"{n} bits but {probs_q.size} probabilities")
    lib = get_lib(force_python)
    if lib is None:
        return _py_encode(bits, probs_q)
    cap = 2 * n + 64
    out = np.empty(cap, np.uint8)
    written = lib.rc_encode_bits(bits.ctypes.data, probs_q.ctypes.data, n, out.ctypes.data, cap)
    if written < 0:
        raise RuntimeError("range coder output overflow")
    return out[:written].tobytes()


def decode_bits(stream: bytes, probs_q: np.ndarray, force_python: bool = False) -> np.ndarray:
    probs_q = np.ascontiguousarray(probs_q, dtype=np.uint16)
    n = probs_q.size
    lib = get_lib(force_python)
    if lib is None:
        return _py_decode(stream, probs_q)
    buf = np.frombuffer(stream, np.uint8)
    out = np.empty(n, np.uint8)
    lib.rc_decode_bits(buf.ctypes.data, buf.size, probs_q.ctypes.data, n, out.ctypes.data)
    return out


# ---------------------------------------------------------------- python mirror
def _py_encode(bits: np.ndarray, probs_q: np.ndarray) -> bytes:
    out = bytearray()
    low = 0
    rng = 0xFFFFFFFF
    cache = 0
    cache_size = 1

    def shift_low():
        nonlocal low, cache, cache_size
        if (low >> 32) != 0 or (low & 0xFFFFFFFF) < 0xFF000000:
            carry = low >> 32
            while cache_size:
                out.append((cache + carry) & 0xFF)
                cache = 0xFF
                cache_size -= 1
            cache = (low >> 24) & 0xFF
            cache_size = 0
        cache_size += 1
        low = (low << 8) & 0xFFFFFFFF

    for b, pq in zip(bits, probs_q):
        r1 = (rng * int(pq)) >> 16
        r1 = min(max(r1, 1), rng - 1)
        if b:
            rng = r1
        else:
            low += r1
            rng -= r1
        while rng < _TOP:
            shift_low()
            rng = (rng << 8) & 0xFFFFFFFF
    for _ in range(5):
        shift_low()
    return bytes(out)


def _py_decode(stream: bytes, probs_q: np.ndarray) -> np.ndarray:
    data = stream + b"\x00" * 8
    code = int.from_bytes(data[1:5], "big")   # byte 0 is the encoder's initial cache byte
    pos = 5
    rng = 0xFFFFFFFF
    n = probs_q.size
    bits = np.empty(n, np.uint8)
    for i in range(n):
        r1 = (rng * int(probs_q[i])) >> 16
        r1 = min(max(r1, 1), rng - 1)
        if code < r1:
            bits[i] = 1
            rng = r1
        else:
            bits[i] = 0
            code -= r1
            rng -= r1
        while rng < _TOP:
            code = ((code << 8) | data[pos]) & 0xFFFFFFFF
            pos += 1
            rng = (rng << 8) & 0xFFFFFFFF
    return bits


def encode_pm1(values: np.ndarray, p: np.ndarray, **kw) -> bytes:
    """Encode +-1 symbols with P(+1)=p (the CNC convention,
    utils_bpp_acc.py:86: sym=(x+1)/2)."""
    bits = (np.asarray(values).reshape(-1) > 0).astype(np.uint8)
    return encode_bits(bits, quantize_probs(np.asarray(p).reshape(-1)), **kw)


def decode_pm1(stream: bytes, p: np.ndarray, **kw) -> np.ndarray:
    bits = decode_bits(stream, quantize_probs(np.asarray(p).reshape(-1)), **kw)
    return bits.astype(np.float32) * 2.0 - 1.0
