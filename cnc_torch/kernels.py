"""Build, load and count the port's CUDA kernels.

The sources in `cnc_torch/csrc/*.cu` have a plain C interface.  On first use
each is compiled by its own `nvcc` process (all started together) for
`sm_90a`, and the objects are linked into one shared library that is loaded
with ctypes.  The build lands in `cnc_torch/_build/` under a name derived from
the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Nothing here runs at import time: `import cnc_torch` works on
a machine without nvcc or a GPU, where only the plain twins run.

`launches` counts, per kernel, the launches made by the wrappers (each
wrapper adds one where it calls into the library, and nowhere else), so a run
can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMMON_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
# march.cu and grid_encode.cu must round every float op as their plain twins
# do (see their headers)
SOURCE_FLAGS = {"march.cu": ("-fmad=false",), "grid_encode.cu": ("-fmad=false",)}

# grid_encode_v / grid_encode_v_bwd: launches of the encode kernels in their
# masked or mixed-level variants (the rate estimate's), counted apart from the
# plain ones; grid_encode_s / grid_encode_s_bwd: K1s/K2s, the encode kernels
# masked by a summed-area table (`occ_binary` / `occ_sat`); vertex_tables: every launch of csrc/vertex_tables.cu (four a
# hashed level: count, scan, place, order; one a dense level); the codec's
# integer kernels: int_ctx_pool (one launch a pool, csrc/int_context.cu), int_pq
# (those of its launches that also finish the coder's probabilities, K9c, as
# their epilogue: K9c has no launch of its own) and pn_hist_int (the integer
# mode of csrc/pn_hist.cu, one launch a codec plane), counted apart from
# pn_frac_plane (one launch a frac plane) and pn_hist_bwd (its backward: one
# launch a backward, after the fill of d_table); pn_hist_part /
# pn_hist_part_bwd: K7p and K7pb, a data-parallel rank's share of a frac
# plane over a range of rows and its backward (one launch each a plane, only
# with a group of more than one rank);
# pack_mask_bits: the packing of the encode's occupancy masks (once per cache
# refresh, csrc/grid_encode.cu); segment_pool / segment_pool_bwd: the backward
# and the forward of segment_gather; segment_mean / segment_mean_bwd: one call
# site's pooled mean (both csrc/segment_pool.cu); volrend / volrend_bwd: two
# per composite, forward or backward (the walk table, then the scan;
# csrc/volrend.cu)
launches = {"grid_encode": 0, "grid_encode_bwd": 0, "compact": 0, "march": 0, "volrend": 0,
            "volrend_bwd": 0, "scatter_add": 0, "lane_gather": 0, "grid_encode_v": 0,
            "grid_encode_v_bwd": 0, "grid_encode_s": 0, "grid_encode_s_bwd": 0, "segment_pool": 0, "segment_pool_bwd": 0,
            "pn_frac_plane": 0, "pn_hist_bwd": 0, "pn_hist_part": 0, "pn_hist_part_bwd": 0,
            "footprint": 0, "vertex_tables": 0,
            "int_ctx_pool": 0, "int_pq": 0, "pn_hist_int": 0,
            "pack_mask_bits": 0, "segment_mean": 0, "segment_mean_bwd": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)  # host int arrays
_LP = ctypes.POINTER(ctypes.c_longlong)
_ENCODE = (_P, _P, _P, _I, _I, _I, _I, _I, _IP, _IP, _IP, _P, _LP, _P, _P, _I, _P)
_SIGNATURES = {
    "cnc_cuda_error_string": ((_I,), ctypes.c_char_p),
    "cnc_grid_encode_forward": (_ENCODE, _I),
    "cnc_grid_encode_backward": (_ENCODE, _I),
    "cnc_pack_mask_bits": ((_P, _LL, _LL, _P, _P), _I),
    "cnc_compact_scratch": ((), _LL),
    "cnc_compact_mask": ((_P, _LL, _I, _P, _P, _P, _P, _P), _I),
    "cnc_march_ints": ((_I,), _LL),
    "cnc_march": ((_P,) * 7 + (_I, _P) + (_I,) * 7 + (_F,) * 5 + (_P,) * 12, _I),
    "cnc_volrend_forward": ((_P,) * 6 + (_I, _I, _F, _F, _F) + (_P,) * 7, _I),
    "cnc_volrend_backward": ((_P,) * 9 + (_I, _I, _F, _F, _F) + (_P,) * 5, _I),
    "cnc_scatter_add": ((_P, _P, _P, _LL, _I, _I, _P), _I),
    "cnc_lane_gather": ((_P, _P, _P, _I, _I, _LL, _P), _I),
    "cnc_segment_pool": ((_P, _P, _P, _P, _LL, _I, _P), _I),
    "cnc_segment_pool_backward": ((_P, _P, _P, _P, _LL, _I, _P), _I),
    "cnc_segment_mean_scratch": ((_LL, _I), _LL),
    "cnc_segment_mean": ((_P, _P, _P, _P, _LL, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P), _I),
    "cnc_segment_mean_backward": ((_P, _P, _P, _P, _P, _LL, _I, _I, _F, _I, _P, _P), _I),
    "cnc_pn_frac_plane": ((_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _P, _P), _I),
    "cnc_pn_hist_backward": ((_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P), _I),
    "cnc_pn_hist_part": ((_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P), _I),
    "cnc_pn_hist_part_backward": ((_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                                   _P), _I),
    "cnc_footprint": ((_P, _I, _I, _I, _P, _I, _P, _P, _P), _I),
    "cnc_vertex_scratch_words": ((_LL,), _LL),
    "cnc_vertex_segment_cap": ((), _I),
    "cnc_vertex_tables": ((_LL, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P), _I),
    "cnc_vertex_long_segments": ((_LL, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P, _I, _I, _P, _P,
                                  _P, _P), _I),
    "cnc_dense_level": ((_P, _I, _I, _P, _P, _P, _P, _P), _I),
    "cnc_int_ctx_pool_scratch": ((), _LL),
    "cnc_int_ctx_pool": ((_P, _P, _LL, _I, _I, _I, _I, _P, _LL, _LL, _P, _LL, _I, _I, _IP, _LP,
                          _LP, _LP, _P, _I, _LL, _P, _P, _LL, _I, _I, _P, _LL, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _LL, _I, _P), _I),
    "cnc_pn_hist_int": ((_P, _LL, _LL, _P, _P, _P, _I, _I, _I, _P, _P), _I),
}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(repr((ARCH_FLAGS, COMMON_FLAGS, sorted(SOURCE_FLAGS.items()))).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link them; returns the library path."""
    out = BUILD_DIR / f"libcnc_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *COMMON_FLAGS, *SOURCE_FLAGS.get(src.name, ()),
                   "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                               *(str(o) for _, o, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
        os.replace(tmp_so, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def call(name: str, *args, stream: int | None = None) -> None:
    """Call a library function on `stream` (a raw CUDA stream handle; the
    current stream when None); raise on a CUDA error."""
    handle = lib()
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(handle, name)(*args, stream)
    if rc != 0:
        msg = handle.cnc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor | None):
    """Device pointer of a contiguous tensor (None -> null)."""
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check what a kernel takes: CUDA, contiguous, on one device."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous CUDA tensors")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        dev = t.device
