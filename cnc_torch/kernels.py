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
# march.cu must round every float op as the plain twin does (see its header)
SOURCE_FLAGS = {"march.cu": ("-fmad=false",)}

launches = {"grid_encode": 0, "compact": 0, "march": 0, "volrend": 0}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)  # host int arrays
_SIGNATURES = {
    "cnc_cuda_error_string": ((_I,), ctypes.c_char_p),
    "cnc_grid_encode_forward": ((_P, _P, _P, _I, _I, _I, _I, _IP, _IP, _IP, _P), _I),
    "cnc_compact_scratch": ((_LL,), _I),
    "cnc_compact_mask": ((_P, _LL, _I, _P, _P, _P, _P), _I),
    "cnc_march_coarse": ((_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P, _P, _P,
                          _P), _I),
    "cnc_march_fine": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _I, _P, _P), _I),
    "cnc_march_finish": ((_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P),
                         _I),
    "cnc_volrend_forward": ((_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P),
                            _I),
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


def call(name: str, *args) -> None:
    """Call a library function on the current stream; raise on a CUDA error."""
    handle = lib()
    rc = getattr(handle, name)(*args, torch.cuda.current_stream().cuda_stream)
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
