"""cnc_torch — the PyTorch and CUDA port of cnc_tpu, for one NVIDIA H100.

It mirrors `cnc_tpu`'s layout and names module for module.  Its entry points
run on `cuda` unless the caller passes `device="cpu"`; without a GPU and
without that request they raise.  Each hand-written CUDA kernel
(`cnc_torch/csrc`) sits beside a plain PyTorch twin: a CPU tensor takes the
twin, a CUDA tensor launches the kernel (see `cnc_torch/kernels.py`).
It imports neither JAX nor anything of `cnc_tpu`.
"""

from . import config

__version__ = "0.1.0"
