"""Build and load K4, the flash-attention CUDA kernel (``csrc/*.cu``), with
the port's shared build module (:mod:`repro_torch.kernels.build`) at first use.
Nothing here runs at import."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..build import BuildInfo, KernelLibrary, load

__all__ = ["CSRC", "LIBRARY", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"

_P, _I = ctypes.c_void_p, ctypes.c_int
# (q, k, v, o, dtype, batch, heads, groups, sq, skv, hd, strides[12],
# causal, q_offset, scale, stream) -> cudaError_t as int
LIBRARY = KernelLibrary("flash_attention", CSRC, (
    ("flash_attention_launch",
     (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
      ctypes.POINTER(ctypes.c_longlong), _I, _I, ctypes.c_float, _P)),
))


def load_library() -> BuildInfo:
    """K4's library, built on the first call in this process and cached
    after it."""
    return load(LIBRARY)[0]
