"""Build and load K4, the flash-attention CUDA kernels (``csrc/*.cu``: the
bf16 wgmma variant and the float32 SIMT variant in one library), with
the port's shared build module (:mod:`repro_torch.kernels.build`) at first use.
Nothing here runs at import."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..build import BuildInfo, KernelLibrary, load

__all__ = ["CSRC", "LIBRARY", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"

_P, _I = ctypes.c_void_p, ctypes.c_int
# flash_attention_launch (q, k, v, o, dtype, batch, heads, groups, sq, skv,
# hd, hd_v, strides[12], causal, q_offset, scale, stream) -> cudaError_t as
# int; flash_attention_smem_bytes (dtype, hd, hd_v) -> the variant's dynamic
# shared memory in bytes
LIBRARY = KernelLibrary("flash_attention", CSRC, (
    ("flash_attention_launch",
     (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
      ctypes.POINTER(ctypes.c_longlong), _I, _I, ctypes.c_float, _P)),
    ("flash_attention_smem_bytes", (_I, _I, _I)),
))


def load_library() -> BuildInfo:
    """K4's library, built on the first call in this process and cached
    after it."""
    return load(LIBRARY)[0]
