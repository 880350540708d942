"""Build and load the butterfly CUDA kernels (``csrc/*.cu``) with the
port's shared build module (:mod:`repro_torch.kernels.build`): one ``nvcc`` per
source for ``sm_90a``, all started together, linked into one shared
library with a plain C interface and loaded with ``ctypes`` at first use.
Nothing here runs at import."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..build import BUILD_DIR, NVCC_FLAGS, BuildInfo, KernelLibrary, load

__all__ = ["BuildInfo", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "ENTRY_POINTS",
           "LIBRARY", "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"

# the C entry points: (device stack, partials, n_windows, n_rows, n_cols,
# block_i, stream) -> cudaError_t as int
ENTRY_POINTS = ("butterfly_windows_launch", "butterfly_windows_multiset_launch")
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

LIBRARY = KernelLibrary("butterfly", CSRC,
                        tuple((name, _ARGTYPES) for name in ENTRY_POINTS))


def load_library() -> BuildInfo:
    """The kernel library, built on the first call in this process and
    cached after it."""
    return load(LIBRARY)[0]
