"""Build and load the butterfly CUDA kernels (``csrc/*.cu``) with the
port's shared build module (:mod:`repro_torch.kernels.build`): one ``nvcc`` per
source for ``sm_90a``, all started together, linked into one shared
library with a plain C interface and loaded with ``ctypes`` at first use.
Nothing here runs at import."""
from __future__ import annotations

import ctypes
from pathlib import Path

from ..build import BUILD_DIR, NVCC_FLAGS, BuildInfo, KernelLibrary, load

__all__ = ["BuildInfo", "CSRC", "BUILD_DIR", "NVCC_FLAGS", "LIBRARY",
           "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"

_P, _I = ctypes.c_void_p, ctypes.c_int
# butterfly_windows_wgmma_launch (K1 and K3: uint8 stack, uint64 scratch,
# partials, n_windows, n_rows, row_bytes, block_i, stream) and
# butterfly_windows_multiset_wgmma_launch (K2: uint8 limb planes, int32
# per-window limb counts, 64-bit scratch, partials, n_windows, lw, ls,
# n_rows, row_bytes, block_i, stream) -> cudaError_t as int; the two
# *_smem_bytes () -> each Gram kernel's dynamic shared memory
LIBRARY = KernelLibrary("butterfly", CSRC, (
    ("butterfly_windows_wgmma_launch", (_P, _P, _P, _I, _I, _I, _I, _P)),
    ("butterfly_windows_wgmma_smem_bytes", ()),
    ("butterfly_windows_multiset_wgmma_launch",
     (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)),
    ("butterfly_windows_multiset_wgmma_smem_bytes", ()),
))


def load_library() -> BuildInfo:
    """The kernel library, built on the first call in this process and
    cached after it."""
    return load(LIBRARY)[0]
