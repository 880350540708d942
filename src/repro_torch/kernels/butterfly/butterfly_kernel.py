"""K1: the window-batched Gram-triangle butterfly kernel, and its plain twin.

:func:`butterfly_pairs_windows_kernel_call` is the wrapper the program calls.
For a ``[B, n, k]`` float32 stack of 0/1 biadjacencies (rows = the Gram
side) and a square tiling of each Gram matrix ``W = A A^T`` into
``block_i x block_i`` tiles, it returns the ``[B, T]`` per-tile-pair
partials ``sum_{r<c} w(w-1)/2`` over the upper-triangle tile pairs
``u <= v`` (row-major, ``T = nu (nu + 1) / 2``, ``nu = ceil(n / block_i)``)
-- what the reference's Pallas kernel (``repro.kernels.butterfly.
butterfly_kernel._windows_kernel``) stores.  Rows need not be padded to the
tile: the kernel masks the ragged edge itself, and a zero row adds nothing,
so the partials equal the reference's at the same ``block_i``.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/butterfly_windows.cu`` (built at first use, see :mod:`.build`) or
raises; it never falls back.  On a CPU tensor it runs
:func:`butterfly_pairs_windows_plain`, the plain torch version of the same
function, which the CPU tests and ``chip_smoke.py``'s comparison use.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["butterfly_pairs_windows_kernel_call",
           "butterfly_pairs_windows_plain", "triangle_pairs", "n_tile_pairs",
           "launch_count", "reset_launch_count"]

# the kernel indexes with 32-bit ints and puts the window axis on gridDim.y
_MAX_WINDOWS = 65535
_MAX_ELEMS = 2**31 - 1

_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel was launched in this process (the
    CPU path and empty stacks launch nothing and count nothing)."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def n_tile_pairs(n: int, block_i: int) -> int:
    """Upper-triangle tile pairs ``T`` of an ``n``-row Gram side."""
    nu = -(-n // block_i)
    return nu * (nu + 1) // 2


def triangle_pairs(nu: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major ``(u, v)`` tile pairs with ``u <= v`` -- the order of the
    partials' ``T`` axis (the reference's scalar-prefetch tables)."""
    u, v = np.triu_indices(nu)
    return u.astype(np.int64), v.astype(np.int64)


def _check(adjs: torch.Tensor, block_i: int) -> None:
    if not isinstance(adjs, torch.Tensor):
        raise TypeError(f"adjs must be a torch.Tensor, got {type(adjs).__name__}")
    if adjs.dim() != 3:
        raise ValueError(f"adjs must be [B, n, k], got shape {tuple(adjs.shape)}")
    if adjs.dtype != torch.float32:
        raise ValueError(f"adjs must be float32, got {adjs.dtype}")
    if isinstance(block_i, bool) or not isinstance(block_i, int) or block_i < 1:
        raise ValueError(f"block_i must be a positive int, got {block_i!r}")


def butterfly_pairs_windows_plain(adjs: torch.Tensor, *, block_i: int = 256,
                                  dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """Plain torch version of K1: the full Gram by ``torch.matmul``, the
    epilogue ``w(w-1)/2`` masked to global ``row < col``, summed per tile
    pair.  ``dtype`` is the arithmetic type (float32 as the kernel; float64
    to hold the kernel against sums beyond 2**24).  Returns ``[B, T]`` in
    ``dtype``."""
    _check(adjs, block_i)
    b, n, _ = adjs.shape
    nu = -(-n // block_i)
    a = adjs.to(dtype)
    w = torch.matmul(a, a.transpose(1, 2))
    pairs = w * (w - 1.0) * 0.5
    idx = torch.arange(n, device=adjs.device)
    pairs = torch.where(idx[:, None] < idx[None, :], pairs,
                        torch.zeros((), dtype=dtype, device=adjs.device))
    pad = nu * block_i - n
    if pad:
        pairs = F.pad(pairs, (0, pad, 0, pad))
    tiles = pairs.reshape(b, nu, block_i, nu, block_i).sum(dim=(2, 4))
    u, v = triangle_pairs(nu)
    return tiles[:, torch.from_numpy(u).to(adjs.device),
                 torch.from_numpy(v).to(adjs.device)]


def butterfly_pairs_windows_kernel_call(adjs: torch.Tensor, *,
                                        block_i: int = 256) -> torch.Tensor:
    """K1's wrapper: ``[B, n, k]`` float32 0/1 stack -> ``[B, T]`` float32
    partials (one launch for the whole stack).

    Raises on anything the kernel does not take: another rank or dtype, a
    non-contiguous stack, more than 65535 windows or 2**31 elements per
    window, or a device other than CPU or CUDA.  The output is allocated
    with ``torch.empty`` and the kernel launches on the current CUDA stream
    without synchronizing; the C entry point's error code is checked right
    after the launch.
    """
    _check(adjs, block_i)
    if adjs.device.type == "cpu":
        return butterfly_pairs_windows_plain(adjs, block_i=block_i)
    if adjs.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, got {adjs.device}")
    if not adjs.is_contiguous():
        raise ValueError("adjs must be contiguous")
    b, n, k = adjs.shape
    if b > _MAX_WINDOWS or n * k > _MAX_ELEMS:
        raise ValueError(
            f"adjs {tuple(adjs.shape)} exceeds the kernel's limits "
            f"({_MAX_WINDOWS} windows, {_MAX_ELEMS} elements per window)")
    t = n_tile_pairs(n, block_i)
    out = torch.empty((b, t), dtype=torch.float32, device=adjs.device)
    if b == 0 or t == 0:
        return out
    from .build import load_library

    lib = load_library().lib
    stream = torch.cuda.current_stream(adjs.device).cuda_stream
    with torch.cuda.device(adjs.device):
        err = lib.butterfly_windows_launch(adjs.data_ptr(), out.data_ptr(),
                                           b, n, k, block_i, stream)
    if err != 0:
        raise RuntimeError(f"butterfly_windows_launch failed: cudaError {err}")
    global _launches
    _launches += 1
    return out
