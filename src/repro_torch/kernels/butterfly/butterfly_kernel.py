"""K1 and K2, the window-batched Gram-triangle butterfly kernels, K3's
single-matrix entry, and their plain twins.

:func:`butterfly_pairs_windows_kernel_call` (K1) is the wrapper the
program calls for distinct windows.  For a ``[B, n, k]`` float32 stack of
0/1 biadjacencies (rows = the Gram side) and a square tiling of each Gram
matrix ``W = A A^T`` into ``block_i x block_i`` tiles, it returns the
``[B, T]`` per-tile-pair partials ``sum_{r<c} w(w-1)/2`` over the
upper-triangle tile pairs ``u <= v`` (row-major, ``T = nu (nu + 1) / 2``,
``nu = ceil(n / block_i)``) -- what the reference's Pallas kernel
(``repro.kernels.butterfly.butterfly_kernel._windows_kernel``) stores.
Rows need not be padded to the tile: the kernel masks the ragged edge
itself, and a zero row adds nothing, so the partials equal the reference's
at the same ``block_i``.

:func:`butterfly_pairs_windows_multiset_kernel_call` (K2) is the multiset
twin (``_windows_kernel_multiset``): the stack holds net edge
multiplicities, two Grams ``W = A A^T`` and ``S = (A∘A)(A∘A)^T`` ride the
contraction, and each partial is ``sum_{r<c} (w^2 - s)/2``.

:func:`butterfly_pairs_kernel_call` (K3, the reference's ``_kernel``) is K1
for one ``[n, k]`` matrix: it launches K1's CUDA kernel with ``B = 1`` and
returns ``[T]``.

On a CUDA tensor each wrapper launches its hand-written kernel (``csrc/``,
built at first use, see :mod:`.build`) or raises; it never falls back.  On
a CPU tensor it runs the plain torch version of the same function, which
the CPU tests and ``chip_smoke.py``'s comparisons use.  Each wrapper counts
its own launches (:func:`launch_count`); the CPU path and empty stacks
launch nothing and count nothing.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.butterfly import full_fp32_matmul

__all__ = ["butterfly_pairs_windows_kernel_call",
           "butterfly_pairs_windows_plain",
           "butterfly_pairs_windows_multiset_kernel_call",
           "butterfly_pairs_windows_multiset_plain",
           "butterfly_pairs_kernel_call", "butterfly_pairs_plain",
           "triangle_pairs", "n_tile_pairs", "KERNELS", "launch_count",
           "reset_launch_count"]

# the kernels index with 32-bit ints and put the window axis on gridDim.y
_MAX_WINDOWS = 65535
_MAX_ELEMS = 2**31 - 1

KERNELS = ("K1", "K2", "K3")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "K1") -> int:
    """How many times ``kernel``'s wrapper launched its CUDA kernel in this
    process."""
    return _launches[kernel]


def reset_launch_count() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS:
        _launches[k] = 0


def n_tile_pairs(n: int, block_i: int) -> int:
    """Upper-triangle tile pairs ``T`` of an ``n``-row Gram side."""
    nu = -(-n // block_i)
    return nu * (nu + 1) // 2


def triangle_pairs(nu: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major ``(u, v)`` tile pairs with ``u <= v`` -- the order of the
    partials' ``T`` axis (the reference's scalar-prefetch tables)."""
    u, v = np.triu_indices(nu)
    return u.astype(np.int64), v.astype(np.int64)


def _check(adjs: torch.Tensor, block_i: int, rank: int = 3) -> None:
    if not isinstance(adjs, torch.Tensor):
        raise TypeError(f"adjs must be a torch.Tensor, got {type(adjs).__name__}")
    if adjs.dim() != rank:
        want = "[B, n, k]" if rank == 3 else "[n, k]"
        raise ValueError(f"adjs must be {want}, got shape {tuple(adjs.shape)}")
    if adjs.dtype != torch.float32:
        raise ValueError(f"adjs must be float32, got {adjs.dtype}")
    if isinstance(block_i, bool) or not isinstance(block_i, int) or block_i < 1:
        raise ValueError(f"block_i must be a positive int, got {block_i!r}")


def _tile_pair_sums(pairs: torch.Tensor, block_i: int) -> torch.Tensor:
    """``[B, n, n]`` per-entry values -> ``[B, T]``: masked to global
    ``row < col`` and summed per upper-triangle tile pair."""
    b, n, _ = pairs.shape
    nu = -(-n // block_i)
    idx = torch.arange(n, device=pairs.device)
    pairs = torch.where(idx[:, None] < idx[None, :], pairs,
                        torch.zeros((), dtype=pairs.dtype, device=pairs.device))
    pad = nu * block_i - n
    if pad:
        pairs = F.pad(pairs, (0, pad, 0, pad))
    tiles = pairs.reshape(b, nu, block_i, nu, block_i).sum(dim=(2, 4))
    u, v = triangle_pairs(nu)
    return tiles[:, torch.from_numpy(u).to(pairs.device),
                 torch.from_numpy(v).to(pairs.device)]


def butterfly_pairs_windows_plain(adjs: torch.Tensor, *, block_i: int = 256,
                                  dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """Plain torch version of K1: the full Gram by ``torch.matmul``, the
    epilogue ``w(w-1)/2`` masked to global ``row < col``, summed per tile
    pair.  ``dtype`` is the arithmetic type (float32 as the kernel; float64
    to hold the kernel against sums beyond 2**24).  Returns ``[B, T]`` in
    ``dtype``."""
    _check(adjs, block_i)
    a = adjs.to(dtype)
    with full_fp32_matmul():
        w = torch.matmul(a, a.transpose(1, 2))
    return _tile_pair_sums(w * (w - 1.0) * 0.5, block_i)


def butterfly_pairs_windows_multiset_plain(
        adjs: torch.Tensor, *, block_i: int = 256,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain torch version of K2: the two Grams ``W = A A^T`` and
    ``S = (A∘A)(A∘A)^T`` by ``torch.matmul``, the epilogue ``(w^2 - s)/2``
    masked to global ``row < col``, summed per tile pair.  ``dtype`` as in
    :func:`butterfly_pairs_windows_plain`.  Returns ``[B, T]``."""
    _check(adjs, block_i)
    a = adjs.to(dtype)
    a2 = a * a
    with full_fp32_matmul():
        w = torch.matmul(a, a.transpose(1, 2))
        s = torch.matmul(a2, a2.transpose(1, 2))
    return _tile_pair_sums((w * w - s) * 0.5, block_i)


def butterfly_pairs_plain(adj: torch.Tensor, *, block_i: int = 256,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain torch version of K3: :func:`butterfly_pairs_windows_plain` of
    the one-window stack, ``[n, k]`` -> ``[T]``."""
    _check(adj, block_i, rank=2)
    return butterfly_pairs_windows_plain(adj[None], block_i=block_i,
                                         dtype=dtype)[0]


def _launch(kernel: str, entry: str, adjs: torch.Tensor,
            block_i: int) -> torch.Tensor:
    """Launch C entry point ``entry`` of the kernel library on a CUDA
    ``[B, n, k]`` stack and count one launch of ``kernel``.  Raises on
    anything the kernels do not take: a device other than CUDA, a
    non-contiguous stack, more than 65535 windows or 2**31 elements per
    window.  The output is allocated with ``torch.empty`` and the kernel
    launches on the current CUDA stream without synchronizing; the C
    entry point's error code is checked right after the launch."""
    if adjs.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {adjs.device}")
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

    fn = getattr(load_library().lib, entry)
    stream = torch.cuda.current_stream(adjs.device).cuda_stream
    with torch.cuda.device(adjs.device):
        err = fn(adjs.data_ptr(), out.data_ptr(), b, n, k, block_i, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    _launches[kernel] += 1
    return out


def butterfly_pairs_windows_kernel_call(adjs: torch.Tensor, *,
                                        block_i: int = 256) -> torch.Tensor:
    """K1's wrapper: ``[B, n, k]`` float32 0/1 stack -> ``[B, T]`` float32
    partials (one launch for the whole stack; see :func:`_launch`)."""
    _check(adjs, block_i)
    if adjs.device.type == "cpu":
        return butterfly_pairs_windows_plain(adjs, block_i=block_i)
    return _launch("K1", "butterfly_windows_launch", adjs, block_i)


def butterfly_pairs_windows_multiset_kernel_call(
        adjs: torch.Tensor, *, block_i: int = 256) -> torch.Tensor:
    """K2's wrapper: ``[B, n, k]`` float32 stack of net multiplicities ->
    ``[B, T]`` float32 partials ``sum_{r<c} (w^2 - s)/2`` (one launch for
    the whole stack; see :func:`_launch`)."""
    _check(adjs, block_i)
    if adjs.device.type == "cpu":
        return butterfly_pairs_windows_multiset_plain(adjs, block_i=block_i)
    return _launch("K2", "butterfly_windows_multiset_launch", adjs, block_i)


def butterfly_pairs_kernel_call(adj: torch.Tensor, *,
                                block_i: int = 256) -> torch.Tensor:
    """K3's wrapper: one ``[n, k]`` float32 0/1 matrix -> ``[T]`` float32
    partials, by K1's CUDA kernel at ``B = 1``."""
    _check(adj, block_i, rank=2)
    if adj.device.type == "cpu":
        return butterfly_pairs_plain(adj, block_i=block_i)
    return _launch("K3", "butterfly_windows_launch", adj[None], block_i)[0]
