"""K1 and K2, the window-batched Gram-triangle butterfly kernels, K3's
single-matrix entry, and their plain twins.

:func:`butterfly_pairs_windows_kernel_call` (K1) is the wrapper the
program calls for distinct windows.  For a ``[B, n, k]`` stack of 0/1
biadjacencies (uint8 or float32; rows = the Gram side) and a square tiling
of each Gram matrix ``W = A A^T`` into ``block_i x block_i`` tiles, it
returns the ``[B, T]`` float32 per-tile-pair partials ``sum_{r<c}
w(w-1)/2`` over the upper-triangle tile pairs ``u <= v`` (row-major,
``T = nu (nu + 1) / 2``, ``nu = ceil(n / block_i)``) -- what the
reference's Pallas kernel
(``repro.kernels.butterfly.butterfly_kernel._windows_kernel``) stores.
Each per-entry value is the reference's float32 ``w(w-1)/2``, an integer;
a partial is their exact sum rounded once to float32, so it never depends
on the order of summation, and below 2**24 it is the reference's partial.
Rows need not be padded to the tile: the kernel masks the ragged edge
itself, and a zero row adds nothing.

K1 reads a uint8 stack through TMA, which needs a 16-byte-aligned base and
rows of a multiple of 16 bytes (:func:`tma_ready`).  The pallas tier's
scatter builds such a stack, and K1 reads it as it lies (route ``wgmma``);
anything else -- a float32 stack, odd row lengths -- goes to the kernel as
one zero-padded uint8 copy (route ``wgmma_padded``, :func:`tma_copy`).

:func:`butterfly_pairs_windows_multiset_kernel_call` (K2) is the multiset
twin (``_windows_kernel_multiset``): the float32 stack holds net edge
multiplicities, two Grams ``W = A A^T`` and ``S = (A∘A)(A∘A)^T`` ride the
contraction, and each partial is ``sum_{r<c} (w^2 - s)/2``.

:func:`butterfly_pairs_kernel_call` (K3, the reference's ``_kernel``) is K1
for one ``[n, k]`` matrix: it launches K1's CUDA kernel with ``B = 1`` and
returns ``[T]``.

On a CUDA tensor each wrapper launches its hand-written kernel (``csrc/``,
built at first use, see :mod:`.build`) or raises; it never falls back.  On
a CPU tensor it runs the plain torch version of the same function, which
the CPU tests and ``chip_smoke.py``'s comparisons use.  Each wrapper counts
its own launches, in all and for K1 and K3 per route
(:func:`launch_count`); the CPU path and empty stacks launch nothing and
count nothing.
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
           "triangle_pairs", "n_tile_pairs", "tma_ready", "tma_copy",
           "KERNELS", "ROUTES", "launch_count", "reset_launch_count"]

# the kernels index a window with 32-bit ints and take at most 65535 windows
_MAX_WINDOWS = 65535
_MAX_ELEMS = 2**31 - 1
# K1 and K3 read 0/1 stacks as uint8 (float32 ones through a copy); K2's
# multiplicities stay float32
_K1_DTYPES = (torch.uint8, torch.float32)
_K2_DTYPES = (torch.float32,)

KERNELS = ("K1", "K2", "K3")
# K1's and K3's routes: the stack as it lies, or a zero-padded uint8 copy
ROUTES = ("wgmma", "wgmma_padded")
_launches = dict.fromkeys(KERNELS, 0)
_routes = {(k, r): 0 for k in ("K1", "K3") for r in ROUTES}


def launch_count(kernel: str = "K1", route: str | None = None) -> int:
    """How many times ``kernel``'s wrapper launched its CUDA kernel in this
    process: in all, or (K1, K3) by the route named (one of
    :data:`ROUTES`)."""
    return _launches[kernel] if route is None else _routes[(kernel, route)]


def reset_launch_count() -> None:
    """Set every kernel's launch counts to 0."""
    for k in KERNELS:
        _launches[k] = 0
    for key in _routes:
        _routes[key] = 0


def n_tile_pairs(n: int, block_i: int) -> int:
    """Upper-triangle tile pairs ``T`` of an ``n``-row Gram side."""
    nu = -(-n // block_i)
    return nu * (nu + 1) // 2


def triangle_pairs(nu: int) -> tuple[np.ndarray, np.ndarray]:
    """Row-major ``(u, v)`` tile pairs with ``u <= v`` -- the order of the
    partials' ``T`` axis (the reference's scalar-prefetch tables)."""
    u, v = np.triu_indices(nu)
    return u.astype(np.int64), v.astype(np.int64)


def _check(adjs: torch.Tensor, block_i: int, rank: int = 3,
           dtypes: tuple = _K1_DTYPES) -> None:
    if not isinstance(adjs, torch.Tensor):
        raise TypeError(f"adjs must be a torch.Tensor, got {type(adjs).__name__}")
    if adjs.dim() != rank:
        want = "[B, n, k]" if rank == 3 else "[n, k]"
        raise ValueError(f"adjs must be {want}, got shape {tuple(adjs.shape)}")
    if adjs.dtype not in dtypes:
        names = " or ".join(str(d).split(".")[-1] for d in dtypes)
        raise ValueError(f"adjs must be {names}, got {adjs.dtype}")
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
    """Plain torch version of K1 (uint8 or float32 0/1 stack): the Gram
    exactly (a float64 ``torch.matmul`` of 0/1 values), masked to global
    ``row < col`` and summed per tile pair.  ``dtype`` float32 is the
    kernel's arithmetic: ``w`` rounded to float32, the reference's float32
    per-entry value ``w(w-1)/2`` (an integer), summed exactly in int64 and
    rounded once to float32.  ``dtype`` float64 computes everything in
    float64, to hold the kernel against sums beyond 2**24.  Returns
    ``[B, T]`` in ``dtype``."""
    _check(adjs, block_i)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    a = adjs.to(torch.float64)
    w = torch.matmul(a, a.transpose(1, 2))
    if dtype == torch.float64:
        return _tile_pair_sums(w * (w - 1.0) * 0.5, block_i)
    w = w.to(torch.float32)
    pairs = (w * (w - 1.0) * 0.5).to(torch.int64)
    return _tile_pair_sums(pairs, block_i).to(torch.float32)


def butterfly_pairs_windows_multiset_plain(
        adjs: torch.Tensor, *, block_i: int = 256,
        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain torch version of K2: the two Grams ``W = A A^T`` and
    ``S = (A∘A)(A∘A)^T`` by ``torch.matmul``, the epilogue ``(w^2 - s)/2``
    masked to global ``row < col``, summed per tile pair, all in ``dtype``
    (float32 as the kernel; float64 to hold the kernel against sums beyond
    2**24).  Returns ``[B, T]``."""
    _check(adjs, block_i, dtypes=_K2_DTYPES)
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


def tma_ready(adjs: torch.Tensor) -> bool:
    """Whether K1 can read the ``[B, n, k]`` stack as it lies through TMA:
    uint8, contiguous, rows of a multiple of 16 bytes and a 16-byte-aligned
    base."""
    return (adjs.dtype == torch.uint8 and adjs.is_contiguous()
            and adjs.shape[-1] % 16 == 0 and adjs.data_ptr() % 16 == 0)


def tma_copy(adjs: torch.Tensor) -> torch.Tensor:
    """A contiguous uint8 copy of the 0/1 stack ``adjs`` with its rows
    zero-padded to a multiple of 16 bytes, which :func:`tma_ready` accepts.
    Zero columns add nothing to any ``w``."""
    b, n, k = adjs.shape
    out = torch.zeros((b, n, -(-k // 16) * 16), dtype=torch.uint8,
                      device=adjs.device)
    out[..., :k] = adjs
    return out


def _launch_output(kernel: str, adjs: torch.Tensor,
                   block_i: int) -> torch.Tensor:
    """The ``[B, T]`` float32 output of ``kernel`` on ``adjs``, allocated
    with ``torch.empty``, after raising on what the CUDA kernels do not
    take: a device other than CUDA, a non-contiguous stack, more than 65535
    windows or 2**31 elements per window."""
    if adjs.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {adjs.device}")
    if not adjs.is_contiguous():
        raise ValueError("adjs must be contiguous")
    b, n, k = adjs.shape
    if b > _MAX_WINDOWS or n * k > _MAX_ELEMS:
        raise ValueError(
            f"adjs {tuple(adjs.shape)} exceeds the kernel's limits "
            f"({_MAX_WINDOWS} windows, {_MAX_ELEMS} elements per window)")
    return torch.empty((b, n_tile_pairs(n, block_i)), dtype=torch.float32,
                       device=adjs.device)


def _launch_k1(kernel: str, adjs: torch.Tensor, block_i: int) -> torch.Tensor:
    """Launch K1's CUDA kernel (csrc/butterfly_windows_wgmma.cu) on a CUDA
    ``[B, n, k]`` 0/1 stack and count one launch of ``kernel`` (K1 or K3)
    and its route: the stack as it lies when :func:`tma_ready`, else one
    :func:`tma_copy`.  The kernel's uint64 scratch is allocated here with
    ``torch.empty``; the kernel launches on the current CUDA stream without
    synchronizing, and the C entry point's error code is checked right
    after the launch."""
    out = _launch_output(kernel, adjs, block_i)
    if out.numel() == 0:
        return out
    from .build import load_library

    route = "wgmma" if tma_ready(adjs) else "wgmma_padded"
    if route == "wgmma_padded":
        adjs = tma_copy(adjs)
    b, n, k = adjs.shape
    sums = torch.empty(out.shape, dtype=torch.int64, device=adjs.device)
    fn = load_library().lib.butterfly_windows_wgmma_launch
    stream = torch.cuda.current_stream(adjs.device).cuda_stream
    with torch.cuda.device(adjs.device):
        err = fn(adjs.data_ptr(), sums.data_ptr(), out.data_ptr(), b, n, k,
                 block_i, stream)
    if err != 0:
        raise RuntimeError(f"butterfly_windows_wgmma_launch failed: cudaError {err}")
    _launches[kernel] += 1
    _routes[(kernel, route)] += 1
    return out


def _launch_k2(adjs: torch.Tensor, block_i: int) -> torch.Tensor:
    """Launch K2's CUDA kernel on a CUDA ``[B, n, k]`` float32 stack and
    count one launch; stream and error check as in :func:`_launch_k1`."""
    out = _launch_output("K2", adjs, block_i)
    if out.numel() == 0:
        return out
    from .build import load_library

    b, n, k = adjs.shape
    fn = load_library().lib.butterfly_windows_multiset_launch
    stream = torch.cuda.current_stream(adjs.device).cuda_stream
    with torch.cuda.device(adjs.device):
        err = fn(adjs.data_ptr(), out.data_ptr(), b, n, k, block_i, stream)
    if err != 0:
        raise RuntimeError(f"butterfly_windows_multiset_launch failed: cudaError {err}")
    _launches["K2"] += 1
    return out


def butterfly_pairs_windows_kernel_call(adjs: torch.Tensor, *,
                                        block_i: int = 256) -> torch.Tensor:
    """K1's wrapper: ``[B, n, k]`` uint8 or float32 0/1 stack -> ``[B, T]``
    float32 partials (one launch for the whole stack; see
    :func:`_launch_k1`)."""
    _check(adjs, block_i)
    if adjs.device.type == "cpu":
        return butterfly_pairs_windows_plain(adjs, block_i=block_i)
    return _launch_k1("K1", adjs, block_i)


def butterfly_pairs_windows_multiset_kernel_call(
        adjs: torch.Tensor, *, block_i: int = 256) -> torch.Tensor:
    """K2's wrapper: ``[B, n, k]`` float32 stack of net multiplicities ->
    ``[B, T]`` float32 partials ``sum_{r<c} (w^2 - s)/2`` (one launch for
    the whole stack; see :func:`_launch_k2`)."""
    _check(adjs, block_i, dtypes=_K2_DTYPES)
    if adjs.device.type == "cpu":
        return butterfly_pairs_windows_multiset_plain(adjs, block_i=block_i)
    return _launch_k2(adjs, block_i)


def butterfly_pairs_kernel_call(adj: torch.Tensor, *,
                                block_i: int = 256) -> torch.Tensor:
    """K3's wrapper: one ``[n, k]`` uint8 or float32 0/1 matrix -> ``[T]``
    float32 partials, by K1's CUDA kernel at ``B = 1``."""
    _check(adj, block_i, rank=2)
    if adj.device.type == "cpu":
        return butterfly_pairs_plain(adj, block_i=block_i)
    return _launch_k1("K3", adj[None], block_i)[0]
