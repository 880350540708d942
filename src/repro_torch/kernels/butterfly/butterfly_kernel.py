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

:func:`butterfly_pairs_windows_multiset_limbs_call` (K2) is the multiset
twin (``_windows_kernel_multiset``): the stack holds net edge
multiplicities, two Grams ``W = A A^T`` and ``S = (A∘A)(A∘A)^T`` ride the
contraction, and each partial is ``sum_{r<c} (w^2 - s)/2`` with the
reference's float32 arithmetic per entry.  K2 reads the multiplicities as
uint8 limb planes (``core.butterfly.build_biadjacency_limbs``), computes
``W`` and ``S`` exactly on the int8 tensor cores and rounds each once; the
per-entry values are multiples of 0.5, summed exactly and rounded once.
The pallas tier's limb scatter hands it such a stack (route
``wgmma_limbs``); :func:`butterfly_pairs_windows_kernel_multiset_call`
takes a float32 stack through one limb split (route ``wgmma_limbs_copy``).

:func:`butterfly_pairs_kernel_call` (K3, the reference's ``_kernel``) is K1
for one ``[n, k]`` matrix: it launches K1's CUDA kernel with ``B = 1`` and
returns ``[T]``.

On a CUDA tensor each wrapper launches its hand-written kernel (``csrc/``,
built at first use, see :mod:`.build`) or raises; it never falls back.  On
a CPU tensor it runs the plain torch version of the same function, which
the CPU tests and ``chip_smoke.py``'s comparisons use.  Each wrapper counts
its own launches, in all and per route (:func:`launch_count`); the CPU
path and empty stacks launch nothing and count nothing.  K1's wrapper also
takes a ``meta`` stack (the dry-run's placeholder device): it returns
K1's ``[B, T]`` float32 output on ``meta`` without launching, allocating
or counting, after the checks the card would make, and reports K1's
operations and bytes to an observer (``distributed.observe``).  The other
wrappers raise on ``meta``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.butterfly import (
    MASK_ROWS,
    join_limbs,
    limb_block_masks,
    n_limbs,
    split_limbs,
)
from ...distributed.observe import note_kernel

__all__ = ["butterfly_pairs_windows_kernel_call",
           "butterfly_pairs_windows_plain",
           "butterfly_pairs_windows_kernel_multiset_call",
           "butterfly_pairs_windows_multiset_limbs_call",
           "butterfly_pairs_windows_multiset_plain",
           "stack_limbs", "check_no_wrap", "vertex_sq", "round_split_sums",
           "MAX_VERTEX_SQ",
           "butterfly_pairs_kernel_call", "butterfly_pairs_plain",
           "triangle_pairs", "n_tile_pairs", "tma_ready", "tma_copy",
           "k1_operations",
           "KERNELS", "ROUTES", "K2_ROUTES", "launch_count",
           "reset_launch_count"]

# the kernels take at most 65535 windows; K2 indexes a window's plane with
# 32-bit ints.  K1 and K3 address a window through TMA coordinates (byte,
# row, window) and a 64-bit window stride, and their exact 64-bit sums stay
# below (n * k)**2 / 4 <= 2**62 up to 2**32 bytes a window
_MAX_WINDOWS = 65535
_MAX_ELEMS = 2**31 - 1
_MAX_ELEMS_K1 = 2**32
# K1 and K3 read 0/1 stacks as uint8 (float32 ones through a copy); K2's
# float32 entry takes multiplicities in float32
_K1_DTYPES = (torch.uint8, torch.float32)
_K2_DTYPES = (torch.float32,)
# K2 holds W and S in 64-bit integers and each entry's 2 (w^2 - s)/2 in a
# signed one: they stay in range while no vertex of either side has a sum
# of squared multiplicities past 2**31 (W_rc <= sqrt(W_rr W_cc); see
# csrc/butterfly_windows_multiset_wgmma.cu), which also keeps every
# multiplicity below 46,341 (two limbs) and its square below 2**31 (four)
MAX_VERTEX_SQ = 2**31

KERNELS = ("K1", "K2", "K3")
# K1's and K3's routes: the stack as it lies, or a zero-padded uint8 copy
ROUTES = ("wgmma", "wgmma_padded")
# K2's: a limb stack as the scatter built it, or a float32 stack split
# into limbs on the device first
K2_ROUTES = ("wgmma_limbs", "wgmma_limbs_copy")
_launches = dict.fromkeys(KERNELS, 0)
_routes = {(k, r): 0 for k in ("K1", "K3") for r in ROUTES}
_routes.update({("K2", r): 0 for r in K2_ROUTES})


def launch_count(kernel: str = "K1", route: str | None = None) -> int:
    """How many times ``kernel``'s wrapper launched its CUDA kernel in this
    process: in all, or by the route named (K1, K3: one of :data:`ROUTES`;
    K2: one of :data:`K2_ROUTES`)."""
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


def check_no_wrap(vertex_sq: int) -> None:
    """Raise ``ValueError`` if ``vertex_sq``, the largest sum of squared
    multiplicities at one vertex of a window (either side), passes
    :data:`MAX_VERTEX_SQ`, the bound under which K2's 64-bit Grams and
    per-entry values cannot wrap."""
    if vertex_sq > MAX_VERTEX_SQ:
        raise ValueError(
            f"a vertex's sum of squared multiplicities is {vertex_sq}: K2 "
            f"takes at most {MAX_VERTEX_SQ} (2**31, the limit of its exact "
            f"64-bit Grams)")


def vertex_sq(m: torch.Tensor) -> int:
    """The largest sum of squared multiplicities at one vertex, over both
    sides of every window of the ``[B, n, k]`` integer stack ``m`` (entries
    at most 65,536, so no sum wraps); one host synchronization."""
    if m.numel() == 0:
        return 0
    x = m.to(torch.int64) ** 2
    return int(torch.maximum(x.sum(dim=2).max(), x.sum(dim=1).max()))


def stack_limbs(max_mult: int) -> tuple[int, int]:
    """``(lw, ls)``: the limb planes a stack whose largest multiplicity is
    ``max_mult`` needs for ``A`` and for ``A∘A`` (:func:`n_limbs`), at
    least one each."""
    return max(1, n_limbs(max_mult)), max(1, n_limbs(max_mult * max_mult))


def _integer_stack(adjs: torch.Tensor) -> tuple[torch.Tensor, int]:
    """A float32 stack of multiplicities -> (its int64 copy, its largest
    value), after one host synchronization that refuses what K2 cannot hold
    exactly: values that are not non-negative integers, or a vertex past
    :func:`check_no_wrap` (values past 65,536 are clipped to it first,
    which such a vertex passes anyway, so no square wraps)."""
    m = adjs.clamp(max=65536).to(torch.int64)
    if adjs.numel() == 0:
        return m, 0
    x = m * m
    bad = ((adjs < 0) | (adjs != torch.trunc(adjs))).any()
    bad, sq_rows, sq_cols, top = torch.stack([
        bad.to(torch.int64), x.sum(dim=2).max(), x.sum(dim=1).max(),
        m.max()]).tolist()
    if bad:
        raise ValueError("K2 takes multiplicities that are non-negative "
                         "integers")
    check_no_wrap(max(sq_rows, sq_cols))
    return m, top


def _exact_grams(planes: torch.Tensor, lw: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, lw + ls, n, k]`` limb planes -> the exact int64 Grams ``W`` and
    ``S`` (``[B, n, n]``): every limb product a float64 Gram (exact: at
    most ``255^2 k < 2**53``), shifted and added in int64."""
    def gram(first: int, count: int) -> torch.Tensor:
        total = None
        for p in range(count):
            a = planes[:, first + p].to(torch.float64)
            for q in range(count):
                b = a if q == p else planes[:, first + q].to(torch.float64)
                g = torch.matmul(a, b.transpose(1, 2)).to(torch.int64)
                g <<= 8 * (p + q)
                total = g if total is None else total.add_(g)
        return total

    return gram(0, lw), gram(lw, planes.shape[1] - lw)


def butterfly_pairs_windows_multiset_plain(
        adjs: torch.Tensor, *, block_i: int = 256,
        dtype: torch.dtype = torch.float32,
        lw: int | None = None) -> torch.Tensor:
    """Plain torch version of K2 on a ``[B, n, k]`` float32 stack of
    multiplicities, or (``lw`` given) on its ``[B, lw + ls, n, k]`` uint8
    limb planes.  ``dtype`` float32 is the kernel's arithmetic: ``W`` and
    ``S`` exactly (:func:`_exact_grams`), each rounded to float32, the
    reference's float32 ``w * w - s`` per entry (an integer, twice the
    entry's value), masked to global ``row < col``, summed exactly per tile
    pair (split at bit 32, as the kernel sums) and rounded once to float32
    (:func:`round_split_sums`), then halved.  ``dtype`` float64
    computes everything in float64, to hold the kernel against sums beyond
    2**24.  Refuses what K2 refuses (:func:`check_no_wrap`, non-integer
    multiplicities).  Returns ``[B, T]`` in ``dtype``."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {dtype}")
    if lw is None:
        _check(adjs, block_i, dtypes=_K2_DTYPES)
        m, top = _integer_stack(adjs)
        planes = None
    else:
        _check_limbs(adjs, None, lw, block_i)
        planes = adjs
        m = join_limbs(planes, lw)
        check_no_wrap(vertex_sq(m))
    if dtype == torch.float64:
        a = m.to(torch.float64)
        a2 = a * a
        w = torch.matmul(a, a.transpose(1, 2))
        s = torch.matmul(a2, a2.transpose(1, 2))
        return _tile_pair_sums((w * w - s) * 0.5, block_i)
    if planes is None:
        lw, ls = stack_limbs(top)
        planes = split_limbs(m, lw, ls)
    w, s = _exact_grams(planes, lw)
    wf, sf = w.to(torch.float32), s.to(torch.float32)
    twice = (wf * wf - sf).to(torch.int64)
    hi = _tile_pair_sums(twice >> 32, block_i)
    lo = _tile_pair_sums(twice & 0xFFFFFFFF, block_i)
    return round_split_sums(hi, lo) * 0.5


def round_split_sums(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 ``hi`` and ``lo`` (``lo >= 0``) -> float32 ``2**32 hi + lo``,
    rounded once to nearest even, as K2's rounding pass rounds its split
    sums: directly where the sum fits 64 bits, else from ``hi`` (with the
    carry of ``lo``) with the remainder as a sticky bit (round to odd at
    2**32, then to nearest: the same result, ``hi`` having more than 26
    bits there)."""
    hi = hi + (lo >> 32)
    lo = lo & 0xFFFFFFFF
    small = (hi >= -2**31) & (hi < 2**31)
    near = ((torch.where(small, hi, 0) << 32) + lo).to(torch.float32)
    far = (hi | (lo != 0).to(torch.int64)).to(torch.float32) * 2.0**32
    return torch.where(small, near, far)


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
    """The ``[B, T]`` float32 output of ``kernel`` on ``adjs`` (a ``[B, n,
    k]`` stack or ``[B, planes, n, k]`` limb planes), allocated with
    ``torch.empty``, after raising on what the CUDA kernels do not take: a
    device other than CUDA, a non-contiguous stack, more than 65535 windows,
    or more than 2**32 elements per window (K1, K3) or 2**31 - 1 per window
    and plane (K2)."""
    if adjs.device.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {adjs.device}")
    return _output_within_limits(kernel, adjs, block_i)


def _output_within_limits(kernel: str, adjs: torch.Tensor,
                          block_i: int) -> torch.Tensor:
    if not adjs.is_contiguous():
        raise ValueError("adjs must be contiguous")
    b, n, k = adjs.shape[0], adjs.shape[-2], adjs.shape[-1]
    elems = _MAX_ELEMS if kernel == "K2" else _MAX_ELEMS_K1
    if b > _MAX_WINDOWS or n * k > elems:
        raise ValueError(
            f"adjs {tuple(adjs.shape)} exceeds the kernel's limits "
            f"({_MAX_WINDOWS} windows, {elems} elements per window)")
    return torch.empty((b, n_tile_pairs(n, block_i)), dtype=torch.float32,
                       device=adjs.device)


def k1_operations(adjs: torch.Tensor) -> float:
    """K1's operations on a ``[B, n, k]`` stack: the strict upper triangle
    of each window's Gram, ``2 B (n (n - 1) / 2) k`` (the count
    ``chip_smoke.py``'s bound takes)."""
    b, n, k = adjs.shape
    return 2.0 * b * n * (n - 1) / 2 * k


def _traced_k1(adjs: torch.Tensor, block_i: int) -> torch.Tensor:
    """K1 on a ``meta`` stack: its output's shape and dtype, no launch and
    no count; K1's operations and bytes (the stack read once at its element
    size, the partials written once, as its bound reckons them) go to an
    observer."""
    out = _output_within_limits("K1", adjs, block_i)
    note_kernel("K1", k1_operations(adjs), adjs.nbytes + out.nbytes)
    return out


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


def _check_limbs(planes: torch.Tensor, masks: torch.Tensor | None,
                 lw: int, block_i: int) -> None:
    if not isinstance(planes, torch.Tensor) or planes.dim() != 4 \
            or planes.dtype != torch.uint8:
        raise ValueError("planes must be a [B, lw + ls, n, k] uint8 tensor")
    if isinstance(lw, bool) or not isinstance(lw, int) \
            or not 1 <= lw <= 2 or not 1 <= planes.shape[1] - lw <= 4:
        raise ValueError(f"lw={lw!r} with {planes.shape[1]} planes: K2 takes "
                         f"1-2 limb planes for A and 1-4 for A∘A")
    want = (planes.shape[0], -(-planes.shape[2] // MASK_ROWS))
    if masks is not None and (tuple(masks.shape) != want
                              or masks.dtype != torch.int32
                              or masks.device != planes.device):
        raise ValueError(f"masks must be {list(want)} int32 on "
                         f"{planes.device}")
    _check(planes[:, 0], block_i)


def _launch_k2(planes: torch.Tensor, masks: torch.Tensor, lw: int,
               block_i: int, route: str) -> torch.Tensor:
    """Launch K2's CUDA kernel (csrc/butterfly_windows_multiset_wgmma.cu)
    on CUDA limb planes with their block masks and count one launch and
    its route.  The ``[B, T, 2]`` 64-bit scratch of split sums
    is allocated here; stream and error check as in :func:`_launch_k1`."""
    out = _launch_output("K2", planes, block_i)
    if out.numel() == 0:
        return out
    from .build import load_library

    b, n_planes, n, k = planes.shape
    if k % 16 or planes.data_ptr() % 16:
        raise ValueError("K2 reads limb planes whose rows are a multiple of "
                         "16 bytes from a 16-byte-aligned base")
    masks = masks.contiguous()
    sums = torch.empty(out.shape + (2,), dtype=torch.int64,
                       device=planes.device)
    fn = load_library().lib.butterfly_windows_multiset_wgmma_launch
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        err = fn(planes.data_ptr(), masks.data_ptr(), sums.data_ptr(),
                 out.data_ptr(), b, lw, n_planes - lw, n, k, block_i, stream)
    if err != 0:
        raise RuntimeError(
            f"butterfly_windows_multiset_wgmma_launch failed: cudaError {err}")
    _launches["K2"] += 1
    _routes[("K2", route)] += 1
    return out


def butterfly_pairs_windows_kernel_call(adjs: torch.Tensor, *,
                                        block_i: int = 256) -> torch.Tensor:
    """K1's wrapper: ``[B, n, k]`` uint8 or float32 0/1 stack -> ``[B, T]``
    float32 partials (one launch for the whole stack; see
    :func:`_launch_k1`; on ``meta``, :func:`_traced_k1`)."""
    _check(adjs, block_i)
    if adjs.device.type == "cpu":
        return butterfly_pairs_windows_plain(adjs, block_i=block_i)
    if adjs.device.type == "meta":
        return _traced_k1(adjs, block_i)
    return _launch_k1("K1", adjs, block_i)


def butterfly_pairs_windows_multiset_limbs_call(
        planes: torch.Tensor, masks: torch.Tensor, *, lw: int,
        block_i: int = 256) -> torch.Tensor:
    """K2's wrapper on limb planes: ``[B, lw + ls, n, k]`` uint8 planes of
    net multiplicities and their ``[B, ceil(n / 64)]`` int32 block masks
    (``core.butterfly.build_biadjacency_limbs``, or
    ``core.butterfly.limb_block_masks``) -> ``[B, T]`` float32 partials
    ``sum_{r<c} (w^2 - s)/2``, one launch for the whole stack (route
    ``wgmma_limbs``).  The caller has held every vertex to
    :func:`check_no_wrap`."""
    _check_limbs(planes, masks, lw, block_i)
    if planes.device.type == "cpu":
        return butterfly_pairs_windows_multiset_plain(planes, block_i=block_i,
                                                      lw=lw)
    return _launch_k2(planes, masks, lw, block_i, "wgmma_limbs")


def butterfly_pairs_windows_kernel_multiset_call(
        adjs: torch.Tensor, *, block_i: int = 256) -> torch.Tensor:
    """K2's wrapper on a ``[B, n, k]`` float32 stack of net multiplicities
    -> ``[B, T]`` float32 partials: one host synchronization refuses what
    K2 cannot hold (:func:`_integer_stack`), one device split makes the
    limb planes and their block masks, one launch counts them (route
    ``wgmma_limbs_copy``)."""
    _check(adjs, block_i, dtypes=_K2_DTYPES)
    if adjs.device.type == "cpu":
        return butterfly_pairs_windows_multiset_plain(adjs, block_i=block_i)
    if adjs.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, got {adjs.device}")
    m, top = _integer_stack(adjs)
    lw, ls = stack_limbs(top)
    planes = split_limbs(m, lw, ls)
    return _launch_k2(planes, limb_block_masks(planes), lw, block_i,
                      "wgmma_limbs_copy")


def butterfly_pairs_kernel_call(adj: torch.Tensor, *,
                                block_i: int = 256) -> torch.Tensor:
    """K3's wrapper: one ``[n, k]`` uint8 or float32 0/1 matrix -> ``[T]``
    float32 partials, by K1's CUDA kernel at ``B = 1``."""
    _check(adj, block_i, rank=2)
    if adj.device.type == "cpu":
        return butterfly_pairs_plain(adj, block_i=block_i)
    return _launch_k1("K3", adj[None], block_i)[0]
