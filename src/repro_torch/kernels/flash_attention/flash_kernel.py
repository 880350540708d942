"""K4, the flash-attention forward kernel, its wrappers and its plain twin.

:func:`flash_attention_bshd` is K4's wrapper.  For q ``[B, Sq, H, hd]``, k
``[B, Skv, Hkv, hd]`` and v ``[B, Skv, Hkv, hd_v]`` (``H`` a multiple of
``Hkv``: query head ``h`` reads key/value head ``h // (H // Hkv)``; MLA's
value head dim differs from the query's) it returns softmax attention
``[B, Sq, H, hd_v]`` by the FlashAttention-2 online softmax that the
reference's Pallas kernel
(``repro.kernels.flash_attention.flash_kernel._kernel``) runs: fp32 scores
``q.k * scale``, the causal mask by global index (query row ``r`` sits at
position ``q_offset + r``) with ``-1e30``, an fp32 ``(acc, m, l)`` and
``acc / max(l, 1e-30)`` written in ``q.dtype``.  Lengths need not divide a
block.  The caller gives the scale: the model's attention passes the
reference's float32 ``1/sqrt(hd)``; without one the wrappers use the
reference kernel's double (:func:`default_scale`), which its own entries
(:func:`flash_attention_call`, ``ops.flash_attention``) keep.

On a CUDA tensor the wrapper launches one of K4's two hand-written
variants (built at first use, see :mod:`.build`) on the tensors' strides --
no transpose and no copy of the key/value heads -- or raises; it never
falls back from one to the other or to torch.  bf16 inputs run the wgmma
kernel (``csrc/flash_attention_wgmma.cu``: tensor cores fed by TMA, the
fp32 P carried into PV as three bf16 limbs, :func:`split_bf16_limbs`); an
input whose base or strides TMA cannot take (not 16-byte aligned: a head
dim that is not a multiple of 8, or such a view) reaches it through a
zero-padded copy.  float32 inputs run the fp32 SIMT kernel
(``csrc/flash_attention.cu``).  On a CPU tensor it runs
:func:`flash_attention_plain`, the same online softmax in torch, block by
block in the reference's order, which the CPU tests and ``chip_smoke.py``'s
comparisons use.  On a ``meta`` tensor (the dry-run) it returns the
output's shape and dtype and tells an observer (``distributed.observe``)
K4's operations and bytes (:func:`k4_operations`).  The wrapper counts its
own launches, in all and per variant (:func:`launch_count`); the CPU and
``meta`` paths and empty inputs launch nothing and count nothing.

:func:`flash_attention_call` keeps the reference's ``[BH, S, hd]`` entry and
its ``ValueError`` when a length does not divide its block.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.butterfly import full_fp32_matmul
from ...distributed.observe import note_kernel

__all__ = ["flash_attention_bshd", "flash_attention_call",
           "flash_attention_plain", "check_blocks", "default_scale",
           "k4_operations", "launch_count",
           "reset_launch_count", "split_bf16_limbs", "tma_ready", "VARIANTS"]

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HD = 128
_MAX_GRID_YZ = 65535

# K4's variants: bf16 on wgmma with q, k, v as given, bf16 on wgmma through
# a padded copy, float32 on fp32 SIMT
VARIANTS = ("wgmma", "wgmma_padded", "simt")
_launches = dict.fromkeys(("K4", *VARIANTS), 0)


def launch_count(variant: str | None = None) -> int:
    """How many times K4's wrapper launched a CUDA kernel in this process:
    all variants, or the one named (one of :data:`VARIANTS`)."""
    return _launches["K4" if variant is None else variant]


def reset_launch_count() -> None:
    """Set K4's launch counts to 0."""
    for key in _launches:
        _launches[key] = 0


def split_bf16_limbs(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """The three bf16 limbs ``(hi, mid, lo)`` of a float32 ``p`` as the bf16
    K4 peels them: ``hi = bf16(p)``, ``mid = bf16(p - hi)``,
    ``lo = bf16(p - hi - mid)``, each rounded to nearest even and each
    subtraction exact in float32.  ``hi + mid + lo == p`` wherever no limb
    falls below float32's normal range (``p`` above about 2**-100)."""
    if p.dtype != torch.float32:
        raise ValueError(f"p must be float32, got {p.dtype}")
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` [B, S, H, hd] as it lies: a 16-byte-aligned
    base and, for every axis longer than 1, a stride of a multiple of 16
    bytes (the last axis is contiguous)."""
    return (t.data_ptr() % 16 == 0
            and all(n == 1 or st * t.element_size() % 16 == 0
                    for n, st in zip(t.shape[:3], t.stride()[:3])))


def _tma_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` with its head dim zero-padded to a
    multiple of 8 (16 bytes of bf16), which :func:`tma_ready` accepts."""
    b, s, h, hd = t.shape
    out = t.new_zeros((b, s, h, -(-hd // 8) * 8))
    out[..., :hd] = t
    return out


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, hd], got shape {tuple(t.shape)}")
    b, _, h, hd = q.shape
    if k.shape[:3] != v.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ "
                         "in batch, length or heads")
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch or head dim")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} "
                         "key/value heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    if isinstance(q_offset, bool) or not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")


def check_blocks(sq: int, skv: int, block_q: int, block_k: int
                 ) -> tuple[int, int]:
    """The reference's blocks ``(min(block_q, sq), min(block_k, skv))``;
    raises its ``ValueError`` when a length does not divide its block."""
    bq, bk = min(block_q, sq), min(block_k, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"seq lens ({sq},{skv}) must divide blocks ({bq},{bk})")
    return bq, bk


def default_scale(hd: int) -> float:
    """The reference kernel's scale, ``1 / hd ** 0.5`` as a Python double
    (rounded to float32 where it multiplies)."""
    return 1.0 / hd ** 0.5


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          block_q: int = 512, block_k: int = 512,
                          scale: float | None = None) -> torch.Tensor:
    """Plain torch version of K4: per query block of ``block_q`` rows, an
    online softmax over key blocks of ``block_k`` (the last of each may be
    short), every key block in order as the reference walks them, in full
    fp32.  Shapes and semantics as :func:`flash_attention_bshd`."""
    _check(q, k, v, q_offset)
    b, sq, h, hd = q.shape
    skv, hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = h // hkv
    if scale is None:
        scale = default_scale(hd)
    # [B, Hkv, G, S, hd]: query heads grouped under their key/value head
    qf = q.float().reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.empty((b, hkv, g, sq, hd_v), dtype=torch.float32,
                      device=q.device)
    bq, bk = max(1, min(block_q, sq)), max(1, min(block_k, skv))
    neg = torch.full((), _NEG, dtype=torch.float32, device=q.device)
    with full_fp32_matmul():
        for q0 in range(0, sq, bq):
            qb = qf[..., q0:q0 + bq, :]
            rows = q_offset + q0 + torch.arange(qb.shape[-2], device=q.device)
            acc = torch.zeros(qb.shape[:-1] + (hd_v,), dtype=torch.float32,
                              device=q.device)
            m = torch.full(qb.shape[:-1] + (1,), _NEG, dtype=torch.float32,
                           device=q.device)
            l = torch.zeros_like(m)
            for k0 in range(0, skv, bk):
                kb, vb = kf[..., k0:k0 + bk, :], vf[..., k0:k0 + bk, :]
                s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
                if causal:
                    cols = k0 + torch.arange(kb.shape[-2], device=q.device)
                    s = torch.where(rows[:, None] >= cols[None, :], s, neg)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + torch.matmul(p, vb)
                m = m_new
            out[..., q0:q0 + bq, :] = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd_v).to(q.dtype)


def k4_operations(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, q_offset: int = 0) -> float:
    """K4's useful operations: ``2 pairs hd`` for QK^T plus ``2 pairs
    hd_v`` for PV, ``pairs`` the (query, key) pairs the causal mask keeps
    (query row ``r`` sees ``min(Skv, q_offset + r + 1)`` keys) times ``B
    H``, the count ``chip_smoke.py``'s bound takes."""
    b, sq, h, hd = q.shape
    skv, hd_v = k.shape[1], v.shape[3]
    if causal:
        # rows whose window is still short, then rows that see every key
        short = max(0, min(sq, skv - q_offset))
        first = q_offset + 1
        keys = short * (first + first + short - 1) // 2 + (sq - short) * skv
    else:
        keys = sq * skv
    pairs = float(keys) * b * h
    return 2.0 * pairs * (hd + hd_v)


def _traced_k4(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, q_offset: int) -> torch.Tensor:
    """K4 on ``meta`` tensors: its output's shape and dtype, no launch and
    no count; K4's operations (:func:`k4_operations`) and bytes (q, k, v
    read once, the output written once) go to an observer."""
    b, sq, h, _ = q.shape
    out = torch.empty((b, sq, h, v.shape[3]), dtype=q.dtype, device="meta")
    note_kernel("K4", k4_operations(q, k, v, causal=causal, q_offset=q_offset),
                q.nbytes + k.nbytes + v.nbytes + out.nbytes)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, q_offset: int, scale: float) -> torch.Tensor:
    """Launch K4 on CUDA tensors and count one launch, in all and for its
    variant.  Raises on anything the kernels do not take: another device, a
    dtype other than float32 or bfloat16, a head dim (query or value) above
    128, a last axis that is not contiguous, or more than 65535 batches or
    heads.  A bf16
    input that is not :func:`tma_ready` goes to the kernel as a padded copy
    (variant ``wgmma_padded``).  The output is allocated with
    ``torch.empty`` and the kernel launches on the current CUDA stream
    without synchronizing; the C entry point's error code is checked right
    after the launch."""
    if q.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"K4 takes float32 or bfloat16, got {q.dtype}")
    b, sq, h, hd = q.shape
    skv, hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if max(hd, hd_v) > _MAX_HD:
        raise ValueError(f"K4 takes a head dim up to {_MAX_HD}, got {hd} "
                         f"(values {hd_v})")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must be contiguous along the head dim")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"K4 takes at most {_MAX_GRID_YZ} batches and heads, "
                         f"got {b} and {h}")
    out = torch.empty((b, sq, h, hd_v), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    from .build import load_library

    variant = "simt"
    if q.dtype == torch.bfloat16:
        ready = [tma_ready(t) for t in (q, k, v)]
        variant = "wgmma" if all(ready) else "wgmma_padded"
        q, k, v = (t if ok else _tma_copy(t) for t, ok in zip((q, k, v), ready))

    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    fn = load_library().lib.flash_attention_launch
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], b, h, h // hkv, sq, skv, hd, hd_v, strides,
                 int(causal), q_offset, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_launch failed: cudaError {err}")
    _launches["K4"] += 1
    _launches[variant] += 1
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         block_q: int = 512, block_k: int = 512,
                         scale: float | None = None) -> torch.Tensor:
    """K4's wrapper: q ``[B, Sq, H, hd]``, k ``[B, Skv, Hkv, hd]``, v ``[B,
    Skv, Hkv, hd_v]`` -> ``[B, Sq, H, hd_v]`` in ``q.dtype``.  ``scale``
    multiplies the scores (None: :func:`default_scale`, the reference
    kernel's).  ``block_q`` / ``block_k`` set the plain version's blocks
    only (K4 tiles by itself and masks ragged lengths)."""
    _check(q, k, v, q_offset)
    if scale is None:
        scale = default_scale(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                     block_q=block_q, block_k=block_k,
                                     scale=scale)
    if q.device.type == "meta":
        return _traced_k4(q, k, v, causal=causal, q_offset=q_offset)
    return _launch(q, k, v, causal=causal, q_offset=q_offset, scale=scale)


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, block_q: int = 512,
                         block_k: int = 512) -> torch.Tensor:
    """The reference's entry: q, k, v ``[BH, S, hd]`` -> ``[BH, Sq, hd]``,
    one head per row of ``BH``.  Raises ``ValueError`` when a length does not
    divide its block, as the reference does."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be [BH, S, hd], got shape {tuple(t.shape)}")
    check_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return flash_attention_bshd(q[:, :, None], k[:, :, None], v[:, :, None],
                                causal=causal, block_q=block_q,
                                block_k=block_k)[:, :, 0]
