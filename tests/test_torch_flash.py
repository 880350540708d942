"""K4's plain version and wrappers against the reference flash-attention
kernel.

The reference runs its Pallas kernel in interpret mode on the CPU, as its
own tests do (``tests/test_kernel_flash.py``).  On CPU tensors the port's K4
wrappers run the plain torch version, so these tests hold that version,
through ``flash_attention`` (``[B, S, H, hd]``, GQA by stride) and
``flash_attention_call`` (``[BH, S, hd]``), to the reference kernel and to
both packages' ``attention_ref``.  Inputs are numpy normals from a seed.

Tolerances: float32 rtol = atol = 2e-5, as the reference's own test (the
same online softmax summed in another order); bfloat16 one bf16 ulp (rtol
8e-3, atol 1e-3: both compute in float32 and round once to bfloat16, so
they differ by at most one rounding step where the float32 values straddle
a rounding boundary).  Held to the reference's float32 output on the same
bf16 inputs, a bf16 output is within its rounding, half a bf16 ulp (2**-8
of the value), on top of the float32 tolerance (``ROUNDED``); an online
softmax that keeps P in bf16 is not.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import (  # noqa: E402
    attention_ref as j_ref,
    flash_attention as j_flash,
)
from repro.kernels.flash_attention.flash_kernel import (  # noqa: E402
    flash_attention_call as j_call,
)
from repro.models.transformer.attention import (  # noqa: E402
    gqa_attention_chunked as j_gqa,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
    flash_attention_bshd,
    flash_attention_call,
    flash_attention_plain,
)
from repro_torch.core.butterfly import full_fp32_matmul  # noqa: E402
from repro_torch.kernels.flash_attention import flash_kernel  # noqa: E402
from repro_torch.models.transformer.attention import (  # noqa: E402
    attention_scale,
    gqa_attention_chunked,
)

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=8e-3, atol=1e-3)
ROUNDED = dict(rtol=2.0**-8 + 2e-5, atol=2e-5)


def rand_qkv(b, sq, skv, h, hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, hd), dtype=np.float32),
            rng.standard_normal((b, skv, hkv, hd), dtype=np.float32))


def both(arrays, dtype="float32"):
    """The same numpy arrays as JAX arrays and torch tensors of ``dtype``
    (float32 -> bfloat16 rounds to nearest even in both)."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


CASES = [
    # causal, b, sq, skv, h, hkv, hd, bq, bk
    (True, 1, 64, 64, 2, 2, 16, 16, 16),
    (False, 1, 64, 64, 2, 2, 16, 16, 16),
    (True, 2, 128, 128, 4, 2, 32, 32, 64),     # GQA groups + uneven blocks
    (False, 2, 128, 128, 4, 2, 32, 32, 64),
    (False, 1, 32, 96, 2, 1, 16, 16, 32),      # cross lengths
    (True, 1, 96, 96, 6, 2, 8, 32, 96),        # 3 groups, one key block
]


@pytest.mark.parametrize("causal,b,sq,skv,h,hkv,hd,bq,bk", CASES)
def test_flash_matches_reference_kernel(causal, b, sq, skv, h, hkv, hd, bq, bk):
    (jq, jk, jv), (q, k, v) = both(rand_qkv(b, sq, skv, h, hkv, hd, seed=sq + h))
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    want = j_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                   interpret=True)
    assert got.shape == (b, sq, h, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)


@pytest.mark.parametrize("causal,b,sq,skv,h,hkv,hd,bq,bk", CASES)
def test_flash_matches_both_oracles(causal, b, sq, skv, h, hkv, hd, bq, bk):
    (jq, jk, jv), (q, k, v) = both(rand_qkv(b, sq, skv, h, hkv, hd, seed=7))
    g = h // hkv
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    mine = attention_ref(q, k.repeat_interleave(g, dim=2),
                         v.repeat_interleave(g, dim=2), causal=causal)
    theirs = j_ref(jq, jnp.repeat(jk, g, axis=2), jnp.repeat(jv, g, axis=2),
                   causal=causal)
    np.testing.assert_allclose(as_np(got), as_np(theirs), **F32)
    np.testing.assert_allclose(as_np(mine), as_np(theirs), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_call_matches_reference_call(causal):
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal((6, 64, 16), dtype=np.float32) for _ in range(3)]
    (jq, jk, jv), (q, k, v) = both(arrays)
    got = flash_attention_call(q, k, v, causal=causal, block_q=16, block_k=32)
    want = j_call(jq, jk, jv, causal=causal, block_q=16, block_k=32,
                  interpret=True)
    assert got.shape == (6, 64, 16)
    np.testing.assert_allclose(as_np(got), as_np(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_within_one_ulp(causal):
    (jq, jk, jv), (q, k, v) = both(rand_qkv(2, 64, 64, 4, 2, 32, seed=3),
                                   "bfloat16")
    got = flash_attention(q, k, v, causal=causal, block_q=32, block_k=32)
    want = j_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                   interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got), as_np(want), **BF16)
    g = 2
    ref = j_ref(jq.astype(jnp.float32),
                jnp.repeat(jk, g, axis=2).astype(jnp.float32),
                jnp.repeat(jv, g, axis=2).astype(jnp.float32), causal=causal)
    np.testing.assert_allclose(as_np(got), as_np(ref), **BF16)


def bf16_p_attention(q, k, v, *, causal, block_k, n_limbs=1):
    """The online softmax of ``flash_attention_plain`` on [B, S, H, hd], but
    with P reaching the PV product as its first ``n_limbs`` bf16 limbs
    (``split_bf16_limbs``), each limb's product in float32.  One limb is P
    rounded to bf16 (what a bf16 tensor-core kernel does), a control that
    ``ROUNDED`` must reject; three are the fp32 P exactly, as the bf16 K4
    carries it."""
    g = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf, vf = (t.float().repeat_interleave(g, dim=2).transpose(1, 2)
              for t in (k, v))
    sq, skv = qf.shape[2], kf.shape[2]
    acc = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1] + (1,), -1e30)
    l = torch.zeros_like(m)
    for k0 in range(0, skv, block_k):
        s = qf @ kf[..., k0:k0 + block_k, :].transpose(-1, -2) / qf.shape[-1] ** 0.5
        if causal:
            cols = k0 + torch.arange(s.shape[-1])
            s = s.masked_fill(torch.arange(sq)[:, None] < cols, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        vb = vf[..., k0:k0 + block_k, :]
        with full_fp32_matmul():
            pv = sum(limb.float() @ vb
                     for limb in flash_kernel.split_bf16_limbs(p)[:n_limbs])
        acc = acc * corr + pv
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("causal,b,sq,skv,h,hkv,hd,bq,bk", [
    (True, 1, 256, 256, 4, 2, 64, 64, 128),
    (False, 2, 64, 192, 2, 1, 32, 32, 64),
])
def test_flash_bf16_is_the_rounding_of_float32(causal, b, sq, skv, h, hkv, hd,
                                               bq, bk):
    """bf16 inputs: the port's bf16 output is within ``ROUNDED`` of the
    reference kernel's float32 output on the same inputs widened; a bf16 P
    is not, at many elements, though it passes one-ulp ``BF16`` nearly
    everywhere."""
    _, (q, k, v) = both(rand_qkv(b, sq, skv, h, hkv, hd, seed=sq + hd),
                        "bfloat16")
    widened = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    want32 = as_np(j_flash(*widened, causal=causal, block_q=bq, block_k=bk,
                           interpret=True))
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got), want32, **ROUNDED)
    ctl = as_np(bf16_p_attention(q, k, v, causal=causal, block_k=bk))
    beyond = np.abs(ctl - want32) > ROUNDED["atol"] + ROUNDED["rtol"] * np.abs(want32)
    assert beyond.mean() > 0.01
    assert np.mean(np.abs(ctl - as_np(got)) > BF16["atol"]
                   + BF16["rtol"] * np.abs(as_np(got))) < 0.001


def exp_range_samples(n, seed):
    """float32 values over the exponents that softmax's ``p = exp(s - m)``
    takes down to 2**-100: every exponent in [-100, 0] with random
    significands, the bf16 rounding boundaries (ties) among them, and a
    dense sweep of ``exp(-x)``."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-100, 1, n)
    sig = 1.0 + rng.integers(0, 2**23, n) / 2.0**23
    ties = 1.0 + (2 * rng.integers(0, 2**7, n) + 1) / 2.0**8
    sweep = np.exp(-np.linspace(0.0, 100 * np.log(2.0), n))
    vals = np.concatenate([np.ldexp(sig, e), np.ldexp(ties, e), sweep, [1.0]])
    return torch.from_numpy(vals.astype(np.float32))


def assert_limbs_rebuild(p):
    hi, mid, lo = flash_kernel.split_bf16_limbs(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    # exact in float64, and in float32 in the kernel's order
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())
    assert torch.equal(hi.float() + mid.float() + lo.float(), p)
    # every limb at most half an ulp of the one before: none is wasted
    assert bool((mid.float().abs() <= hi.float().abs() * 2.0**-8).all())
    assert bool((lo.float().abs() <= mid.float().abs() * 2.0**-8).all())


def test_three_bf16_limbs_rebuild_p_exactly():
    """The bf16 K4's split of the fp32 P (``split_bf16_limbs``): hi + mid +
    lo == p exactly for every p that softmax gives down to 2**-100."""
    assert_limbs_rebuild(exp_range_samples(20000, seed=1))


def test_three_bf16_limbs_rebuild_p_exactly_hypothesis():
    """The same over hypothesis's float32 draws in [2**-100, 1]."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=500, deadline=None)
    @hypothesis.given(st.lists(st.floats(min_value=2.0**-100, max_value=1.0,
                                         width=32), min_size=1, max_size=64))
    def rebuild(xs):
        assert_limbs_rebuild(torch.tensor(xs, dtype=torch.float32))

    rebuild()


@pytest.mark.parametrize("n_keys,seed", [(64, 0), (1000, 1), (4096, 2)])
def test_pv_over_three_limbs_equals_fp32_pv(n_keys, seed):
    """P V with P as three bf16 limbs, each product in float32, equals the
    float32 P V within the float32 tolerance (``F32``, K4_TOL's float32)."""
    rng = np.random.default_rng(seed)
    s = torch.from_numpy(rng.standard_normal((32, n_keys), dtype=np.float32)) * 3
    p = torch.exp(s - s.amax(-1, keepdim=True))
    v = torch.from_numpy(rng.standard_normal((n_keys, 64), dtype=np.float32)
                         ).bfloat16().float()
    with full_fp32_matmul():
        want = p @ v
        got = sum(limb.float() @ v for limb in flash_kernel.split_bf16_limbs(p))
    torch.testing.assert_close(got, want, **F32)


@pytest.mark.parametrize("n_limbs,holds", [(1, False), (2, True), (3, True)])
def test_limbs_of_p_against_rounded(n_limbs, holds):
    """At bf16 inputs, the online softmax with P carried as three bf16 limbs
    is within ``ROUNDED`` of the reference kernel's float32 output, as K4
    is; with one limb (P in bf16) it is beyond it at many elements.  Two
    limbs (P to 16 bits, off by at most 2**-17 of each term) also hold at
    this size: K4 ships three, which are P exactly."""
    _, (q, k, v) = both(rand_qkv(1, 256, 256, 4, 2, 64, seed=11), "bfloat16")
    widened = [jnp.asarray(t.float().numpy()) for t in (q, k, v)]
    want32 = as_np(j_flash(*widened, causal=True, block_q=64, block_k=128,
                           interpret=True))
    got = as_np(bf16_p_attention(q, k, v, causal=True, block_k=128,
                                 n_limbs=n_limbs))
    beyond = np.abs(got - want32) > ROUNDED["atol"] + ROUNDED["rtol"] * np.abs(want32)
    if holds:
        assert not beyond.any()
    else:
        assert beyond.mean() > 0.01


def test_flash_first_token_attends_itself_only():
    """Causal row 0's output is v[0] exactly (a softmax over one key)."""
    _, (q, k, v) = both(rand_qkv(1, 16, 16, 1, 1, 8, seed=5))
    got = flash_attention(q, k, v, causal=True, block_q=8, block_k=8)
    np.testing.assert_allclose(got[0, 0, 0].numpy(), v[0, 0, 0].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("entry", ["bshd", "call"])
def test_lengths_must_divide_blocks(entry):
    _, (q, k, v) = both(rand_qkv(1, 48, 48, 2, 2, 16))
    if entry == "call":
        q, k, v = (t[:, :, 0] for t in (q, k, v))
        fn, jfn = flash_attention_call, j_call
    else:
        fn, jfn = flash_attention, j_flash
    with pytest.raises(ValueError, match="must divide blocks"):
        fn(q, k, v, block_q=32, block_k=16)
    with pytest.raises(ValueError, match="must divide blocks"):
        jfn(*(jnp.asarray(t.numpy()) for t in (q, k, v)), block_q=32,
            block_k=16, interpret=True)


@pytest.mark.parametrize("q_offset,sq,skv,bq,bk", [
    (0, 50, 50, 16, 16),        # ragged lengths, causal from 0
    (30, 20, 50, 8, 16),        # a later chunk of the prompt
    (7, 33, 40, 64, 64),        # one block each, both ragged
])
def test_plain_ragged_q_offset_matches_full_softmax(q_offset, sq, skv, bq, bk):
    """The kernel wrapper's own entry: any lengths, queries at global
    positions ``q_offset + r``, masked against the full softmax."""
    _, (q, k, v) = both(rand_qkv(2, sq, skv, 4, 2, 16, seed=q_offset))
    got = flash_attention_bshd(q, k, v, causal=True, q_offset=q_offset,
                               block_q=bq, block_k=bk)
    kf, vf = (t.repeat_interleave(2, dim=2).double() for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), kf) / 4.0
    rows = q_offset + torch.arange(sq)[:, None]
    s = s.masked_fill(rows < torch.arange(skv)[None, :], float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def test_cpu_path_launches_nothing():
    flash_kernel.reset_launch_count()
    _, (q, k, v) = both(rand_qkv(1, 32, 32, 2, 1, 16))
    flash_attention(q, k, v, block_q=16, block_k=16)
    flash_attention_plain(q, k, v)
    assert flash_kernel.launch_count() == 0


@pytest.mark.parametrize("bad,match", [
    (lambda q, k, v: (q, k[..., :8], v[..., :8]), "disagree"),
    (lambda q, k, v: (q, k, v[:, :8]), "differ"),
    (lambda q, k, v: (q[:, :, :3], k, v), "do not group"),
    (lambda q, k, v: (q, k.double(), v.double()), "dtypes differ"),
    (lambda q, k, v: (q[0], k, v), r"\[B, S, H, hd\]"),
])
def test_wrapper_rejects_malformed_inputs(bad, match):
    _, qkv = both(rand_qkv(1, 16, 16, 4, 2, 16))
    with pytest.raises(ValueError, match=match):
        flash_attention_bshd(*bad(*qkv))


def test_wrapper_rejects_negative_q_offset():
    _, (q, k, v) = both(rand_qkv(1, 16, 16, 2, 2, 16))
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_bshd(q, k, v, q_offset=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,b,sq,skv,h,hkv,hd,hd_v,chunk", [
    (True, 0, 2, 100, 100, 4, 4, 96, 64, 64),   # MiniCPM3's MLA head dims
    (True, 30, 1, 20, 50, 4, 2, 96, 64, 16),    # a later chunk, GQA groups
    (False, 0, 1, 24, 70, 2, 2, 24, 16, 32),    # the MLA smoke config's dims
    (True, 0, 1, 64, 64, 2, 1, 16, 40, 32),     # values wider than queries
])
def test_value_head_dim_matches_the_reference_attention(
        dtype, causal, q_offset, b, sq, skv, h, hkv, hd, hd_v, chunk):
    """K4's plain version with a value head dim other than the query's,
    through the model's ``gqa_attention_chunked``, against the reference's
    (MLA's prefill attention): ``[B, Sq, H, hd_v]``, within ``F32`` /
    ``BF16``, and a bf16 output within ``ROUNDED`` of the reference's
    float32 output on the same inputs."""
    rng = np.random.default_rng(hd * hd_v + sq)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for shape in (
        (b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd_v))]
    (jq, jk, jv), (q, k, v) = both(arrays, dtype)
    got = gqa_attention_chunked(q, k, v, causal=causal, q_offset=q_offset,
                                chunk_q=chunk, chunk_k=chunk)
    want = j_gqa(jq, jk, jv, causal=causal, q_offset=q_offset, chunk_q=chunk,
                 chunk_k=chunk)
    assert got.shape == (b, sq, h, hd_v) and got.dtype == q.dtype
    np.testing.assert_allclose(as_np(got), as_np(want),
                               **(F32 if dtype == "float32" else BF16))
    if dtype == "bfloat16":
        want32 = j_gqa(*(t.astype(jnp.float32) for t in (jq, jk, jv)),
                       causal=causal, q_offset=q_offset, chunk_q=chunk,
                       chunk_k=chunk)
        np.testing.assert_allclose(as_np(got), as_np(want32), **ROUNDED)
    plain = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                  block_q=chunk, block_k=chunk,
                                  scale=attention_scale(hd))
    assert torch.equal(plain, got)


def test_the_scale_is_the_reference_models_float32_value():
    """The model's attention scales by the reference's
    ``1 / sqrt(float32(hd))``.  At hd = 96 that is one float32 ulp below
    the double ``1 / 96 ** 0.5`` (the reference kernel's, which
    ``flash_attention_call`` keeps); at 16, 32, 64 and 128 they agree."""
    want96 = np.float32(1) / np.sqrt(np.float32(96))
    assert np.float32(attention_scale(96)) == want96 == np.float32(0.10206207)
    assert np.float32(flash_kernel.default_scale(96)) == np.float32(0.10206208)
    assert np.float32(attention_scale(96)) != np.float32(
        flash_kernel.default_scale(96))
    for hd in (16, 32, 64, 128):
        assert np.float32(attention_scale(hd)) == np.float32(
            flash_kernel.default_scale(hd)) == np.float32(1) / np.sqrt(
            np.float32(hd))


@pytest.mark.parametrize("scale", [None, 0.3])
def test_the_wrapper_scales_by_its_callers_scale(scale):
    """``flash_attention_bshd`` multiplies the scores by the scale it is
    given, the reference kernel's double when none is given: the plain
    version at that scale, and the full softmax of ``q.k * scale``."""
    _, (q, k, v) = both(rand_qkv(1, 40, 40, 2, 2, 96, seed=4))
    got = flash_attention_bshd(q, k, v, causal=False, block_q=16, block_k=16,
                               scale=scale)
    used = flash_kernel.default_scale(96) if scale is None else scale
    assert torch.equal(got, flash_attention_plain(
        q, k, v, causal=False, block_q=16, block_k=16, scale=used))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * used
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.double())
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
