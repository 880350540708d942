"""The port's LM serving path against the reference, at the smoke configs
of every LM arch -- dense GQA (phi4-mini-3.8b, granite-8b), MoE
(phi3.5-moe-42b, top-2 of 4 experts; dbrx-132b, top-4 of 4) and MLA
(minicpm3-4b) -- in float32 and bfloat16.

The reference's parameters (``init_lm_params`` from a PRNG key) are carried
across with ``params_from_reference``; tokens and activations are numpy
draws from a seed.  On CPU tensors prefill attention runs K4's plain
version (``gqa_attention_chunked``'s chunked online softmax).

Tolerances.  float32: rtol = atol = 1e-4 (measured max abs gap on logits up
to 5.6: 6.9e-06), and the greedy tokens of a prefill-then-decode loop are
equal.  bfloat16: the two frameworks round bf16 at other places (matmul
outputs, the SwiGLU product, residual adds), and a one-ulp difference in a
hidden state carries through the layers: measured max abs gap on the logits
0.0508 for the dense archs and 0.0645 for minicpm3-4b (prefill and decode,
logits up to 5.6, where a bf16 ulp is 0.03125), held within atol 0.125
(four ulps at 4) and rtol 0; per-op bf16 results
(norm, rope, attention) within one bf16 ulp (rtol 8e-3, atol 1e-3).  In
bfloat16 greedy tokens can flip on near-ties, so decode is teacher-forced
with the reference's tokens.

bfloat16 MoE: routing is a discrete decision on float32 logits of bf16
hidden states, and those differ by an ulp between the frameworks, so a
token near a tie can take another expert (and, through the capacity, move
a later token's place in a queue).  So the port's MoE arithmetic runs on
the reference's route: the reference's ``gate_idx`` and queue positions
(recorded inside its jitted run by an ordered ``jax.debug.callback``) are
carried into a ``MoERoute`` with the port's own gates and aux
(:func:`routed`), and every position is held at the bf16 tolerance above,
at weight seeds 0-3.  Separately, every token whose own top-k differs from
the reference's is a near-tie: the gap between the reference's router
logits of the two experts that trade places is within what ``TIE_ULPS``
(4) bf16 ulps on each entry of the token's router input can move it
(:func:`assert_near_ties`; measured at most 0.74 of one ulp's reach, over
seeds 0-3).  ``aux`` within rtol 1e-2
(measured 3.3e-4; over seeds 0-3 up to 1.7e-3).  dbrx-132b's smoke config
routes every token to all 4 experts, so only the order of its choices and
their queue places can move.  float32 routing is equal and is held at the
float32 tolerances without forcing.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.core.butterfly import snapshot_count as j_snapshot_count  # noqa: E402
from repro.models.common import rms_norm as j_rms_norm  # noqa: E402
import repro.models.transformer.model as j_model  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    decode_step as j_decode_step,
    init_lm_params as j_init,
    lm_forward as j_lm_forward,
    prefill as j_prefill,
)
from repro.models.transformer.attention import (  # noqa: E402
    gqa_attention_chunked as j_gqa,
    gqa_decode_attention as j_decode_attn,
)
from repro.models.transformer.rope import (  # noqa: E402
    apply_rope as j_apply_rope,
    rope_freqs as j_rope_freqs,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.butterfly import count_butterflies_np, snapshot_count  # noqa: E402
from repro_torch.kernels.flash_attention import flash_kernel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    TransformerLM,
    decode_step,
    init_cache,
    init_lm_params,
    lm_forward,
    params_from_reference,
    prefill,
)
from repro_torch.models.transformer.attention import (  # noqa: E402
    gqa_attention_chunked,
    gqa_decode_attention,
)
from repro_torch.models.transformer import moe as moe_mod  # noqa: E402
from repro_torch.arrays import tensor_from_numpy  # noqa: E402
from repro_torch.models.transformer.rope import apply_rope, rope_freqs  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "granite-8b", "phi3.5-moe-42b", "dbrx-132b",
         "minicpm3-4b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0, atol=0.125)}
OP_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
          "bfloat16": dict(rtol=8e-3, atol=1e-3)}
PROMPT, GEN = 100, 3          # a prompt past one 64-row attention chunk
TIE_ULPS = 4                  # bf16 MoE: a route flip's logit gap, in ulps


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def both(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype)), torch.from_numpy(
        np.ascontiguousarray(a)).to(getattr(torch, dtype))


def cache_names(cfg):
    return ("ckv", "krope") if cfg.is_mla else ("k", "v")


def assert_close(got, want, served):
    np.testing.assert_allclose(as_np(got), want, **TOL[served["dtype"]])


@contextlib.contextmanager
def recording(cfg):
    """Record each MoE dispatch of the reference's runs traced inside the
    block: its ``gate_idx``, queue positions and float32 router logits, by
    an ordered callback on the reference's own routing arithmetic (the same
    ops as its ``moe_apply``'s, which XLA computes once)."""
    routes: list = []
    if cfg.moe is None:
        yield routes
        return
    orig = j_model.moe_apply

    def rec(p, x, moe, **kw):
        t, e, k = x.shape[0], moe.n_experts, moe.top_k
        logits = x.astype(jnp.float32) @ p["w_router"]
        _, gi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        flat = jax.nn.one_hot(gi, e, dtype=jnp.int32).reshape(t * k, e)
        pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(t, k)
        jax.debug.callback(
            lambda *a: routes.append(tuple(np.asarray(v) for v in a)),
            gi, pos, logits, ordered=True)
        return orig(p, x, moe, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_model, "moe_apply", rec)
        yield routes


def assert_near_ties(own_idx, ref_idx, ref_logits, x, w_router):
    """Every token whose own top-k differs from the reference's is a
    near-tie: the two experts ``a``, ``b`` that trade places have reference
    router logits within what ``TIE_ULPS`` bf16 ulps (``2**-8`` of each
    value) on every entry of the token's router input ``x`` can move their
    gap, ``TIE_ULPS * 2**-8 * sum_d |x_d| |w_da - w_db|``."""
    for t in np.flatnonzero((own_idx != ref_idx).any(-1)):
        for a, b in zip(own_idx[t], ref_idx[t]):
            if a != b:
                reach = np.abs(x[t]) @ np.abs(w_router[:, a] - w_router[:, b])
                gap = abs(ref_logits[t, a] - ref_logits[t, b])
                assert gap <= TIE_ULPS * 2.0 ** -8 * reach, (t, a, b, gap, reach)


@contextlib.contextmanager
def routed(routes):
    """Run the port's MoE dispatches on the recorded routes, in order: the
    reference's ``gate_idx``, queue positions and ``keep`` with the port's
    own gates (its probabilities at those experts, normalised), capacity
    and aux; each flip of the port's own route is held a near-tie.  With
    ``routes`` None the port routes itself."""
    if routes is None:
        yield
        return
    queue = list(routes)
    own = moe_mod.moe_route

    def forced(p, x, moe):
        r = own(p, x, moe)
        gi, pos, logits = queue.pop(0)
        gate_idx = torch.from_numpy(gi.astype(np.int64))
        assert_near_ties(r.gate_idx.numpy(), gi, logits, x.float().numpy(),
                         p.w_router.detach().numpy())
        probs = torch.softmax(x.float() @ p.w_router, dim=-1)
        gates = torch.gather(probs, 1, gate_idx)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        pos = torch.from_numpy(pos.astype(np.int64))
        return moe_mod.MoERoute(gate_idx, gates, pos, pos < r.cap, r.cap, r.aux)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe_mod, "moe_route", forced)
        yield
    assert not queue, f"{len(queue)} recorded dispatches not replayed"


def forced(served, phase):
    """The recorded routes of a bf16 MoE's ``phase``, else None."""
    if served["dtype"] == "bfloat16" and served["cfg"].moe is not None:
        return served["routes"][phase]
    return None


def configs(arch, dtype):
    return (dataclasses.replace(j_get_arch(arch).smoke_config(), dtype=dtype),
            dataclasses.replace(get_arch(arch).smoke_config(), dtype=dtype))


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def served(request):
    """One arch x dtype through the reference: weights, logits over all
    positions, a prefill, three decode steps fed the reference's greedy
    tokens; and the port's model carried across from the same weights."""
    arch, dtype = request.param
    jcfg, cfg = configs(arch, dtype)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, PROMPT))
    jt = jnp.asarray(toks, jnp.int32)
    max_len = PROMPT + GEN + 1
    fed, steps, routes = [], [], {"decode": []}
    with recording(jcfg) as rec:
        logits, aux = jax.jit(lambda p, t: j_lm_forward(p, t, jcfg))(jp, jt)
        jax.effects_barrier()
        routes["forward"] = list(rec)
        rec.clear()
        last, cache = jax.jit(lambda p, t: j_prefill(p, t, jcfg, max_len))(jp, jt)
        jax.effects_barrier()
        routes["prefill"] = list(rec)
        rec.clear()
        prefilled = {k: np.asarray(cache[k], np.float32) if k != "len"
                     else int(cache[k]) for k in cache}
        step = jax.jit(lambda p, c, t: j_decode_step(p, c, t, jcfg))
        nxt = jnp.argmax(last[:, :cfg.vocab_size], -1).astype(jnp.int32)
        for _ in range(GEN):
            fed.append(np.array(nxt))
            lo, cache = step(jp, cache, nxt)
            steps.append(np.asarray(lo, np.float32))
            jax.effects_barrier()
            routes["decode"].append(list(rec))
            rec.clear()
            nxt = jnp.argmax(lo[:, :cfg.vocab_size], -1).astype(jnp.int32)
    return dict(arch=arch, dtype=dtype, cfg=cfg, model=model, toks=toks,
                logits=np.asarray(logits, np.float32), aux=float(aux),
                last=np.asarray(last, np.float32),
                cache=prefilled, routes=routes,
                fed=fed, steps=steps, max_len=max_len)


# --------------------------------------------------------------------------
# the ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    jx, x = both(rng.standard_normal((3, 5, 64), dtype=np.float32) * 3, dtype)
    js, s = both(rng.standard_normal(64, dtype=np.float32), dtype)
    got = rms_norm(x, s)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(as_np(got), as_np(j_rms_norm(jx, js)),
                               **OP_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 10_000_000.0])
def test_rope(dtype, theta):
    rng = np.random.default_rng(1)
    jx, x = both(rng.standard_normal((2, 37, 4, 32), dtype=np.float32), dtype)
    pos = np.arange(5, 42)
    jc, js = j_rope_freqs(32, theta, jnp.asarray(pos))
    c, s = rope_freqs(32, theta, torch.as_tensor(pos))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    got = apply_rope(x, c, s)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(as_np(got), as_np(j_apply_rope(jx, jc, js)),
                               **OP_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,q_offset,sq,skv,chunk", [
    (True, 0, 100, 100, 64),    # S not a multiple of the chunk
    (True, 30, 20, 50, 16),     # a later prompt chunk against the cache
    (False, 0, 24, 70, 32),     # cross lengths
])
def test_gqa_attention_chunked(dtype, causal, q_offset, sq, skv, chunk):
    rng = np.random.default_rng(sq + skv)
    jq, q = both(rng.standard_normal((2, sq, 4, 32), dtype=np.float32), dtype)
    jk, k = both(rng.standard_normal((2, skv, 2, 32), dtype=np.float32), dtype)
    jv, v = both(rng.standard_normal((2, skv, 2, 32), dtype=np.float32), dtype)
    got = gqa_attention_chunked(q, k, v, causal=causal, q_offset=q_offset,
                                chunk_q=chunk, chunk_k=chunk)
    want = j_gqa(jq, jk, jv, causal=causal, q_offset=q_offset, chunk_q=chunk,
                 chunk_k=chunk)
    assert got.shape == (2, sq, 4, 32) and got.dtype == q.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), **OP_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lens", [17, [5, 30]])
def test_gqa_decode_attention(dtype, lens):
    rng = np.random.default_rng(4)
    jq, q = both(rng.standard_normal((2, 4, 32), dtype=np.float32), dtype)
    jk, k = both(rng.standard_normal((2, 40, 2, 32), dtype=np.float32), dtype)
    jv, v = both(rng.standard_normal((2, 40, 2, 32), dtype=np.float32), dtype)
    got = gqa_decode_attention(q, k, v, torch.as_tensor(lens) if isinstance(
        lens, list) else lens)
    want = j_decode_attn(jq, jk, jv, jnp.asarray(lens, jnp.int32))
    assert got.dtype == q.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), **OP_TOL[dtype])


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_lm_forward(served):
    with routed(forced(served, "forward")):
        logits, aux = lm_forward(served["model"], torch.as_tensor(served["toks"]),
                                 served["cfg"])
    assert logits.shape == served["logits"].shape
    if served["cfg"].moe is None:
        assert float(aux) == served["aux"] == 0.0
    else:
        assert served["aux"] > 0
        np.testing.assert_allclose(float(aux), served["aux"], rtol=1e-5 if
                                   served["dtype"] == "float32" else 1e-2)
    assert_close(logits, served["logits"], served)


def test_lm_forward_collects_the_cache(served):
    with routed(forced(served, "prefill")):
        _, _, entries = lm_forward(served["model"],
                                   torch.as_tensor(served["toks"]),
                                   served["cfg"], collect_cache=True)
    cfg = served["cfg"]
    for name, got in zip(cache_names(cfg), entries, strict=True):
        want = served["cache"][name][:, :, :PROMPT]
        assert got.shape == want.shape, name
        if not cfg.is_mla:
            assert got.shape == (cfg.n_layers, 2, PROMPT, cfg.n_kv_heads,
                                 cfg.head_dim)
        assert_close(got, want, served)


def test_prefill_last_logits_and_cache(served):
    with routed(forced(served, "prefill")):
        last, cache = prefill(served["model"], torch.as_tensor(served["toks"]),
                              served["cfg"], served["max_len"])
    assert_close(last, served["last"], served)
    assert cache["len"] == served["cache"]["len"] == PROMPT
    assert set(cache) == set(served["cache"]) == {*cache_names(served["cfg"]),
                                                  "len"}
    for name in cache_names(served["cfg"]):
        assert cache[name].shape == served["cache"][name].shape
        assert_close(cache[name], served["cache"][name], served)
        assert not cache[name][:, :, PROMPT:].any()


def test_three_decode_steps(served):
    cfg = served["cfg"]
    with routed(forced(served, "prefill")):
        _, cache = prefill(served["model"], torch.as_tensor(served["toks"]),
                           cfg, served["max_len"])
    for s, (fed, want) in enumerate(zip(served["fed"], served["steps"])):
        routes = forced(served, "decode")
        with routed(None if routes is None else routes[s]):
            logits, cache = decode_step(served["model"], cache, torch.as_tensor(
                fed, dtype=torch.int64), cfg)
        assert cache["len"] == PROMPT + s + 1
        assert_close(logits, want, served)


def test_greedy_tokens_equal(served):
    """float32: the port's own prefill-then-decode loop picks the reference's
    tokens.  bfloat16 may flip near-ties, so it is held to the first token
    only (decode logits are held teacher-forced above)."""
    res = serve.serve(served["model"], served["cfg"], served["toks"], GEN + 1)
    want = np.stack(served["fed"], axis=1)
    if served["dtype"] == "float32":
        np.testing.assert_array_equal(res.tokens[:, :GEN], want)
    else:
        np.testing.assert_array_equal(res.tokens[:, 0], want[:, 0])
    assert np.isfinite(as_np(res.last_logits)).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "dbrx-132b"])
def test_bf16_moe_logits_on_the_references_routes(arch, seed):
    """Every position of a bf16 MoE's logits within the bf16 tolerance at
    weight seeds 0-3, on the reference's routes; every flip of the port's
    own route a near-tie."""
    jcfg, cfg = configs(arch, "bfloat16")
    jp = j_init(jax.random.PRNGKey(seed), jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, PROMPT))
    with recording(jcfg) as rec:
        want, j_aux = jax.jit(lambda p, t: j_lm_forward(p, t, jcfg))(
            jp, jnp.asarray(toks, jnp.int32))
        jax.effects_barrier()
    assert len(rec) == cfg.n_layers
    with routed(rec):
        logits, aux = lm_forward(model, torch.as_tensor(toks), cfg)
    np.testing.assert_allclose(as_np(logits), np.asarray(want, np.float32),
                               **TOL["bfloat16"])
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-2)


def test_decode_refuses_a_full_cache():
    cfg = get_arch("phi4-mini-3.8b").smoke_config()
    model = init_lm_params(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 1, 4, device="cpu")
    cache["len"] = 4
    with pytest.raises(ValueError, match="full"):
        decode_step(model, cache, torch.zeros(1, dtype=torch.int64), cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_params_distributions(arch):
    """Shapes, dtypes and scales of the reference's initializer: dense
    weights N(0, 1/d_in) (the first attention projection, ``wq`` or MLA's
    ``wq_down``, and the FFN's output, ``wo_mlp`` or the experts' ``wo``),
    a float32 router, the embedding N(0, 0.02**2), norms 1; the same seed
    gives the same weights."""
    cfg = get_arch(arch).smoke_config()
    m = init_lm_params(cfg, seed=3, device="cpu")
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), configs(
        arch, "bfloat16")[0]))
    assert m.embed.shape == tree["embed"].shape
    assert m.head.shape == tree["head"].shape
    names = [name for name, _ in m.layers[0].named_parameters()]
    assert len(names) == len(jax.tree.leaves(tree["layers"]))
    for name, p in m.layers[0].named_parameters():
        want = tree["layers"]
        for part in name.split("."):
            want = want[part]
        assert p.shape == want.shape[1:], name
        assert str(p.dtype).split(".")[-1] == str(want.dtype), name
        assert not p.requires_grad
    assert abs(float(m.embed.float().std()) - 0.02) < 0.002
    d = cfg.d_model
    first = m.layers[1].wq_down if cfg.is_mla else m.layers[1].wq
    assert abs(float(first.float().std()) * d ** 0.5 - 1) < 0.05
    if cfg.moe is None:
        out, d_ff = m.layers[0].wo_mlp, cfg.d_ff
    else:
        out, d_ff = m.layers[0].moe.wo, cfg.moe.d_ff_expert
        assert m.layers[0].moe.w_router.dtype == torch.float32
    assert abs(float(out.float().std()) * d_ff ** 0.5 - 1) < 0.05
    assert torch.equal(m.layers[0].ln_attn, torch.ones(d, dtype=torch.bfloat16))
    again = init_lm_params(cfg, seed=3, device="cpu")
    ffn = (lambda layer: layer.wg) if cfg.moe is None else (
        lambda layer: layer.moe.wg)
    assert torch.equal(ffn(again.layers[1]), ffn(m.layers[1]))
    assert not torch.equal(ffn(m.layers[0]), ffn(m.layers[1]))


def test_bf16_arrays_carry_their_bits():
    """``np.asarray`` of a JAX bf16 array is an ``ml_dtypes.bfloat16`` array,
    which ``torch.from_numpy`` refuses; the bits travel as uint16."""
    x = np.array(jnp.asarray([1.0, -2.5, 3.1415926, 1e-20], jnp.bfloat16))
    with pytest.raises(TypeError):
        torch.from_numpy(x)
    got = tensor_from_numpy(x, "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  x.view(np.int16))


def test_decode_refuses_a_full_mla_cache():
    cfg = get_arch("minicpm3-4b").smoke_config()
    model = init_lm_params(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 1, 4, device="cpu")
    m = cfg.mla
    assert set(cache) == {"ckv", "krope", "len"}
    assert cache["ckv"].shape == (cfg.n_layers, 1, 4, m.kv_lora_rank)
    assert cache["krope"].shape == (cfg.n_layers, 1, 4, m.qk_rope_head_dim)
    cache["len"] = 4
    with pytest.raises(ValueError, match="full"):
        decode_step(model, cache, torch.zeros(1, dtype=torch.int64), cfg)


def test_a_layer_must_hold_its_configs_tensors():
    """A dense layer's tensors do not make an MoE or MLA model."""
    dense = init_lm_params(get_arch("phi4-mini-3.8b").smoke_config(), seed=0,
                           device="cpu")
    layers = [dict(b.named_parameters()) for b in dense.layers]
    for arch in ("phi3.5-moe-42b", "minicpm3-4b"):
        cfg = get_arch(arch).smoke_config()
        with pytest.raises(ValueError, match="holds"):
            TransformerLM(cfg, dense.embed, dense.head, dense.ln_f, layers)


# --------------------------------------------------------------------------
# the launcher and the sGrapp monitor
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "dbrx-132b",
                                  "minicpm3-4b"])
def test_serve_main_runs_moe_and_mla_on_the_cpu(capsys, arch):
    flash_kernel.reset_launch_count()
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt", "70", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] prefill 2x70" in out and "[serve] decode 3 steps" in out
    assert "sGrapp monitor" in out
    assert flash_kernel.launch_count() == 0


def test_serve_main_runs_on_the_cpu(capsys):
    flash_kernel.reset_launch_count()
    serve.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt", "70", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[serve] prefill 2x70" in out and "[serve] decode 3 steps" in out
    assert "sGrapp monitor" in out
    assert flash_kernel.launch_count() == 0


@pytest.mark.parametrize("gen,decode_s,want", [
    (4, 1.5, 2 * 3 / 1.5),    # 3 decode steps of 2 tokens: the prefill's not
    (1, 0.25, float("nan")),  # no decode step
    (4, 0.0, float("nan")),
])
def test_decode_rate_counts_the_decode_steps_tokens(gen, decode_s, want):
    res = serve.ServeResult(np.zeros((2, gen), np.int64), 0.5, decode_s,
                            torch.zeros(1), torch.zeros(1))
    np.testing.assert_equal(res.decode_tok_s(), want)


def test_serve_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "phi4-mini-3.8b", "--smoke"])


@pytest.mark.parametrize("batch,prompt,gen,vocab", [
    (4, 32, 8, 50),       # shared tokens across requests: many butterflies
    (3, 20, 5, 4000),     # sparse overlap
    (1, 10, 2, 30),       # one request: no butterfly
])
def test_monitor_butterflies_equals_the_oracle(batch, prompt, gen, vocab):
    rng = np.random.default_rng(batch * prompt)
    prompts = rng.integers(0, vocab, (batch, prompt))
    generated = rng.integers(0, vocab, (batch, gen))
    got = serve.monitor_butterflies(prompts, generated, "cpu")
    full = np.concatenate([prompts, generated], axis=1)
    edges = np.stack([np.repeat(np.arange(batch), full.shape[1]),
                      full.reshape(-1)], axis=1)
    assert got == count_butterflies_np(edges)


def test_snapshot_count_matches_the_reference():
    rng = np.random.default_rng(9)
    cap, n = 64, 50
    ei = np.zeros(cap, np.int32)
    ej = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    ei[:n], ej[:n], valid[:n] = rng.integers(0, 6, n), rng.integers(0, 9, n), True
    got = snapshot_count(torch.as_tensor(ei), torch.as_tensor(ej),
                         torch.as_tensor(valid), n_i=6, n_j=cap)
    want = j_snapshot_count(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(valid),
                            n_i=6, n_j=cap)
    assert float(got) == float(want) == count_butterflies_np(
        np.stack([ei[:n], ej[:n]], axis=1))


@pytest.mark.parametrize("seed", [0, 1])
def test_monitor_at_the_serve_shape_equals_the_reference(seed):
    """4 prompts x 4,096 tokens plus 64 generated, phi4-mini's vocabulary:
    the dense tier's whole-Gram sum (the diagonal's C(degree, 2) terms) passes
    2**24, so float32 counts may miss the int64 oracle by a few; the port's
    count equals the reference's, and both stay within the float32 bound
    (n**2 + n) * 2**-24 * that sum."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, 200_064, (4, 4096))
    generated = rng.integers(0, 200_064, (4, 64))
    got = serve.monitor_butterflies(prompts, generated, "cpu")
    full = np.concatenate([prompts, generated], axis=1)
    n = full.size
    cap = 1 << int(np.ceil(np.log2(n)))
    ei = np.zeros(cap, np.int32)
    ej = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    ei[:n], valid[:n] = np.repeat(np.arange(4), full.shape[1]), True
    ej[:n] = np.unique(full.reshape(-1), return_inverse=True)[1]
    want = float(j_snapshot_count(jnp.asarray(ei), jnp.asarray(ej),
                                  jnp.asarray(valid), n_i=4, n_j=cap))
    assert got == want
    edges = np.unique(np.stack([ei[:n], full.reshape(-1)], axis=1), axis=0)
    exact = count_butterflies_np(edges)
    deg = np.bincount(edges[:, 0]).astype(np.float64)
    total = np.sum(deg * (deg - 1) / 2) + 2 * exact
    assert total > 2**24
    assert abs(got - exact) <= 20 * 2.0**-24 * total
