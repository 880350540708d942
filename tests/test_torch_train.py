"""The port's LM training against the reference: the loss, its gradients
(``jax.value_and_grad(lm_loss)``), the prefill attention's autograd
function (``jax.grad`` of the reference's chunked scan), remat, the
microbatched step, clipping and AdamW.

The reference's parameters (``init_lm_params`` from a PRNG key) are carried
across with ``params_from_reference``; tokens, cotangents and gradients
are numpy draws from a seed.  On CPU tensors the attention's forward runs
K4's plain version and its backward the float32 torch recompute.

Tolerances.  float32 loss: rtol 1e-4.  float32 gradients, per leaf:
``max|dg| <= 1e-4 * max|g_ref| + 1e-6`` (measured worst ratio
``max|dg| / max|g_ref|`` over the five smoke configs: 2.2e-06; loss
relative gap up to 2.9e-07).  bf16 (dense archs): the two frameworks
round bf16 at other places, so the loss is held within rtol 1e-3
(measured 9.4e-05) and each gradient leaf within ``max|dg| <= 0.05 *
max|g_ref|`` (measured worst 1.9e-02).  The attention's gradients in
float32: rtol = atol = 1e-5 (measured max abs gap 1.5e-06 on gradients up
to 7.1).  AdamW against the reference's on the same gradients: rtol 1e-5
(measured: equal bit for bit over three steps).  Three
steps of the LM cell's train step, each started in the port from the
reference's state: the loss and gradient norm within rtol 1e-4; every
parameter within ``2 * lr`` of the reference's after the step, and within
rtol 1e-5, atol 1e-6 except where the reference's gradient entry is at
most ``2e-3 * max|g_ref|`` of its leaf.  That floor is derived: a
gradient gap ``d`` at an entry of size ``|g|`` moves Adam's normalised
step by up to about ``2 * lr * d / |g|`` (bias correction weighs the
earlier moments in), so with ``d <= 3e-6 * max|g|`` (measured 1.4e-06) a
step at lr 3e-4 reaches atol 1e-6 only where ``|g| <= 1.8e-3 * max|g|``.
Measured: 7 of 3 x 426,624 parameter updates outside rtol 1e-5, by up to
2.8e-05, each at a gradient entry of at most 8.1e-06 * max|g_ref|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models.common import cross_entropy as j_cross_entropy  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    init_lm_params as j_init,
    lm_loss as j_lm_loss,
)
from repro.models.transformer.attention import (  # noqa: E402
    gqa_attention_chunked as j_gqa,
)
from repro.train.loop import make_train_step as j_make_train_step  # noqa: E402
from repro.train.optimizer import (  # noqa: E402
    adamw_init as j_adamw_init,
    adamw_update as j_adamw_update,
)
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_lm_params,
    lm_loss,
    params_from_reference,
    params_to_reference,
)
from repro_torch.models.transformer.attention import (  # noqa: E402
    attention_backward,
    gqa_attention_chunked,
)
from repro_torch.models.transformer.convert import (  # noqa: E402
    named_to_reference,
    reference_to_named,
)
from repro_torch.train import (  # noqa: E402
    AdamWState,
    TrainState,
    adamw_init,
    adamw_update,
    make_train_step,
)

ARCHS = ["phi4-mini-3.8b", "granite-8b", "phi3.5-moe-42b", "dbrx-132b",
         "minicpm3-4b"]
DENSE = ["phi4-mini-3.8b", "granite-8b"]
SEQ = 80                      # past one 64-row attention chunk, ragged


def configs(arch, dtype):
    return (dataclasses.replace(j_get_arch(arch).smoke_config(), dtype=dtype),
            dataclasses.replace(get_arch(arch).smoke_config(), dtype=dtype))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    a = np.asarray(x)
    if a.dtype == np.dtype("V2"):
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def leaves(tree, prefix=""):
    """A nested dict -> {path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def batch_for(cfg, seed=1, b=2, s=SEQ):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def port_value_and_grad(model, batch, cfg):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = lm_loss(model, {k: torch.as_tensor(v) for k, v in batch.items()},
                   cfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    return float(loss.detach()), dict(zip(named, grads))


@pytest.fixture(scope="module", params=[(a, "float32") for a in ARCHS]
                + [(a, "bfloat16") for a in DENSE],
                ids=lambda p: f"{p[0]}-{p[1]}")
def graded(request):
    arch, dtype = request.param
    jcfg, cfg = configs(arch, dtype)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    batch = batch_for(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(p, b, jcfg)))(jp, jb)
    model = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return dict(dtype=dtype, cfg=cfg, jp=jp, model=model, batch=batch,
                loss=float(loss), grads=leaves(jax.tree.map(np.asarray, grads)))


def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    lab = rng.integers(0, 50, (3, 7))
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = cross_entropy(torch.as_tensor(lg), torch.as_tensor(lab),
                            mask=None if m is None else torch.as_tensor(m))
        want = j_cross_entropy(jnp.asarray(lg), jnp.asarray(lab),
                               mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_lm_loss_and_gradients(graded):
    cfg = graded["cfg"]
    loss, grads = port_value_and_grad(graded["model"], graded["batch"], cfg)
    got = leaves(named_to_reference(grads, cfg))
    assert set(got) == set(graded["grads"])
    if graded["dtype"] == "float32":
        np.testing.assert_allclose(loss, graded["loss"], rtol=1e-4)
        rel, floor = 1e-4, 1e-6
    else:
        np.testing.assert_allclose(loss, graded["loss"], rtol=1e-3)
        rel, floor = 0.05, 0.0
    for name, want in graded["grads"].items():
        g, w = as_np(got[name]), as_np(want)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= rel * np.abs(w).max() + floor, name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    cfg = configs(arch, "float32")[1]
    model = init_lm_params(cfg, seed=2, device="cpu")
    batch = batch_for(cfg, seed=3)
    l1, g1 = port_value_and_grad(model, batch,
                                 dataclasses.replace(cfg, remat=True))
    l0, g0 = port_value_and_grad(model, batch,
                                 dataclasses.replace(cfg, remat=False))
    assert l1 == l0
    for name in g0:
        assert torch.equal(g1[name], g0[name]), name


def test_vocab_padding_takes_no_gradient():
    jcfg, cfg = configs("phi4-mini-3.8b", "float32")
    cfg = dataclasses.replace(cfg, vocab_size=500)      # padded to 512
    jp = j_init(jax.random.PRNGKey(3), dataclasses.replace(jcfg, vocab_size=500))
    model = params_from_reference(jax.tree.map(np.asarray, jp), cfg, "cpu")
    _, grads = port_value_and_grad(model, batch_for(cfg, b=1, s=9), cfg)
    assert not grads["head"][:, 500:].any()
    assert grads["head"][:, :500].abs().max() > 0


# -- the attention's autograd function -------------------------------------

@pytest.mark.parametrize("b,sq,skv,h,hkv,hd,hd_v,q_offset,chunk", [
    (2, 40, 40, 4, 2, 16, 16, 0, 16),      # GQA groups, ragged chunks
    (1, 24, 40, 4, 1, 16, 16, 16, 16),     # a later chunk against the keys
    (2, 33, 33, 2, 2, 96, 64, 0, 16),      # MLA: qk 96, v 64
    (1, 64, 64, 8, 8, 32, 32, 0, 64),      # one chunk
])
def test_attention_gradients_match_jax_grad(b, sq, skv, h, hkv, hd, hd_v,
                                            q_offset, chunk):
    rng = np.random.default_rng(sq * skv + hd)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, hd_v)).astype(np.float32)
    dout = rng.standard_normal((b, sq, h, hd_v)).astype(np.float32)

    def j_obj(q, k, v):
        out = j_gqa(q, k, v, causal=True, q_offset=q_offset, chunk_q=chunk,
                    chunk_k=chunk)
        return jnp.sum(out * dout)

    want = jax.grad(j_obj, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = gqa_attention_chunked(tq, tk, tv, causal=True, q_offset=q_offset,
                                chunk_q=chunk, chunk_k=chunk)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(dout))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_attention_forward_is_k4s_wrapper_bit_for_bit():
    from repro_torch.kernels.flash_attention.flash_kernel import flash_attention_bshd
    from repro_torch.models.transformer.attention import attention_scale
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               .to(torch.bfloat16) for s in ((2, 70, 4, 32), (2, 70, 2, 32),
                                              (2, 70, 2, 32)))
    want = flash_attention_bshd(q, k, v, block_q=32, block_k=32,
                                scale=attention_scale(32))
    with torch.inference_mode():
        assert torch.equal(gqa_attention_chunked(q, k, v, chunk_q=32,
                                                 chunk_k=32), want)
    assert torch.equal(gqa_attention_chunked(q.requires_grad_(), k, v,
                                             chunk_q=32, chunk_k=32), want)


def test_attention_backward_keeps_dtypes_and_ignores_masked_keys():
    rng = np.random.default_rng(6)
    q, k, v, d = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
                  .to(torch.bfloat16) for s in ((1, 20, 2, 16), (1, 30, 1, 16),
                                                 (1, 30, 1, 8), (1, 20, 2, 8)))
    dq, dk, dv = attention_backward(q, k, v, d, causal=True, q_offset=0,
                                    chunk_q=8, scale=0.25)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    # keys past the last query's position carry no gradient
    assert not dk[:, 20:].any() and not dv[:, 20:].any()


# -- the train step and AdamW -------------------------------------------------

def quad_loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def quad_state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": torch.as_tensor(rng.normal(size=(4, 2)).astype(np.float32)
                                   * 0.1), "b": torch.zeros(2)}
    return TrainState(params, adamw_init(params), seed)


def quad_batch(n=32, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w = rng.normal(size=(4, 2)).astype(np.float32)
    return {"x": torch.as_tensor(x), "y": torch.as_tensor(x @ w)}


def test_adamw_decreases_loss():
    state, batch = quad_state(), quad_batch()
    step = make_train_step(quad_loss, lr=0.05, weight_decay=0.0)
    l0 = float(quad_loss(state.params, batch))
    for _ in range(50):
        state, metrics = step(state, batch)
    assert float(metrics["loss"]) < l0 * 0.5
    assert int(metrics["step"]) == 50


def test_microbatching_matches_full_batch():
    batch = quad_batch(n=32)
    s1, s2 = quad_state(), quad_state()
    step1 = make_train_step(quad_loss, n_microbatches=1, lr=0.01, weight_decay=0.0)
    step4 = make_train_step(quad_loss, n_microbatches=4, lr=0.01, weight_decay=0.0)
    s1, m1 = step1(s1, batch)
    s2, m2 = step4(s2, batch)
    np.testing.assert_allclose(s1.params["w"].detach().numpy(),
                               s2.params["w"].detach().numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    huge = {"w": torch.full((3,), 1e9)}
    new_params, opt2, gnorm = adamw_update(huge, opt, params, lr=1.0,
                                           clip_norm=1.0, weight_decay=0.0)
    assert float(gnorm) > 1e8
    assert torch.all(new_params["w"].abs() < 10.0)
    assert int(opt2.step) == 1


def test_three_adamw_steps_equal_the_reference():
    rng = np.random.default_rng(7)
    p0 = {"a": rng.normal(size=(5, 3)).astype(np.float32),
          "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}
    gs = [{"a": rng.normal(size=(5, 3)).astype(np.float32) * s,
           "b": {"c": rng.normal(size=(4,)).astype(np.float32) * s}}
          for s in (0.3, 2.0, 0.05)]
    jp = jax.tree.map(jnp.asarray, p0)
    jopt = j_adamw_init(jp)
    params = {"a": torch.as_tensor(p0["a"]),
              "b": {"c": torch.as_tensor(p0["b"]["c"])}}
    opt = adamw_init(params)
    for g in gs:
        jp, jopt, jn = j_adamw_update(jax.tree.map(jnp.asarray, g), jopt, jp)
        params, opt, n = adamw_update(
            {"a": torch.as_tensor(g["a"]), "b.c": torch.as_tensor(g["b"]["c"])},
            opt, params)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-5)
    np.testing.assert_allclose(params["a"].numpy(), np.asarray(jp["a"]), rtol=1e-5)
    np.testing.assert_allclose(params["b"]["c"].numpy(), np.asarray(jp["b"]["c"]),
                               rtol=1e-5)
    np.testing.assert_allclose(opt.m["a"].numpy(), np.asarray(jopt.m["a"]), rtol=1e-5)
    np.testing.assert_allclose(opt.v["b.c"].numpy(), np.asarray(jopt.v["b"]["c"]),
                               rtol=1e-5)
    assert int(opt.step) == int(jopt.step) == 3


def test_three_lm_train_steps_equal_the_reference():
    """The cell's train step (2 microbatches) on phi4-mini's smoke config in
    float32, three steps against the reference's, each started in the port
    from the reference's state (parameters and moments), so that only that
    step's rounding separates the two.  A parameter may miss rtol 1e-5
    only where the reference's gradient entry is at most ``2e-3 *
    max|g_ref|`` of its leaf (see the module's docstring)."""
    jcfg, cfg = configs("phi4-mini-3.8b", "float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    batch = batch_for(cfg, b=4, s=24)
    jstep = jax.jit(j_make_train_step(lambda p, b: j_lm_loss(p, b, jcfg),
                                      n_microbatches=2))
    jstate = JTrainState(jp, j_adamw_init(jp), jax.random.PRNGKey(0))
    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), n_microbatches=2)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    halves = [{k: v[2 * i:2 * i + 2] for k, v in jb.items()} for i in range(2)]
    jgrad = jax.jit(jax.grad(lambda p: (j_lm_loss(p, halves[0], jcfg)
                                        + j_lm_loss(p, halves[1], jcfg)) / 2))
    lr = 3e-4
    for _ in range(3):
        host = jax.tree.map(np.asarray, (jstate.params, jstate.opt))
        state = TrainState(
            params_from_reference(host[0], cfg, "cpu"),
            AdamWState(torch.tensor(host[1].step),
                       reference_to_named(host[1].m, cfg, "cpu"),
                       reference_to_named(host[1].v, cfg, "cpu")), 0)
        ref_grad = leaves(jax.tree.map(np.asarray, jgrad(jstate.params)))
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4)
        assert int(state.opt.step) == int(jstate.opt.step)
        got = leaves(params_to_reference(state.params))
        for name, want in leaves(jax.tree.map(np.asarray, jstate.params)).items():
            gap = np.abs(as_np(got[name]) - want)
            assert gap.max() <= 2 * lr, name
            off = gap > 1e-6 + 1e-5 * np.abs(want)
            g = np.abs(ref_grad[name])
            assert (g[off] <= 2e-3 * g.max()).all(), name
