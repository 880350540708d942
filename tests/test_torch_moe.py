"""The port's MoE layer (``repro_torch.models.transformer.moe``) against the
reference's ``moe_apply`` on identical inputs.

Inputs are numpy draws from a seed, handed to both as the same float32 or
bfloat16 values; the parameters are the reference's ``init_moe`` draws
carried across.  The reference computes its routing inside ``moe_apply``
and returns only ``(y, aux)``, so :func:`reference_route` repeats its
routing lines (``src/repro/models/transformer/moe.py:57-77``) in jax to
hold the port's gate indices, gates, queue positions and kept choices to
them exactly.

Tolerances.  float32: ``y`` within rtol = atol = 1e-5 (measured max abs
gap 1.5e-06 on outputs up to 3.9: the same products summed in another
order), ``aux`` within rtol 1e-6.  bfloat16: both frameworks round every
expert product to bf16, but jax rounds the SwiGLU's ``silu`` at other
steps than torch (a third of the bf16 ``silu`` outputs differ by an ulp),
and the down projection sums those ulps over ``d_ff`` terms, so ``y`` is
held in absolute terms, within two bf16 ulps of the largest output (atol
0.0625 on outputs up to 4, where an ulp is 0.03125; measured max abs gap
0.03125).  Routing reads float32 logits of the same values, so gate
indices, queue positions and kept choices are equal in both dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.transformer.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.models.transformer.moe import (  # noqa: E402
    init_moe as j_init_moe,
    moe_apply as j_moe_apply,
)
from repro_torch.models.transformer import Block, MoEConfig  # noqa: E402
from repro_torch.arrays import tensor_from_numpy  # noqa: E402
from repro_torch.models.transformer.moe import (  # noqa: E402
    init_moe,
    moe_apply,
    moe_route,
)

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=0, atol=0.0625)}


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def layer(d, e, k, dff, dtype, seed=0):
    """The reference's MoE parameters of one layer (jax) and the same
    values as the port's ``Block``."""
    jp = j_init_moe(jax.random.PRNGKey(seed), d, JMoEConfig(e, k, dff),
                    dtype=getattr(jnp, dtype))
    p = Block({n: tensor_from_numpy(np.asarray(a), "cpu") for n, a in jp.items()})
    return jp, p


def tokens(t, d, dtype, seed=1, scale=1.0):
    x = np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)
    x = x * np.float32(scale)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def reference_route(jp, jx, e, k):
    """The reference's routing of one dispatch, line for line from
    ``moe_apply``: ``(gate_idx, gate_vals, pos, keep, cap)``."""
    t = jx.shape[0]
    cap = max(int(1.25 * k * t / e + 0.5), 1)
    logits = jx.astype(jnp.float32) @ jp["w_router"]
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32)
    flat = onehot.reshape(t * k, e)
    pos_in_expert = jnp.cumsum(flat, axis=0) - flat
    pos = (pos_in_expert * flat).sum(-1).reshape(t, k)
    return (np.asarray(gate_idx), np.asarray(gate_vals), np.asarray(pos),
            np.asarray(pos < cap), cap)


def assert_same_route(p, x, jp, jx, moe):
    r = moe_route(p, x, moe)
    gi, gv, pos, keep, cap = reference_route(jp, jx, moe.n_experts, moe.top_k)
    assert r.cap == cap
    np.testing.assert_array_equal(r.gate_idx.numpy(), gi)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.gate_vals.numpy(), gv, rtol=1e-6, atol=1e-7)
    return r


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,d,e,k,dff", [
    (200, 64, 4, 2, 32),       # phi3.5-moe's top-2, drops at capacity 125
    (96, 32, 4, 4, 48),        # dbrx's top-4 of 4: every expert each token
    (300, 48, 16, 2, 24),      # 16 experts, capacity 47
    (7, 16, 8, 3, 16),         # a ragged handful
])
def test_moe_apply_matches_the_reference(dtype, t, d, e, k, dff):
    jp, p = layer(d, e, k, dff, dtype, seed=t)
    jx, x = tokens(t, d, dtype, seed=t + 1)
    moe = MoEConfig(n_experts=e, top_k=k, d_ff_expert=dff)
    y, aux = moe_apply(p, x, moe)
    jy, jaux = j_moe_apply(jp, jx, JMoEConfig(e, k, dff))
    assert y.shape == (t, d) and y.dtype == x.dtype
    np.testing.assert_allclose(as_np(y), as_np(jy), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert_same_route(p, x, jp, jx, moe)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slabs_route_with_their_own_capacity(dtype):
    """T = 2 x slab: each slab routes on its own (capacity 10 of 16 tokens,
    not 20 of 32), and aux is the mean of the slabs' terms.  Every token
    prefers expert 0, so each slab drops its own last 6 first choices,
    where one dispatch would drop tokens 20-31."""
    e, k, d, slab = 4, 2, 32, 16
    jp, p = layer(d, e, k, 24, dtype, seed=3)
    rng = np.random.default_rng(4)
    w = rng.standard_normal((d, e)).astype(np.float32)
    w[:, 0] = 1.0
    jp = {**jp, "w_router": jnp.asarray(w)}
    p.w_router.data = torch.from_numpy(w)
    x = np.abs(rng.standard_normal((2 * slab, d))).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    x = torch.from_numpy(x).to(getattr(torch, dtype))
    moe = MoEConfig(n_experts=e, top_k=k, d_ff_expert=24)
    y, aux = moe_apply(p, x, moe, slab=slab)
    jy, jaux = j_moe_apply(jp, jx, JMoEConfig(e, k, 24), slab=slab)
    np.testing.assert_allclose(as_np(y), as_np(jy), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    auxs = []
    for s in range(2):
        r = assert_same_route(p, x[s * slab:(s + 1) * slab], jp,
                              jx[s * slab:(s + 1) * slab], moe)
        assert r.cap == 10
        np.testing.assert_array_equal(r.keep.numpy()[:, 0],
                                      np.arange(slab) < 10)
        auxs.append(float(r.aux))
    np.testing.assert_allclose(float(aux), np.mean(auxs), rtol=1e-6)
    # one dispatch over all 32 tokens is another function
    whole = moe_route(p, x, moe)
    assert whole.cap == 20
    np.testing.assert_array_equal(whole.keep.numpy()[:, 0],
                                  np.arange(2 * slab) < 20)
    assert not torch.equal(moe_apply(p, x, moe, slab=32)[0], y)


@pytest.mark.parametrize("t,slab", [(24, 16), (16, 16)])
def test_no_slabs_unless_the_slab_divides_a_longer_input(t, slab):
    """Only T > slab with slab dividing T splits; otherwise one dispatch,
    as the reference."""
    jp, p = layer(32, 4, 2, 24, "float32", seed=5)
    jx, x = tokens(t, 32, "float32", seed=6)
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=24)
    y, aux = moe_apply(p, x, moe, slab=slab)
    jy, jaux = j_moe_apply(jp, jx, JMoEConfig(4, 2, 24), slab=slab)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL["float32"])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    one, _ = moe_apply(p, x, moe, slab=10**6)
    assert torch.equal(y, one)


@pytest.mark.parametrize("dtype", DTYPES)
def test_capacity_one_drops_the_later_of_colliding_choices(dtype):
    """A decode step's capacity: 4 tokens, top-2 of 8 experts, cap 1.  The
    router sends every token to experts 5 and 2, so only token 0 keeps its
    choices; the others add nothing and their gates are not renormalised."""
    e, k, d = 8, 2, 16
    jp, p = layer(d, e, k, 24, dtype, seed=7)
    w = np.zeros((d, e), np.float32)
    w[:, 5], w[:, 2] = 2.0, 1.0
    jp = {**jp, "w_router": jnp.asarray(w)}
    p.w_router.data = torch.from_numpy(w)
    jx, x = tokens(4, d, dtype, seed=8, scale=0.0)
    x = x + 1
    jx = jx + 1
    moe = MoEConfig(n_experts=e, top_k=k, d_ff_expert=24)
    r = assert_same_route(p, x, jp, jx, moe)
    assert r.cap == 1
    np.testing.assert_array_equal(r.gate_idx.numpy(), [[5, 2]] * 4)
    np.testing.assert_array_equal(r.pos.numpy(), [[0, 0], [1, 1], [2, 2],
                                                   [3, 3]])
    np.testing.assert_array_equal(r.keep.numpy(), [[True, True]]
                                  + [[False, False]] * 3)
    y, _ = moe_apply(p, x, moe)
    jy, _ = j_moe_apply(jp, jx, JMoEConfig(e, k, 24))
    np.testing.assert_allclose(as_np(y), as_np(jy), **TOL[dtype])
    assert not y[1:].any()
    assert y[0].abs().sum() > 0


def test_a_second_choice_queues_before_the_next_tokens_first():
    """Queue positions count (token, choice) token major: token 0's second
    choice (expert 1) is queued before token 1's first (expert 1); at
    capacity 1 token 1 loses that choice and keeps its other, un-
    renormalised."""
    e, k, d = 4, 2, 4
    jp, p = layer(d, e, k, 8, "float32", seed=9)
    w = np.zeros((d, e), np.float32)
    w[0] = [3.0, 2.0, 0.0, -1.0]      # token 0: experts 0 then 1
    w[1] = [-1.0, 3.0, 2.0, 0.0]      # token 1: experts 1 then 2
    jp = {**jp, "w_router": jnp.asarray(w)}
    p.w_router.data = torch.from_numpy(w)
    x = np.eye(d, dtype=np.float32)[:2]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    moe = MoEConfig(n_experts=e, top_k=k, d_ff_expert=8)
    r = assert_same_route(p, tx, jp, jx, moe)
    assert r.cap == 1
    np.testing.assert_array_equal(r.gate_idx.numpy(), [[0, 1], [1, 2]])
    np.testing.assert_array_equal(r.pos.numpy(), [[0, 0], [1, 0]])
    np.testing.assert_array_equal(r.keep.numpy(), [[True, True],
                                                   [False, True]])
    y, _ = moe_apply(p, tx, moe)
    jy, _ = j_moe_apply(jp, jx, JMoEConfig(e, k, 8))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL["float32"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tied", ["uniform", "columns"])
def test_tied_probabilities_take_the_lower_expert_first(dtype, tied):
    """Uniform rows (a zero router) and two equal router columns tie in
    probability exactly; ``jax.lax.top_k`` takes the lower index first and
    so does the port's stable descending sort."""
    e, k, d = 6, 3, 16
    jp, p = layer(d, e, k, 24, dtype, seed=10)
    rng = np.random.default_rng(11)
    w = rng.standard_normal((d, e)).astype(np.float32)
    if tied == "uniform":
        w[:] = 0.0
    else:
        w[:, 4] = w[:, 1]
        w[:, 5] = w[:, 1]
    jp = {**jp, "w_router": jnp.asarray(w)}
    p.w_router.data = torch.from_numpy(w)
    jx, x = tokens(40, d, dtype, seed=12)
    moe = MoEConfig(n_experts=e, top_k=k, d_ff_expert=24)
    r = assert_same_route(p, x, jp, jx, moe)
    if tied == "uniform":
        np.testing.assert_array_equal(r.gate_idx.numpy(), [[0, 1, 2]] * 40)
    else:
        # wherever expert 1 is chosen, its tied twins follow it in order
        gi = r.gate_idx.numpy()
        rows = (gi == 1).any(-1) & (gi == 4).any(-1)
        assert rows.any()
        for row in gi[rows]:
            assert list(row).index(1) < list(row).index(4)
    y, aux = moe_apply(p, x, moe)
    jy, jaux = j_moe_apply(jp, jx, JMoEConfig(e, k, 24))
    np.testing.assert_allclose(as_np(y), as_np(jy), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_init_moe_distributions():
    """The reference's shapes, dtypes and scales: a float32 router
    N(0, 1/d), experts N(0, 1/d) in and N(0, 1/d_ff) out in the model's
    dtype."""
    d, moe = 256, MoEConfig(n_experts=4, top_k=2, d_ff_expert=512)
    p = init_moe(torch.Generator().manual_seed(0), d, moe, dtype=torch.bfloat16)
    jp = j_init_moe(jax.random.PRNGKey(0), d, JMoEConfig(4, 2, 512),
                    dtype=jnp.bfloat16)
    for name, t in p.items():
        assert t.shape == jp[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(jp[name].dtype), name
    assert abs(float(p["w_router"].std()) * d ** 0.5 - 1) < 0.05
    assert abs(float(p["wi"].float().std()) * d ** 0.5 - 1) < 0.02
    assert abs(float(p["wg"].float().std()) * d ** 0.5 - 1) < 0.02
    assert abs(float(p["wo"].float().std()) * 512 ** 0.5 - 1) < 0.02
    again = init_moe(torch.Generator().manual_seed(0), d, moe,
                     dtype=torch.bfloat16)
    assert all(torch.equal(again[n], p[n]) for n in p)
    assert not torch.equal(p["wi"], p["wg"])


def test_moe_param_specs_equal_the_reference():
    from repro.models.transformer.moe import moe_param_specs as j_specs
    from repro_torch.models.transformer import moe_param_specs

    assert moe_param_specs() == j_specs()


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "dbrx-132b",
                                  "phi4-mini-3.8b", "minicpm3-4b"])
def test_lm_param_specs_equal_the_reference(arch, fsdp):
    """``lm_param_specs`` (its MoE part built from ``moe_param_specs``)
    equals the reference's tree, leaf for leaf, with and without FSDP."""
    import dataclasses

    from repro.configs import get_arch as j_get_arch
    from repro.models.transformer.model import lm_param_specs as j_specs
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import lm_param_specs

    cfg = dataclasses.replace(get_arch(arch).full_config(), fsdp=fsdp)
    j_cfg = dataclasses.replace(j_get_arch(arch).full_config(), fsdp=fsdp)
    assert lm_param_specs(cfg) == j_specs(j_cfg)
