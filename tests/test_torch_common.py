"""The port's shared blocks (``repro_torch.models.common``) against the
reference's ``repro.models.common``: layer norm, the MLP's init and apply,
and the binary cross entropy on logits.

Inputs are numpy draws from a seed; the MLP's weights are the reference's,
carried across as numpy.  Tolerances: float32 outputs within rtol 1e-5,
atol 1e-6 (the two frameworks may order a reduction differently); a bf16
layer norm within one bf16 rounding (rtol 2**-7); the loss's gradient
within rtol 1e-5.  ``mlp_init`` draws from torch's generator, not JAX's
PRNG, so its weights are held to the reference's structure, dtypes, zero
biases and scale (the standard deviation of each ``[d_in, d_out]`` draw
within 5% of ``1/sqrt(d_in)``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import common as ref  # noqa: E402
from repro_torch.models import common  # noqa: E402


def draw(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_the_reference(dtype):
    x, scale, bias = draw(0, (4, 9, 48), 3.0), draw(1, (48,)), draw(2, (48,))
    got = common.layer_norm(torch.as_tensor(x).to(getattr(torch, dtype)),
                            torch.as_tensor(scale), torch.as_tensor(bias))
    want = ref.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                          jnp.asarray(bias))
    assert str(got.dtype) == f"torch.{dtype}"
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=1e-6)


@pytest.mark.parametrize("act,final_act", [("silu", False), ("relu", True),
                                           ("gelu", False)])
def test_mlp_apply_matches_the_reference(act, final_act):
    jp = ref.mlp_init(jax.random.PRNGKey(3), [16, 32, 24, 8])
    p = {k: [torch.as_tensor(np.array(a)) for a in v] for k, v in jp.items()}
    p["b"] = [b + torch.as_tensor(draw(4 + i, b.shape, 0.1))
              for i, b in enumerate(p["b"])]
    jp = {"w": jp["w"], "b": [jnp.asarray(b.numpy()) for b in p["b"]]}
    x = draw(9, (5, 7, 16))
    t_act = {"silu": torch.nn.functional.silu,
             "relu": torch.nn.functional.relu,
             "gelu": lambda v: torch.nn.functional.gelu(v, approximate="tanh")}
    j_act = {"silu": jax.nn.silu, "relu": jax.nn.relu,
             "gelu": lambda v: jax.nn.gelu(v, approximate=True)}
    got = common.mlp_apply(p, torch.as_tensor(x), act=t_act[act],
                           final_act=final_act)
    want = ref.mlp_apply(jp, jnp.asarray(x), act=j_act[act],
                         final_act=final_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_init_has_the_reference_structure_and_scale(dtype):
    dims = [256, 512, 128]
    jp = ref.mlp_init(jax.random.PRNGKey(0), dims, dtype=getattr(jnp, dtype))
    p = common.mlp_init(torch.Generator().manual_seed(0), dims,
                        dtype=getattr(torch, dtype))
    assert set(p) == set(jp) == {"w", "b"}
    for w, jw, d_in in zip(p["w"], jp["w"], dims[:-1]):
        assert tuple(w.shape) == jw.shape
        assert str(w.dtype) == f"torch.{dtype}" and jw.dtype == getattr(jnp, dtype)
        np.testing.assert_allclose(float(w.float().std()), d_in ** -0.5,
                                   rtol=0.05)
    for b, jb in zip(p["b"], jp["b"]):
        assert tuple(b.shape) == jb.shape and not b.any() and not jb.any()


def test_bce_with_logits_and_its_gradient_match_the_reference():
    x = draw(5, (6, 33), 8.0)                       # |x| up to ~30
    t = (np.random.default_rng(6).random((6, 33)) < 0.4).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_()
    got = common.bce_with_logits(xt, torch.as_tensor(t))
    (g,) = torch.autograd.grad(got, xt)
    want, jg = jax.value_and_grad(
        lambda v: ref.bce_with_logits(v, jnp.asarray(t)))(jnp.asarray(x))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)
