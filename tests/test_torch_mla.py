"""The port's multi-head latent attention (MiniCPM3's MLA) against the
reference's ``mla_attention`` (prefill, latents expanded, attended by
``gqa_attention_chunked``) and ``mla_decode_attention`` (the absorbed form
against the cached latents).

The layer's parameters are the reference's ``init_lm_params`` draws at the
minicpm3-4b smoke config and at a config with MiniCPM3's head dims
(queries and keys of 64 + 32, values of 64), carried across; activations
are numpy draws from a seed.  On CPU tensors the prefill attention runs
K4's plain version.

Tolerances as the model's per-op checks: float32 rtol = atol = 1e-5 (the
same float32 products summed in another order); bfloat16 one bf16 ulp
(rtol 8e-3, atol 1e-3), where both round the same float32 values to bf16
at the same steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models.transformer import init_lm_params as j_init  # noqa: E402
from repro.models.transformer.attention import (  # noqa: E402
    mla_attention as j_mla,
    mla_decode_attention as j_mla_decode,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.transformer import Block, MLAConfig  # noqa: E402
from repro_torch.models.transformer.attention import (  # noqa: E402
    mla_attention,
    mla_decode_attention,
)
from repro_torch.arrays import tensor_from_numpy  # noqa: E402

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=8e-3, atol=1e-3)}
# MiniCPM3's head dims (nope 64 + rope 32, values 64) on a narrow layer
WIDE = MLAConfig(q_lora_rank=48, kv_lora_rank=40, qk_nope_head_dim=64,
                 qk_rope_head_dim=32, v_head_dim=64)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def configs(dtype, mla):
    jcfg = j_get_arch("minicpm3-4b").smoke_config()
    cfg = get_arch("minicpm3-4b").smoke_config()
    if mla == "wide":
        jcfg = dataclasses.replace(jcfg, mla=type(jcfg.mla)(**vars(WIDE)),
                                   head_dim=96)
        cfg = dataclasses.replace(cfg, mla=WIDE, head_dim=96)
    return (dataclasses.replace(jcfg, dtype=dtype, n_layers=1),
            dataclasses.replace(cfg, dtype=dtype, n_layers=1))


@pytest.fixture(scope="module", params=[(d, m) for d in DTYPES
                                        for m in ("smoke", "wide")],
                ids=lambda p: f"{p[1]}-{p[0]}")
def layer(request):
    """One MLA layer of the reference's draws, as jax arrays and as the
    port's ``Block``."""
    dtype, mla = request.param
    jcfg, cfg = configs(dtype, mla)
    tree = j_init(jax.random.PRNGKey(3), jcfg)["layers"]
    jp = {n: a[0] for n, a in tree.items()}
    p = Block({n: tensor_from_numpy(np.asarray(a), "cpu") for n, a in jp.items()})
    return dict(dtype=dtype, jcfg=jcfg, cfg=cfg, jp=jp, p=p)


def draw(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("s,start", [(100, 0), (40, 25)])
def test_mla_attention_matches_the_reference(layer, s, start):
    """Prefill over ``s`` positions from ``start`` (a prompt past one 64-row
    chunk, and positions that do not start at 0): the output and the
    latents the cache keeps."""
    d = layer["cfg"].d_model
    jx, x = draw((2, s, d), layer["dtype"], seed=s)
    pos = np.arange(start, start + s)
    out, (c_kv, k_rope) = mla_attention(x, layer["p"], layer["cfg"],
                                        torch.as_tensor(pos))
    jout, (jc, jk) = j_mla(jx, layer["jp"], layer["jcfg"], jnp.asarray(pos))
    m = layer["cfg"].mla
    assert out.shape == (2, s, d) and out.dtype == x.dtype
    assert c_kv.shape == (2, s, m.kv_lora_rank)
    assert k_rope.shape == (2, s, m.qk_rope_head_dim)
    tol = TOL[layer["dtype"]]
    np.testing.assert_allclose(as_np(out), as_np(jout), **tol)
    np.testing.assert_allclose(as_np(c_kv), as_np(jc), **tol)
    np.testing.assert_allclose(as_np(k_rope), as_np(jk), **tol)


@pytest.mark.parametrize("lens", [57, [13, 60]])
def test_mla_decode_attention_matches_the_reference(layer, lens):
    """One token against cached latents, every sequence at one length or
    each at its own (positions at or past its length masked)."""
    cfg, dtype = layer["cfg"], layer["dtype"]
    m = cfg.mla
    jx, x = draw((2, cfg.d_model), dtype, seed=1)
    jc, c = draw((2, 64, m.kv_lora_rank), dtype, seed=2)
    jk, k = draw((2, 64, m.qk_rope_head_dim), dtype, seed=3)
    position = 56
    got = mla_decode_attention(x, layer["p"], cfg, c, k, torch.as_tensor(lens)
                               if isinstance(lens, list) else lens, position)
    want = j_mla_decode(jx, layer["jp"], layer["jcfg"], jc, jk,
                        jnp.asarray(lens, jnp.int32), jnp.asarray(position))
    assert got.shape == (2, cfg.d_model) and got.dtype == x.dtype
    np.testing.assert_allclose(as_np(got), as_np(want), **TOL[dtype])


def test_decode_ignores_the_cache_past_its_length(layer):
    """What lies at or past ``cache_len`` does not reach the output."""
    cfg, dtype = layer["cfg"], layer["dtype"]
    m = cfg.mla
    _, x = draw((2, cfg.d_model), dtype, seed=4)
    _, c = draw((2, 30, m.kv_lora_rank), dtype, seed=5)
    _, k = draw((2, 30, m.qk_rope_head_dim), dtype, seed=6)
    got = mla_decode_attention(x, layer["p"], cfg, c, k, 20, 19)
    c2, k2 = c.clone(), k.clone()
    c2[:, 20:], k2[:, 20:] = 7.0, -7.0
    assert torch.equal(got, mla_decode_attention(x, layer["p"], cfg, c2, k2,
                                                 20, 19))
