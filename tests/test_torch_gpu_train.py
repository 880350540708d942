"""LM training on the card (marked ``gpu``): chip_smoke's phase 20 (a) and
(d) at a small size.

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_train.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture (K4 is a CUDA kernel with no CPU mode).  The tolerances
are chip_smoke's: the loss within rtol 1e-4 and every gradient leaf within
``1e-4 * max|g_cpu| + 1e-6`` of the CPU port in float32 at each of 3
AdamW steps, each step started on the card from the CPU's state; after
each step every parameter within ``2 * lr`` and within rtol 1e-5, atol
1e-6 except where its CPU gradient entry is at most ``2e-3 * max|g_cpu|``
of its leaf (Adam's step moves by up to about ``2 * lr * gap / |g|``: at
lr 3e-4 a gradient gap of ``3e-6 * max|g|`` reaches atol 1e-6 only below
``1.8e-3 * max|g|``); the attention's
bf16 gradients within one bf16 rounding of autograd through K4's plain
version (``|d| <= 2**-7 |g| + 2**-10 max|g|``).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.registry import lm_cells  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.kernels.flash_attention import flash_kernel as k4  # noqa: E402
from repro_torch.kernels.flash_attention.flash_kernel import (  # noqa: E402
    flash_attention_plain,
)
from repro_torch.models.transformer import init_lm_params, lm_loss  # noqa: E402
from repro_torch.models.transformer.attention import (  # noqa: E402
    attention_scale,
    gqa_attention_chunked,
)
from repro_torch.train import AdamWState, TrainState, adamw_init  # noqa: E402

pytestmark = pytest.mark.gpu

ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
         "dbrx-132b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


def grads_of(model, batch, cfg, n_micro=1):
    """The loss and gradients as the train step takes them: the float32
    mean over ``n_micro`` microbatches of rows (MoE capacity is per
    microbatch)."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, grads = 0.0, None
    for mb in zip(*(v.chunk(n_micro) for v in batch.values())):
        l_mb = lm_loss(model, dict(zip(batch, mb)), cfg)
        g_mb = torch.autograd.grad(l_mb, list(named.values()))
        loss += float(l_mb.detach()) / n_micro
        grads = [g.float() for g in g_mb] if grads is None else \
            [acc + g.float() for acc, g in zip(grads, g_mb)]
    return loss, {n: g / n_micro for n, g in zip(named, grads)}


def tree_to(x, device):
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    return x.to(device, copy=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step_on_the_card_equals_the_cpu(cuda, arch):
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
    cpu = init_lm_params(cfg, seed=1, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 81))
    b_cpu = {"tokens": torch.as_tensor(toks[:, :-1]),
             "labels": torch.as_tensor(toks[:, 1:])}
    b_card = {k: v.to(cuda) for k, v in b_cpu.items()}
    step = lm_cells(cfg, n_microbatches=8)["train_4k"].make_step(Sharder(None))
    s_cpu = TrainState(cpu, adamw_init(cpu), 0)
    for _ in range(3):
        # each step starts the card from the CPU's state
        card = copy.deepcopy(s_cpu.params).to(cuda)
        s_card = TrainState(card, AdamWState(*(
            tree_to(x, cuda) for x in (s_cpu.opt.step, s_cpu.opt.m,
                                       s_cpu.opt.v))), 0)
        l_cpu, g_cpu = grads_of(s_cpu.params, b_cpu, cfg, 8)
        k4.reset_launch_count()
        l_card, g_card = grads_of(card, b_card, cfg, 8)
        assert k4.launch_count() == 8 * 2 * cfg.n_layers  # and recompute
        assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
        for name, g in g_cpu.items():
            gap = float((g_card[name].cpu() - g).abs().max())
            assert gap <= 1e-4 * float(g.abs().max()) + 1e-6, name
        s_cpu, m_cpu = step(s_cpu, b_cpu)
        s_card, m_card = step(s_card, b_card)
        assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) \
            <= 1e-4 * abs(float(m_cpu["loss"]))
        p_card = dict(s_card.params.named_parameters())
        for name, p in s_cpu.params.named_parameters():
            gap = (p_card[name].detach().cpu() - p.detach()).abs()
            assert float(gap.max()) <= 2 * 3e-4, name
            # rtol 1e-5 may miss only where the gradient entry is small
            # enough for Adam to turn the gradients' rounding gap into a
            # step gap of atol 1e-6 (chip_smoke's ADAM_FLOOR)
            off = gap > 1e-6 + 1e-5 * p.detach().abs()
            g = g_cpu[name].abs()
            assert bool((g[off] <= 2e-3 * g.max()).all()), name


@pytest.mark.parametrize("h,hkv,hd,hd_v", [(24, 8, 128, 128), (8, 8, 96, 64)])
def test_attention_backward_matches_autograd_through_the_plain_version(
        cuda, h, hkv, hd, hd_v):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
               for s in ((1, 640, h, hd), (1, 640, hkv, hd), (1, 640, hkv, hd_v)))
    d_out = torch.randn((1, 640, h, hd_v), generator=g,
                        device=cuda).to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    k4.reset_launch_count()
    got = torch.autograd.grad(gqa_attention_chunked(
        *leaves, chunk_q=256, chunk_k=256), leaves, d_out)
    assert k4.launch_count("wgmma") == 1
    want = torch.autograd.grad(flash_attention_plain(
        *leaves, block_q=256, block_k=256, scale=attention_scale(hd)),
        leaves, d_out)
    for a, w in zip(got, want):
        top = float(w.float().abs().max())
        assert bool(((a.float() - w.float()).abs()
                     <= 2.0**-7 * w.float().abs() + 2.0**-10 * top).all())
