"""The LMs' decode over a mesh on the card (marked ``gpu``).

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_mesh_decode.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture.  One card holds all 8 positions of a tiny mesh as
``[cuda:0] * 8``.  Each smoke config's ``prefill_32k`` step fills the cache
over the mesh (its length and batch cut to 128 x 4, as the CPU tests cut
them) and ``decode_32k``'s step runs ``STEPS`` tokens on it, each step fed
the same tokens:

* in float32 against the CPU port's sharded run within rtol = atol = 1e-4,
  the LM tests' float32 tolerance (logits of every step and every cache
  leaf);
* in bfloat16 against the unsharded port on the card within a normwise
  relative error of ``NORMWISE`` (the split softmax and the row-parallel
  sums add float32 partials in another order, so a bf16 rounding may land
  one ulp away), with the same greedy token per sequence.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.launch.mesh import make_tiny_mesh  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402

pytestmark = pytest.mark.gpu

ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
         "dbrx-132b"]
BATCH, PROMPT, MAX_LEN, STEPS = 4, 100, 128, 3
NORMWISE = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test runs the mesh positions "
                    "on the card")
    return torch.device("cuda", 0)


def steps(monkeypatch, cfg, mesh):
    monkeypatch.setitem(registry.LM_SHAPES, "prefill_32k",
                        (MAX_LEN, BATCH, "prefill"))
    monkeypatch.setitem(registry.LM_SHAPES, "decode_32k",
                        (MAX_LEN, BATCH, "decode"))
    cells = registry.lm_cells(cfg)
    shard = Sharder.for_mesh(mesh) if mesh is not None else Sharder(None)
    return (cells["prefill_32k"].make_step(shard),
            cells["decode_32k"].make_step(shard))


def run(monkeypatch, cfg, model, mesh, device, fed=None):
    """Prefill then ``STEPS`` decode steps, fed ``fed`` (or the run's own
    greedy tokens): each step's logits (gathered to ``device``), the tokens
    fed and the final cache (gathered)."""
    pre, dec = steps(monkeypatch, cfg, mesh)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT))).to(device)
    last, cache = pre(model, toks)
    out, used = [], []
    for i in range(STEPS):
        whole = last if mesh is None else last.gather(device)
        t = whole[:, :cfg.vocab_size].argmax(-1) if fed is None else fed[i]
        used.append(t)
        last, cache = dec(model, cache, t.to(device))
        out.append(last if mesh is None else last.gather(device))
    leaves = {k: (v if mesh is None else v.gather(device))
              for k, v in cache.items() if k != "len"}
    return out, used, leaves


@pytest.mark.parametrize("multi", [False, True], ids=["tiny", "tiny_multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_decode_on_the_card_equals_the_cpu(cuda, monkeypatch, arch,
                                                multi):
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
    model = init_lm_params(cfg, seed=0, device="cpu")
    cpu = torch.device("cpu")
    want, fed, want_cache = run(monkeypatch, cfg, model, make_tiny_mesh(
        multi_pod=multi, devices=["cpu"] * 8), cpu)
    got, _, got_cache = run(monkeypatch, cfg, model.to(cuda), make_tiny_mesh(
        multi_pod=multi, devices=[cuda] * 8), cuda, fed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for name, w in want_cache.items():
        np.testing.assert_allclose(got_cache[name].cpu().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-4)


def normwise(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_decode_in_bf16_equals_the_unsharded_port(cuda, monkeypatch,
                                                       arch):
    cfg = get_arch(arch).smoke_config()
    model = init_lm_params(cfg, seed=0, device=cuda)
    want, fed, want_cache = run(monkeypatch, cfg, model, None, cuda)
    got, _, got_cache = run(monkeypatch, cfg, model, make_tiny_mesh(
        devices=[cuda] * 8), cuda, fed)
    v = cfg.vocab_size
    for g, w in zip(got, want):
        for b in range(BATCH):
            assert normwise(g[b], w[b]) <= NORMWISE
        assert torch.equal(g[:, :v].argmax(-1), w[:, :v].argmax(-1))
    for name, w in want_cache.items():
        assert normwise(got_cache[name], w) <= NORMWISE
