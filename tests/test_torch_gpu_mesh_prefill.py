"""The LMs' prefill over a mesh on the card (marked ``gpu``).

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_mesh_prefill.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture.  One card holds all 8 positions of a tiny mesh as
``[cuda:0] * 8``.  Each smoke config's ``prefill_32k`` step (its length and
batch cut to 128 x 4, as the CPU tests cut them) runs over the mesh:

* in float32 against the CPU port's sharded run (K4's float32 variant on
  the card, its plain version on the CPU) within rtol = atol = 1e-4, the
  LM tests' float32 tolerance;
* in bfloat16 against the unsharded port on the card within a normwise
  relative error of ``NORMWISE`` (the row-parallel sums add float32
  partials in another order, so a bf16 rounding may land one ulp away),
  with the same greedy token per sequence; K4 once a layer at each
  position, every launch on its head slice through TMA as it lies
  (route ``wgmma``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.kernels.flash_attention import flash_kernel as k4  # noqa: E402
from repro_torch.launch.mesh import make_tiny_mesh  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402

pytestmark = pytest.mark.gpu

ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
         "dbrx-132b"]
BATCH, PROMPT, MAX_LEN = 4, 100, 128
NORMWISE = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test runs K4 on the card's "
                    "mesh positions")
    return torch.device("cuda", 0)


def step(monkeypatch, cfg, mesh):
    monkeypatch.setitem(registry.LM_SHAPES, "prefill_32k",
                        (MAX_LEN, BATCH, "prefill"))
    cell = registry.lm_cells(cfg)["prefill_32k"]
    return cell.make_step(Sharder.for_mesh(mesh) if mesh is not None
                          else Sharder(None))


def tokens(cfg):
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)))


@pytest.mark.parametrize("multi", [False, True], ids=["tiny", "tiny_multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_on_the_card_equals_the_cpu(cuda, monkeypatch, arch,
                                                 multi):
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
    model = init_lm_params(cfg, seed=0, device="cpu")
    toks = tokens(cfg)
    want, want_cache = step(monkeypatch, cfg, make_tiny_mesh(
        multi_pod=multi, devices=["cpu"] * 8))(model, toks)
    got, got_cache = step(monkeypatch, cfg, make_tiny_mesh(
        multi_pod=multi, devices=[cuda] * 8))(model.to(cuda), toks.to(cuda))
    assert all(s.device == cuda for s in got.shards)
    np.testing.assert_allclose(got.gather().numpy(), want.gather().numpy(),
                               rtol=1e-4, atol=1e-4)
    for name in ("ckv", "krope") if cfg.is_mla else ("k", "v"):
        np.testing.assert_allclose(got_cache[name].gather().numpy(),
                                   want_cache[name].gather().numpy(),
                                   rtol=1e-4, atol=1e-4)


def normwise(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_in_bf16_equals_the_unsharded_port_on_wgmma(
        cuda, monkeypatch, arch):
    cfg = get_arch(arch).smoke_config()
    model = init_lm_params(cfg, seed=0, device=cuda)
    toks = tokens(cfg).to(cuda)
    want, want_cache = step(monkeypatch, cfg, None)(model, toks)
    mesh = make_tiny_mesh(devices=[cuda] * 8)
    k4.reset_launch_count()
    got, got_cache = step(monkeypatch, cfg, mesh)(model, toks)
    torch.cuda.synchronize()
    assert k4.launch_count() == 8 * cfg.n_layers
    assert k4.launch_count("wgmma") == k4.launch_count()
    last = got.gather(cuda)
    for b in range(BATCH):
        assert normwise(last[b], want[b]) <= NORMWISE
    v = cfg.vocab_size
    assert torch.equal(last[:, :v].argmax(-1), want[:, :v].argmax(-1))
    for name, leaf in got_cache.items():
        if name != "len":
            assert normwise(leaf.gather(cuda), want_cache[name]) <= NORMWISE
