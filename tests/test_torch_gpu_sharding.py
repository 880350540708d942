"""Window sharding and the ring counter on the card (marked ``gpu``).

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_sharding.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture.  One card runs N shards as ``[cuda:0] * N``; a machine
with more cards also runs one shard per card.  K1 and K2 are exact, so
sharded counts equal the unsharded ones bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.distributed import (  # noqa: E402
    make_distributed_window_counter,
)
from repro_torch.core.executor import WindowExecutor  # noqa: E402
from repro_torch.core.sgrapp import run_sgrapp  # noqa: E402
from repro_torch.core.windows import windowize  # noqa: E402
from repro_torch.kernels.butterfly import butterfly_kernel as kk  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    StreamingSGrapp,
    bipartite_pa_stream,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with no "
                    "CPU mode")
    return torch.device("cuda", 0)


def layouts(cuda):
    """Two and three shards on the first card, and one shard per card
    (up to 4) where the machine has more than one."""
    out = [[cuda] * 2, [cuda] * 3]
    n = min(torch.cuda.device_count(), 4)
    if n > 1:
        out.append([torch.device("cuda", k) for k in range(n)])
    return out


def pa_stream(n=20000):
    return bipartite_pa_stream(n, n_unique=n // 10, seed=2)


def test_sharded_pallas_replay_equals_unsharded(cuda):
    s = pa_stream()
    wb = windowize(s.tau, s.edge_i, s.edge_j, 100)
    want = run_sgrapp(wb, 1.02, tier="pallas", device=cuda)
    for devs in layouts(cuda):
        kk.reset_launch_count()
        got = run_sgrapp(wb, 1.02, tier="pallas", devices=devs)
        np.testing.assert_array_equal(got.window_counts, want.window_counts)
        np.testing.assert_array_equal(got.estimates, want.estimates)
        assert kk.launch_count("K1") > 0
        assert kk.launch_count("K1", "wgmma") == kk.launch_count("K1")


def test_sharded_multiset_engine_on_k2_equals_unsharded(cuda):
    s = pa_stream(12000)
    cfg = dict(tier="pallas", dup_policy="multiset", flush_every=8)

    def push(config):
        eng = StreamingSGrapp(100, 1.02, config=config)
        for a in range(0, len(s), 512):
            eng.push(s.tau[a:a + 512], s.edge_i[a:a + 512],
                     s.edge_j[a:a + 512])
        return eng.finalize()

    want = push(EngineConfig(device=cuda, **cfg))
    for devs in layouts(cuda):
        kk.reset_launch_count()
        got = push(EngineConfig(devices=devs, **cfg))
        np.testing.assert_array_equal(got.window_counts, want.window_counts)
        np.testing.assert_array_equal(got.estimates, want.estimates)
        assert kk.launch_count("K2") > 0
        assert kk.launch_count("K2", "wgmma_limbs") == kk.launch_count("K2")


@pytest.mark.parametrize("shape", ((2, 2), (1, 3)))
@pytest.mark.parametrize("half_ring,wire", ((False, None), (True, torch.int8)))
def test_ring_counter_on_the_card_equals_the_executor(cuda, shape, half_ring,
                                                      wire):
    s = pa_stream(6000)
    wb = windowize(s.tau, s.edge_i, s.edge_j, 100)
    n = wb.n_windows - wb.n_windows % shape[0]
    want = WindowExecutor("pallas", device=cuda).window_counts(wb)[:n]
    fn = make_distributed_window_counter(
        wb.n_i, wb.n_j, make_mesh(shape, ("data", "model"),
                                  [cuda] * int(np.prod(shape))),
        half_ring=half_ring, wire_dtype=wire)
    got = fn(wb.edge_i[:n], wb.edge_j[:n], wb.valid[:n])
    assert got.device == cuda
    np.testing.assert_array_equal(got.cpu().numpy(), want)
