"""The executor entries, the multi-tenant engine, its serving front end and
the sampled tier on the card against the CPU port (marked ``gpu``).

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_entries.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture.  The sampled tier's coins are integer threefry and its
ladder reads a host table, so the card equals the CPU bit for bit; counts
are exact; estimates agree within rtol 1e-6 (float32 ``pow`` on the card
and on the CPU may differ in the last ulp).
"""
import asyncio
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fleet  # noqa: E402
from repro_torch.core.butterfly import count_butterflies_np  # noqa: E402
from repro_torch.core.executor import WindowExecutor  # noqa: E402
from repro_torch.core.windows import windowize  # noqa: E402
from repro_torch.kernels.butterfly import butterfly_kernel as kk  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    MultiStreamSGrapp,
    StreamingSGrapp,
    bipartite_pa_stream,
    synthetic_rating_stream,
)
from repro_torch.streams.server import StreamServer  # noqa: E402
from repro_torch.streams.wire import (  # noqa: E402
    normalize_records,
    records_to_json,
)

pytestmark = pytest.mark.gpu
CPU = "cpu"
NT_W = 40


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 are CUDA kernels with no "
                    "CPU mode, and the card's coins are held to the CPU's")
    return torch.device("cuda")


def pa_batch(n=20000, nt_w=100):
    s = bipartite_pa_stream(n, n_unique=n // 10, seed=2)
    return windowize(s.tau, s.edge_i, s.edge_j, nt_w)


def test_coins_and_ladder_on_the_card_equal_the_cpu(cuda):
    rng = np.random.default_rng(0)
    ei = torch.from_numpy(rng.integers(0, 2**31, 50000))
    ej = torch.from_numpy(rng.integers(0, 2**31, 50000))
    key = fleet.window_keys(7, 123, 3, CPU)
    u_cpu = fleet.edge_uniforms(key, ei, ej)
    u_gpu = fleet.edge_uniforms(fleet.window_keys(7, 123, 3, cuda),
                                ei.to(cuda), ej.to(cuda))
    assert torch.equal(u_gpu.cpu(), u_cpu)
    with pytest.raises(ValueError, match="one device"):
        fleet.edge_uniforms(key, ei.to(cuda), ej.to(cuda))
    t = torch.from_numpy(rng.random(100000).astype(np.float32))
    for gamma in (0.5, 0.7, 0.99):
        k_cpu, p_cpu = fleet.gamma_ladder(t, gamma)
        k_gpu, p_gpu = fleet.gamma_ladder(t.to(cuda), gamma)
        assert torch.equal(k_gpu.cpu(), k_cpu)
        assert torch.equal(p_gpu.cpu(), p_cpu)


@pytest.mark.parametrize("capacity", (64, 300))
def test_sampled_counts_on_the_card_equal_the_cpu(cuda, capacity):
    batch = pa_batch()
    got = WindowExecutor("sampled", capacity=capacity, seed=1,
                         device=cuda).window_counts(batch)
    want = WindowExecutor("sampled", capacity=capacity, seed=1,
                          device=CPU).window_counts(batch)
    np.testing.assert_array_equal(got, want)


def test_reservoir_on_the_card_equals_the_cpu(cuda):
    s = bipartite_pa_stream(30000, n_unique=5000, seed=4)
    est_g, res_g = fleet.reservoir_run(s.edge_i, s.edge_j, capacity=512,
                                       chunk=2048, device=cuda)
    est_c, res_c = fleet.reservoir_run(s.edge_i, s.edge_j, capacity=512,
                                       chunk=2048, device=CPU)
    assert est_g == est_c
    for name in ("edge_i", "edge_j", "u", "valid", "k"):
        assert torch.equal(getattr(res_g, name).cpu(), getattr(res_c, name))


def test_count_edges_on_pallas_launches_k1_as_the_stack_lies(cuda):
    rng = np.random.default_rng(1)
    ex = WindowExecutor("pallas", device=cuda)
    kk.reset_launch_count()
    for _ in range(5):
        ei = rng.integers(-2**40, 2**40, 60)[rng.integers(0, 60, 900)]
        ej = rng.integers(0, 2**50, 45)[rng.integers(0, 45, 900)]
        _, ci = np.unique(ei, return_inverse=True)
        _, cj = np.unique(ej, return_inverse=True)
        assert ex.count_edges(ei, ej) == count_butterflies_np(
            np.stack([ci, cj], 1))
    assert kk.launch_count("K1") == 5
    assert kk.launch_count("K1", "wgmma") == 5


def test_sliding_run_and_decrement_recount_on_pallas(cuda):
    batch = pa_batch()
    ex = WindowExecutor("pallas", device=cuda)
    dense = WindowExecutor("dense", device=CPU)
    for span in (1, 4):
        np.testing.assert_array_equal(
            ex.run(batch, mode="sliding", span=span).counts,
            dense.run(batch, mode="sliding", span=span).counts)
    rng = np.random.default_rng(2)
    per_edges, per_del, prior, want = [], [], [], []
    for _ in range(6):
        e = np.unique(rng.integers(0, 30, (200, 2)), axis=0)
        d = e[rng.choice(len(e), len(e) // 3, replace=False)]
        keep = ~np.isin(e[:, 0] << 32 | e[:, 1], d[:, 0] << 32 | d[:, 1])
        per_edges.append(e)
        per_del.append(d)
        prior.append(count_butterflies_np(e))
        want.append(count_butterflies_np(e[keep]))
    kk.reset_launch_count()
    got = ex.decrement_window_counts(per_edges, per_del,
                                     np.array(prior, float), delta_frac=0.0)
    np.testing.assert_array_equal(got, want)
    assert kk.launch_count("K1") >= 1


@pytest.mark.parametrize("policy,kernel", (("distinct", "K1"),
                                           ("multiset", "K2")))
def test_multistream_on_pallas_equals_dedicated_engines(cuda, policy,
                                                        kernel):
    streams = [synthetic_rating_stream(n_users=80, n_items=60, n_edges=n,
                                       seed=seed, temporal="uniform",
                                       n_unique=n // 5)
               for n, seed in ((1500, 6), (900, 9), (1200, 12))]
    card = EngineConfig(tier="pallas", dup_policy=policy, flush_every=3,
                        device=cuda)
    kk.reset_launch_count()
    fleet_eng = MultiStreamSGrapp(len(streams), NT_W, 0.95, config=card)
    for a in range(0, 1500, 33):
        for sid, s in enumerate(streams):
            if a < len(s):
                fleet_eng.push(sid, s.tau[a:a + 33], s.edge_i[a:a + 33],
                               s.edge_j[a:a + 33])
    sd = fleet_eng.state_dict()
    res = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                            config=card).restore(sd).finalize()
    assert kk.launch_count(kernel) > 0
    for sid, s in enumerate(streams):
        for dev in (cuda, CPU):
            eng = StreamingSGrapp(NT_W, 0.95, config=card.replace(device=dev))
            for a in range(0, len(s), 33):
                eng.push(s.tau[a:a + 33], s.edge_i[a:a + 33],
                         s.edge_j[a:a + 33])
            ref = eng.finalize()
            np.testing.assert_array_equal(res[sid].window_counts,
                                          ref.window_counts)
            if dev is cuda:
                np.testing.assert_array_equal(res[sid].estimates,
                                              ref.estimates)
            else:
                np.testing.assert_allclose(res[sid].estimates, ref.estimates,
                                           rtol=1e-6)


@pytest.mark.parametrize("policy,kernel", (("distinct", "K1"),
                                           ("multiset", "K2")))
def test_server_on_the_card_equals_a_dedicated_fleet(cuda, tmp_path, policy,
                                                     kernel):
    """Three tenants over TCP into an in-process server on the card (WAL,
    latency budget), stopped and restarted from its checkpoint halfway:
    every tenant equals a dedicated fleet on the card bit for bit, and the
    server's engine launched the policy's kernel."""
    streams = [synthetic_rating_stream(n_users=80, n_items=60, n_edges=1200,
                                       seed=seed, temporal="uniform",
                                       n_unique=240) for seed in (6, 9, 12)]
    card = EngineConfig(tier="pallas", dup_policy=policy, device=cuda)
    kw = dict(nt_w=NT_W, alpha0=0.95, tenants={f"t{s}": s for s in range(3)},
              config=card, flush_ms=1.0, latency_budget_ms=5.0,
              checkpoint_dir=str(tmp_path / "ckpt"))

    async def leg(lo, hi, finalize):
        server = await StreamServer(**kw).start()
        finals = []
        for sid, s in enumerate(streams):
            r, w = await asyncio.open_connection(server.host, server.port)

            async def call(msg):
                w.write((json.dumps(msg) + "\n").encode())
                await w.drain()
                return json.loads(await r.readline())

            assert (await call({"type": "hello", "token": f"t{sid}"}))[
                "type"] == "hello_ok"
            for a in range(lo, hi, 100):
                rec = records_to_json(normalize_records(
                    s.tau[a:a + 100], s.edge_i[a:a + 100],
                    s.edge_j[a:a + 100]))
                assert (await call({"type": "push", "records": rec}))[
                    "type"] == "ack"
            if finalize:
                finals.append(await call({"type": "finalize"}))
            w.close()
        await server.stop()
        return finals

    kk.reset_launch_count()
    asyncio.run(leg(0, 600, False))
    finals = asyncio.run(leg(600, 1200, True))
    assert kk.launch_count(kernel) > 0
    fleet_eng = MultiStreamSGrapp(3, NT_W, 0.95, config=card)
    for sid, s in enumerate(streams):
        fleet_eng.push(sid, s.tau, s.edge_i, s.edge_j)
    for msg, ref in zip(finals, fleet_eng.finalize()):
        np.testing.assert_array_equal(msg["counts"], ref.window_counts)
        np.testing.assert_array_equal(
            np.asarray(msg["estimates"], np.float32), ref.estimates)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b", "dbrx-132b",
                                  "minicpm3-4b"])
def test_moe_and_mla_served_on_the_card_equal_the_cpu(cuda, arch,
                                                      monkeypatch):
    """The MoE and MLA smoke configs in float32 through ``launch.serve``:
    the card (K4 in every prefill layer) against the CPU path (its plain
    version) on the same weights: logits within rtol = atol = 1e-4, greedy
    tokens equal, and every MoE dispatch's gate indices and kept choices
    equal."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_kernel as k4
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.models.transformer import moe as moe_mod

    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
    model = init_lm_params(cfg, seed=0, device=CPU)
    prompts = serve.make_prompts(cfg, 2, 150, seed=0)
    routes = []
    route = moe_mod.moe_route

    def recording(*args, **kw):
        r = route(*args, **kw)
        routes.append((r.gate_idx.cpu(), r.keep.cpu()))
        return r

    monkeypatch.setattr(moe_mod, "moe_route", recording)
    want = serve.serve(model, cfg, prompts, 6)
    on_cpu, routes[:] = list(routes), []
    k4.reset_launch_count()
    got = serve.serve(model.to(cuda), cfg, prompts, 6)
    assert k4.launch_count() == cfg.n_layers == k4.launch_count("simt")
    torch.testing.assert_close(got.prefill_logits.cpu(), want.prefill_logits,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.last_logits.cpu(), want.last_logits,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert len(routes) == len(on_cpu) == (
        0 if cfg.moe is None else cfg.n_layers * 6)
    for (gi, kg), (ci, kc) in zip(routes, on_cpu):
        assert torch.equal(gi, ci) and torch.equal(kg, kc)
