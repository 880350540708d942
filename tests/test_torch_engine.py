"""The port's online engine: streaming equals replay, and checkpoints carry
across between the port and the reference.

Inside the port, pushing a stream in micro-batches of any size gives the
replay's estimates bit for bit (one step function, one device).  A schema-v4
``state_dict`` written by either package restores into the other and
continues to the same counts; estimates across packages agree within rtol
1e-6 (float32 ``pow`` may differ in the last ulp between torch and XLA).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.streams as jst  # noqa: E402
from repro.core.sgrapp import run_sgrapp as j_run_sgrapp  # noqa: E402
from repro.streams.config import EngineConfig as JConfig  # noqa: E402
from repro_torch.core.butterfly import count_butterflies_np  # noqa: E402
from repro_torch.core.sgrapp import run_sgrapp, run_sgrapp_x  # noqa: E402
from repro_torch.core.windows import window_bounds  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    StreamingSGrapp,
    dynamic_sgr_stream,
    synthetic_rating_stream,
)

NT_W = 40
CPU = "cpu"
RTOL = 1e-6


def make_stream(n=1500, seed=6):
    return synthetic_rating_stream(n_users=80, n_items=60, n_edges=n,
                                   seed=seed, temporal="uniform",
                                   n_unique=n // 5)


def push(eng, s, mb, start=0, stop=None):
    stop = len(s) if stop is None else stop
    for a in range(start, stop, mb):
        b = min(a + mb, stop)
        eng.push(s.tau[a:b], s.edge_i[a:b], s.edge_j[a:b])
    return eng


def assert_same(res, ref):
    np.testing.assert_array_equal(res.window_counts, ref.window_counts)
    np.testing.assert_array_equal(res.estimates, ref.estimates)
    np.testing.assert_array_equal(res.cum_edges, ref.cum_edges)
    assert np.float32(res.alpha_final) == np.float32(ref.alpha_final)


def cfg(tier, **kw):
    return EngineConfig(tier=tier, device=CPU, **kw)


@pytest.mark.parametrize("tier", ("dense", "pallas"))
@pytest.mark.parametrize("mb", (1, 7, 10**9))
def test_streaming_bit_identical_to_replay(tier, mb):
    s = make_stream()
    ref = run_sgrapp(s.windowize(NT_W), 0.95, tier=tier, device=CPU)
    eng = StreamingSGrapp(NT_W, 0.95, config=cfg(tier, flush_every=3))
    assert_same(push(eng, s, mb).finalize(), ref)


@pytest.mark.parametrize("sync", (False, True))
def test_streaming_sgrapp_x_bit_identical_to_replay(sync):
    s = make_stream()
    bounds = window_bounds(s.tau, NT_W)
    truths = np.array([count_butterflies_np(s.edges()[:e])
                       for _, e in bounds[:6]], dtype=float)
    ref = run_sgrapp_x(s.windowize(NT_W), 1.1, truths, tier="pallas",
                       device=CPU)
    eng = StreamingSGrapp(NT_W, 1.1, truths=truths,
                          config=cfg("pallas", flush_every=2,
                                     sync_dispatch=sync))
    res = push(eng, s, 13).finalize()
    assert_same(res, ref)
    assert res.alpha_final != 1.1


def test_engine_equals_reference_engine():
    s = make_stream()
    want = push(jst.StreamingSGrapp(NT_W, 0.95, config=JConfig(
        tier="dense", flush_every=4)), s, 25).finalize()
    got = push(StreamingSGrapp(NT_W, 0.95, config=cfg(
        "pallas", flush_every=4)), s, 25).finalize()
    np.testing.assert_array_equal(got.window_counts, want.window_counts)
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)
    assert got.alpha_final == pytest.approx(want.alpha_final)


@pytest.mark.parametrize("cut", (333, 700))
def test_reference_state_dict_restores_into_port(cut):
    s = make_stream()
    jeng = push(jst.StreamingSGrapp(NT_W, 0.95, config=JConfig(
        tier="pallas", flush_every=3)), s, 11, stop=cut)
    sd = jeng.state_dict()
    port = StreamingSGrapp.from_state_dict(sd, device=CPU)
    assert port.tier == "pallas" and port.config.flush_every == 3
    got = push(port, s, 11, start=cut).finalize()
    want = push(jeng, s, 11, start=cut).finalize()
    np.testing.assert_array_equal(got.window_counts, want.window_counts)
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)
    # explicit restore into a constructed engine continues the same way
    eng = StreamingSGrapp(NT_W, 0.95, config=cfg("dense", flush_every=3))
    again = push(eng.restore(sd), s, 11, start=cut).finalize()
    assert_same(again, got)


@pytest.mark.parametrize("cut", (333, 700))
def test_port_state_dict_restores_into_reference(cut):
    s = make_stream()
    eng = push(StreamingSGrapp(NT_W, 0.95, config=cfg(
        "pallas", flush_every=3)), s, 11, stop=cut)
    sd = eng.state_dict()
    ref_full = j_run_sgrapp(s.windowize(NT_W), 0.95, tier="dense")
    jeng = jst.StreamingSGrapp.from_state_dict(sd)
    assert jeng.tier == "pallas"
    got = push(jeng, s, 11, start=cut).finalize()
    np.testing.assert_array_equal(got.window_counts, ref_full.window_counts)
    np.testing.assert_allclose(got.estimates, ref_full.estimates, rtol=RTOL)
    jeng2 = jst.StreamingSGrapp(NT_W, 0.95, config=JConfig(tier="dense"))
    jeng2.restore(sd)
    np.testing.assert_array_equal(
        push(jeng2, s, 11, start=cut).finalize().window_counts,
        ref_full.window_counts)


def test_state_dict_schema_equals_reference():
    s = make_stream()
    got = push(StreamingSGrapp(NT_W, 0.9, config=cfg("dense")), s, 50,
               stop=400).state_dict()
    want = push(jst.StreamingSGrapp(NT_W, 0.9, config=JConfig(tier="dense")),
                s, 50, stop=400).state_dict()
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k != "estimates":
            np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_allclose(got["estimates"], want["estimates"], rtol=RTOL)


def test_restore_rejects_other_versions_and_drift():
    s = make_stream()
    sd = push(StreamingSGrapp(NT_W, 0.9, config=cfg("dense")), s, 50,
              stop=400).state_dict()
    eng = StreamingSGrapp(NT_W, 0.9, config=cfg("dense"))
    with pytest.raises(ValueError, match="version 3"):
        eng.restore({**sd, "version": np.int64(3)})
    with pytest.raises(ValueError, match="unknown"):
        eng.restore({**sd, "extra": np.int64(0)})
    with pytest.raises(ValueError, match="nt_w"):
        StreamingSGrapp(NT_W + 1, 0.9, config=cfg("dense")).restore(sd)


def test_config_json_equals_reference():
    kw = dict(tier="pallas", flush_every=5, align=32, seed=3, tol=0.1)
    assert EngineConfig(**kw).to_json() == JConfig(**kw).to_json()
    back = EngineConfig.from_json(JConfig(**kw).to_json(), device=CPU)
    assert back.tier == "pallas" and back.device == CPU


@pytest.mark.parametrize("tier", ("sampled",))
def test_unported_tier_parses_then_raises(tier):
    """The reference's ``sampled`` config parses, and the engine built from
    it runs now; only a delete op raises, as the reference's does."""
    c = EngineConfig.from_json(JConfig(tier=tier).to_json(), device=CPU)
    eng = StreamingSGrapp(NT_W, 0.9, config=c)
    assert eng.tier == "sampled"
    with pytest.raises(NotImplementedError, match="delete"):
        eng.push([0.0], [1], [1], op=[1])
    assert eng.n_windows == 0 and eng.cum_sgrs == 0


def test_legacy_kwargs_shim():
    with pytest.warns(DeprecationWarning):
        eng = StreamingSGrapp(NT_W, 0.9, tier="pallas", device=CPU)
    assert eng.tier == "pallas"
    with pytest.raises(ValueError, match="conflicts"):
        StreamingSGrapp(NT_W, 0.9, config=cfg("dense"), flush_every=2)


def test_deletes_distinct_policy_equal_reference_engine():
    tau, ei, ej, op = dynamic_sgr_stream(900, 6, delete_frac=0.15,
                                         dup_frac=0.2, seed=5)
    got_eng = StreamingSGrapp(6, 1.0, config=cfg("pallas", flush_every=2))
    want_eng = jst.StreamingSGrapp(6, 1.0, config=JConfig(tier="dense",
                                                          flush_every=2))
    for a in range(0, len(tau), 17):
        sl = slice(a, a + 17)
        got_eng.push(tau[sl], ei[sl], ej[sl], op=op[sl])
        want_eng.push(tau[sl], ei[sl], ej[sl], op=op[sl])
    got, want = got_eng.finalize(), want_eng.finalize()
    np.testing.assert_array_equal(got.window_counts, want.window_counts)
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)


def test_push_after_finalize_and_bad_order_raise():
    eng = StreamingSGrapp(NT_W, 0.9, config=cfg("dense"))
    eng.push([1.0, 2.0], [0, 1], [0, 1])
    with pytest.raises(ValueError, match="non-decreasing"):
        eng.push(0.5, 0, 0)
    eng.finalize()
    with pytest.raises(RuntimeError, match="finalize"):
        eng.push(3.0, 0, 0)


def push_in_batches(eng, s, mb):
    return push(eng, s, mb).finalize()


@pytest.mark.parametrize("devices", [None, [CPU] * 2])
def test_flush_reuses_compiled_buckets(devices):
    """``tests/test_streaming_engine.py``'s test on the port: after the
    first flush has met this stream's bucket shapes, further flushes (and a
    second engine on the same stream shape) add no new counter, sharded or
    not."""
    from repro_torch.core.executor import compiled_bucket_cache_info

    s = make_stream()
    eng = StreamingSGrapp(NT_W, 0.95, config=cfg("dense", flush_every=2,
                                                 devices=devices))
    eng.push(s.tau[:750], s.edge_i[:750], s.edge_j[:750])
    eng.flush()
    before = compiled_bucket_cache_info()
    eng.push(s.tau[750:], s.edge_i[750:], s.edge_j[750:])
    eng.finalize()
    eng2 = StreamingSGrapp(NT_W, 0.95, config=cfg("dense", flush_every=4,
                                                  devices=devices))
    push_in_batches(eng2, s, 50)
    assert compiled_bucket_cache_info() == before


def test_warmup_leaves_the_compiled_buckets_flat():
    """The warmup half of ``tests/test_streaming_engine.py``'s
    ``test_shared_executor_across_engines``: an engine warmed on the rungs
    a probe planned adds no counter while it streams, and equals the
    probe."""
    from repro_torch.core.executor import compiled_bucket_cache_info

    s = make_stream()
    probe = StreamingSGrapp(NT_W, 0.95, config=cfg("numpy", flush_every=3))
    rungs = set()
    orig = probe.executor.window_counts_submit

    def recording(batch):
        rungs.update((b.cap_e, b.cap_i, b.cap_j)
                     for b in probe.executor.plan(batch))
        return orig(batch)

    probe.executor.window_counts_submit = recording
    ref = push_in_batches(probe, s, 33)
    assert rungs
    eng = StreamingSGrapp(NT_W, 0.95, config=cfg(
        "dense", flush_every=3, warmup=tuple(sorted(rungs))))
    after_warmup = compiled_bucket_cache_info()
    res = push_in_batches(eng, s, 33)
    assert compiled_bucket_cache_info() == after_warmup
    assert_same(res, ref)
