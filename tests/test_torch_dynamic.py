"""The port's online engine on multiset and dynamic streams, and its host
oracle, against the JAX package on the CPU.

Both packages get the same seeded streams.  Counts are exact integers here
(every partial sum stays below 2**24), so they must be equal; estimates
across packages agree within rtol 1e-6 (float32 ``pow`` may differ in the
last ulp between torch and XLA), and inside the port streaming equals
replay bit for bit.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.streams as jst  # noqa: E402
from repro.streams.config import EngineConfig as JConfig  # noqa: E402
from repro.streams.oracle import (  # noqa: E402
    oracle_window_counts as j_oracle_counts,
    replay_dynamic as j_replay,
)
from repro_torch.core.sgrapp import run_sgrapp  # noqa: E402
from repro_torch.core.windows import pack_windows  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    StreamingSGrapp,
    dynamic_sgr_stream,
    oracle_window_counts,
    replay_dynamic,
)
from repro_torch.streams.engine import resolve_pending_window  # noqa: E402

NT_W = 10
CPU = "cpu"
RTOL = 1e-6
TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto")


def dyn(seed, n=900, nt_w=NT_W, **kw):
    kw.setdefault("delete_frac", 0.15)
    kw.setdefault("dup_frac", 0.25)
    kw.setdefault("n_i", 12)
    kw.setdefault("n_j", 10)
    return dynamic_sgr_stream(n, nt_w, seed=seed, **kw)


def push(eng, t, i, j, o, mb):
    for a in range(0, t.size, mb):
        sl = slice(a, a + mb)
        eng.push(t[sl], i[sl], j[sl], op=None if o is None else o[sl])
    return eng


def cfg(tier, policy, **kw):
    return EngineConfig(tier=tier, dup_policy=policy, device=CPU, **kw)


@pytest.mark.parametrize("seed", (1, 2))
@pytest.mark.parametrize("missing", ("raise", "ignore"))
def test_replay_dynamic_equals_reference_oracle(seed, missing):
    t, i, j, o = dyn(seed)
    if missing == "ignore":                  # add deletes of absent edges
        o = o.copy()
        o[::37] = 1
    got = replay_dynamic(t, i, j, o, nt_w=NT_W, on_missing_delete=missing)
    want = j_replay(t, i, j, o, nt_w=NT_W, on_missing_delete=missing)
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.edges, w.edges)
        np.testing.assert_array_equal(g.mult, w.mult)
        assert (g.n_sgrs, g.end_tau) == (w.n_sgrs, w.end_tau)
    for policy in ("distinct", "multiset"):
        np.testing.assert_array_equal(oracle_window_counts(got, policy),
                                      j_oracle_counts(want, policy))


def test_replay_dynamic_raises_as_the_reference():
    t, i, j, o = dyn(3)
    o = o.copy()
    o[0] = 1
    with pytest.raises(ValueError, match="absent"):
        replay_dynamic(t, i, j, o, nt_w=NT_W)
    with pytest.raises(ValueError, match="non-decreasing"):
        replay_dynamic(t[::-1], i, j, None, nt_w=NT_W)


@pytest.mark.parametrize("policy", ("distinct", "multiset"))
def test_resolve_pending_window_equals_reference(policy):
    from repro.streams.engine import resolve_pending_window as j_resolve

    t, i, j, o = dyn(4, n=60)
    for ops in (None, o):
        got = resolve_pending_window(i, j, ops, policy)
        want = j_resolve(i, j, ops, policy)
        np.testing.assert_array_equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("policy", ("distinct", "multiset"))
def test_engine_matches_oracle_every_tier(tier, policy):
    t, i, j, o = dyn(5)
    oracle = replay_dynamic(t, i, j, o, nt_w=NT_W)
    eng = StreamingSGrapp(NT_W, 0.95, config=cfg(tier, policy, flush_every=4))
    res = push(eng, t, i, j, o, 23).finalize()
    np.testing.assert_array_equal(res.window_counts,
                                  oracle_window_counts(oracle, policy))
    np.testing.assert_array_equal(res.cum_edges,
                                  np.cumsum([w.n_sgrs for w in oracle]))
    assert res.window_counts.max() > 0


@pytest.mark.parametrize("tier", ("dense", "pallas", "sparse"))
@pytest.mark.parametrize("deletes", (False, True))
def test_multiset_engine_equals_reference_engine(tier, deletes):
    t, i, j, o = dyn(6, delete_frac=0.15 if deletes else 0.0, dup_frac=0.3)
    o = o if deletes else None
    got_eng = StreamingSGrapp(NT_W, 1.0, config=cfg(tier, "multiset",
                                                    flush_every=3))
    want_eng = jst.StreamingSGrapp(NT_W, 1.0, config=JConfig(
        tier="dense", dup_policy="multiset", flush_every=3))
    push(got_eng, t, i, j, o, 17)
    push(want_eng, t, i, j, o, 17)
    got, want = got_eng.finalize(), want_eng.finalize()
    np.testing.assert_array_equal(got.window_counts, want.window_counts)
    np.testing.assert_array_equal(got.cum_edges, want.cum_edges)
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)
    # multiset weights show: some window counts more than its edge set does
    distinct = jst.StreamingSGrapp(NT_W, 1.0, config=JConfig(tier="dense",
                                                             flush_every=3))
    push(distinct, t, i, j, o, 17)
    assert (got.window_counts > distinct.finalize().window_counts).any()


def replay_of(t, i, j, o, policy):
    """The stream's windows packed once, as a whole-stream replay."""
    wins = replay_dynamic(t, i, j, o, nt_w=NT_W)
    n_sgrs = np.array([w.n_sgrs for w in wins])
    kw = dict(n_sgrs=n_sgrs, cum_sgrs=np.cumsum(n_sgrs),
              window_end_tau=np.array([w.end_tau for w in wins]), align=64)
    if policy == "multiset":
        kw.update(dedupe=False, per_window_mult=[w.mult for w in wins])
    return pack_windows([w.edges for w in wins], **kw)


@pytest.mark.parametrize("tier", ("dense", "pallas"))
@pytest.mark.parametrize("mb", (1, 7, 10**9))
def test_multiset_streaming_bit_identical_to_replay(tier, mb):
    t, i, j, o = dyn(7, dup_frac=0.4)
    ref = run_sgrapp(replay_of(t, i, j, o, "multiset"), 0.95, tier=tier,
                     device=CPU)
    eng = StreamingSGrapp(NT_W, 0.95, config=cfg(tier, "multiset",
                                                 flush_every=3))
    res = push(eng, t, i, j, o, mb).finalize()
    np.testing.assert_array_equal(res.window_counts, ref.window_counts)
    np.testing.assert_array_equal(res.estimates, ref.estimates)
    np.testing.assert_array_equal(res.cum_edges, ref.cum_edges)


@pytest.mark.parametrize("direction", ("port_to_reference",
                                       "reference_to_port"))
def test_multiset_state_dict_restores_both_ways(direction):
    t, i, j, o = dyn(8)
    half = t.size // 2
    port_cfg = cfg("pallas", "multiset", flush_every=2)
    ref_cfg = JConfig(tier="dense", dup_policy="multiset", flush_every=2)
    if direction == "port_to_reference":
        first = StreamingSGrapp(NT_W, 1.05, config=port_cfg)
        second = jst.StreamingSGrapp.from_state_dict
    else:
        first = jst.StreamingSGrapp(NT_W, 1.05, config=ref_cfg)
        second = StreamingSGrapp.from_state_dict
    for a in range(0, half, 11):
        b = min(a + 11, half)
        first.push(t[a:b], i[a:b], j[a:b], op=o[a:b])
    sd = first.state_dict()
    kw = {"device": CPU} if direction == "reference_to_port" else {}
    resumed = second(sd, **kw)
    assert resumed.config.dup_policy == "multiset"
    for a in range(half, t.size, 11):
        resumed.push(t[a:a + 11], i[a:a + 11], j[a:a + 11], op=o[a:a + 11])
    got = resumed.finalize()
    straight = StreamingSGrapp(NT_W, 1.05, config=port_cfg)
    want = push(straight, t, i, j, o, 11).finalize()
    np.testing.assert_array_equal(got.window_counts, want.window_counts)
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)


def test_multiset_sampled_still_refused():
    with pytest.raises(NotImplementedError, match="sampled"):
        EngineConfig(tier="sampled", dup_policy="multiset", device=CPU)


def test_multiset_warmup_runs_the_weighted_counters():
    eng = StreamingSGrapp(NT_W, 1.0, config=cfg(
        "pallas", "multiset", warmup=((128, 64, 64),)))
    assert eng.dup_policy == "multiset"
    assert eng.executor.chunks_dispatched == 1
