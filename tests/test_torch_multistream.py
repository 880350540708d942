"""The port's multi-tenant engine ``MultiStreamSGrapp``.

Every tenant of a fleet equals a dedicated ``StreamingSGrapp`` on the same
stream bit for bit (same windowizer, packer, counts and scalar estimator
step), under both duplicate policies and across a ``state_dict`` /
``restore``; against the reference's ``MultiStreamSGrapp`` counts are exact
and estimates agree within rtol 1e-6 (float32 ``pow`` may differ in the
last ulp between torch and XLA).  The reference's edge cases from
``tests/test_multistream.py`` follow, then the v1-v4 fleet checkpoints and
``estimator_step_batched`` against the scalar step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.streams as jst  # noqa: E402
from repro.streams.config import EngineConfig as JConfig  # noqa: E402
from repro_torch.core.butterfly import count_butterflies_np  # noqa: E402
from repro_torch.core.executor import TIERS, WindowExecutor  # noqa: E402
from repro_torch.core.sgrapp import (  # noqa: E402
    estimator_init,
    estimator_step,
    estimator_step_batched,
)
from repro_torch.core.windows import window_bounds  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    MultiStreamSGrapp,
    StreamingSGrapp,
    synthetic_rating_stream,
)

NT_W = 40
CPU = "cpu"
RTOL = 1e-6
# the keys each schema version lacks (v2 added buf_op, v3 res_seed, v4
# config and alpha0)
LACKS = {1: ("buf_op", "res_seed", "config", "alpha0"),
         2: ("res_seed", "config", "alpha0"), 3: ("config", "alpha0"), 4: ()}


def make_stream(n=1200, seed=6, temporal="uniform"):
    return synthetic_rating_stream(n_users=80, n_items=60, n_edges=n,
                                   seed=seed, temporal=temporal,
                                   n_unique=max(2, n // 5))


def make_fleet_streams():
    """Four heterogeneous tenants, one too short to fill a window."""
    return [
        make_stream(n=1200, seed=6, temporal="uniform"),
        make_stream(n=700, seed=9, temporal="bursty"),
        make_stream(n=1500, seed=12, temporal="wave"),
        make_stream(n=60, seed=15),
    ]


def cfg(tier="dense", **kw):
    return EngineConfig(tier=tier, device=CPU, **kw)


def dedicated_results(streams, *, mb=33, truths=None, alpha0=0.95, **kw):
    out = []
    for sid, s in enumerate(streams):
        eng = StreamingSGrapp(NT_W, alpha0, config=cfg(**kw),
                              truths=None if truths is None else truths[sid])
        for a in range(0, len(s), mb):
            eng.push(s.tau[a:a + mb], s.edge_i[a:a + mb], s.edge_j[a:a + mb])
        out.append(eng.finalize())
    return out


def push_round_robin(eng, streams, mb=33, start=None, stop=None):
    n = max(len(s) for s in streams)
    for a in range(0, n, mb):
        for sid, s in enumerate(streams):
            lo = a if start is None else max(a, start[sid])
            hi = min(a + mb, len(s) if stop is None else stop[sid])
            if lo < hi:
                eng.push(sid, s.tau[lo:hi], s.edge_i[lo:hi],
                         s.edge_j[lo:hi])
    return eng


def assert_same_result(res, ref):
    np.testing.assert_array_equal(res.window_counts, ref.window_counts)
    np.testing.assert_array_equal(res.estimates, ref.estimates)
    np.testing.assert_array_equal(res.cum_edges, ref.cum_edges)
    assert np.float32(res.alpha_final) == np.float32(ref.alpha_final)


def assert_close_to_reference(res, ref):
    np.testing.assert_array_equal(res.window_counts, ref.window_counts)
    np.testing.assert_array_equal(res.cum_edges, ref.cum_edges)
    np.testing.assert_allclose(res.estimates, ref.estimates, rtol=RTOL)


# -- tenants against dedicated engines ----------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_n1_fleet_bit_identical_to_single_stream(tier):
    s = make_stream()
    ref = dedicated_results([s], tier=tier, flush_every=3)[0]
    for mb in (1, 7, len(s)):
        fleet = MultiStreamSGrapp(1, NT_W, 0.95,
                                  config=cfg(tier, flush_every=3))
        assert_same_result(push_round_robin(fleet, [s], mb=mb).finalize()[0],
                           ref)


@pytest.mark.parametrize("tier", [t for t in TIERS if t != "sampled"])
def test_each_tenant_bit_identical_to_dedicated_engine(tier):
    streams = make_fleet_streams()
    refs = dedicated_results(streams, tier=tier, flush_every=3)
    fleet = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                              config=cfg(tier, flush_every=3))
    res = push_round_robin(fleet, streams).finalize()
    for sid, ref in enumerate(refs):
        assert_same_result(res[sid], ref)
    assert len(res[3].estimates) == 0


def sampled_exec():
    return WindowExecutor("sampled", align=64, snap=0, capacity=64,
                          device=CPU)


def test_sampled_tenants_draw_their_own_reservoir_seed():
    """Tenant s of a seed-k fleet draws the coins of a dedicated engine
    with reservoir seed k + s (one executor, so one threefry seed), with
    windows that really subsample; the reference's fleet draws the same
    coins, so counts agree within rtol 1e-6."""
    streams = make_fleet_streams()[:3]
    fleet = MultiStreamSGrapp(3, NT_W, 0.95, executor=sampled_exec(),
                              config=EngineConfig(tier="sampled",
                                                  flush_every=3, seed=7))
    res = push_round_robin(fleet, streams).finalize()
    for sid, s in enumerate(streams):
        eng = StreamingSGrapp(NT_W, 0.95, executor=sampled_exec(),
                              config=EngineConfig(tier="sampled",
                                                  flush_every=3,
                                                  seed=7 + sid))
        for a in range(0, len(s), 33):
            eng.push(s.tau[a:a + 33], s.edge_i[a:a + 33],
                     s.edge_j[a:a + 33])
        assert_same_result(res[sid], eng.finalize())
    import jax
    from repro.core.executor import WindowExecutor as JExecutor

    with jax.threefry_partitionable(True):
        jfleet = jst.MultiStreamSGrapp(
            3, NT_W, 0.95,
            executor=JExecutor("sampled", align=64, snap=0, capacity=64),
            config=JConfig(tier="sampled", flush_every=3, seed=7))
        want = push_round_robin(jfleet, streams).finalize()
    for sid in range(3):
        np.testing.assert_allclose(res[sid].window_counts,
                                   want[sid].window_counts, rtol=RTOL)
        np.testing.assert_allclose(res[sid].estimates, want[sid].estimates,
                                   rtol=RTOL)
    assert not np.array_equal(res[0].window_counts, res[1].window_counts)


@pytest.mark.parametrize("tier", ("dense", "pallas"))
@pytest.mark.parametrize("policy", ("distinct", "multiset"))
def test_tenants_equal_dedicated_engines_and_the_reference(tier, policy):
    streams = make_fleet_streams()
    refs = dedicated_results(streams, tier=tier, flush_every=3,
                             dup_policy=policy)
    fleet = MultiStreamSGrapp(
        len(streams), NT_W, 0.95,
        config=cfg(tier, flush_every=3, dup_policy=policy))
    res = push_round_robin(fleet, streams).finalize()
    jfleet = jst.MultiStreamSGrapp(
        len(streams), NT_W, 0.95,
        config=JConfig(tier="dense", flush_every=3, dup_policy=policy))
    want = push_round_robin(jfleet, streams).finalize()
    for sid in range(len(streams)):
        assert_same_result(res[sid], refs[sid])
        assert_close_to_reference(res[sid], want[sid])


@pytest.mark.parametrize("policy", ("distinct", "multiset"))
def test_fleet_restore_mid_stream_bit_identical(policy):
    """A whole-fleet state_dict / restore at uneven offsets (mid-window,
    tenants at different progress) is invisible, under both policies, and
    the reference's fleet restores the port's dict to the same counts."""
    streams = make_fleet_streams()
    refs = dedicated_results(streams, tier="pallas", flush_every=2,
                             dup_policy=policy)
    cut = [min(len(s), 211 + 97 * sid) for sid, s in enumerate(streams)]
    a = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                          config=cfg("pallas", flush_every=2,
                                     dup_policy=policy))
    push_round_robin(a, streams, stop=cut)
    sd = a.state_dict()
    b = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                          config=cfg("pallas", flush_every=7,
                                     dup_policy=policy)).restore(sd)
    res = push_round_robin(b, streams, start=cut).finalize()
    for sid, ref in enumerate(refs):
        assert_same_result(res[sid], ref)
    c = MultiStreamSGrapp.from_state_dict(sd, device=CPU)
    assert c.tier == "pallas" and c.dup_policy == policy
    res_c = push_round_robin(c, streams, start=cut).finalize()
    j = jst.MultiStreamSGrapp(
        len(streams), NT_W, 0.95,
        config=JConfig(tier="dense", flush_every=2,
                       dup_policy=policy)).restore(sd)
    want = push_round_robin(j, streams, start=cut).finalize()
    for sid, ref in enumerate(refs):
        assert_same_result(res_c[sid], ref)
        assert_close_to_reference(res_c[sid], want[sid])


def test_reference_fleet_dict_restores_in_the_port():
    streams = make_fleet_streams()
    cut = [len(s) // 2 for s in streams]
    j = jst.MultiStreamSGrapp(len(streams), NT_W, 0.95,
                              config=JConfig(flush_every=4))
    push_round_robin(j, streams, stop=cut)
    sd = j.state_dict()
    want = push_round_robin(j, streams, start=cut).finalize()
    mine = MultiStreamSGrapp.from_state_dict(sd, device=CPU)
    res = push_round_robin(mine, streams, start=cut).finalize()
    for sid in range(len(streams)):
        assert_close_to_reference(res[sid], want[sid])


def test_unequal_stream_lengths_and_flush_batching():
    streams = make_fleet_streams()
    refs = dedicated_results(streams, flush_every=3)
    for flush_every in (1, 2, 1000):
        fleet = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                                  config=cfg(flush_every=flush_every))
        res = push_round_robin(fleet, streams, mb=50).finalize()
        for sid, ref in enumerate(refs):
            assert_same_result(res[sid], ref)


def test_interleaved_vs_sorted_tagged_arrival():
    streams = make_fleet_streams()[:3]
    refs = dedicated_results(streams)
    cursors = [0] * len(streams)
    sid_l, tau_l, ei_l, ej_l = [], [], [], []
    while any(c < len(s) for c, s in zip(cursors, streams)):
        for sid, s in enumerate(streams):
            c = cursors[sid]
            if c < len(s):
                sid_l.append(sid)
                tau_l.append(s.tau[c])
                ei_l.append(s.edge_i[c])
                ej_l.append(s.edge_j[c])
                cursors[sid] = c + 1
    sids = np.array(sid_l)
    tau, ei, ej = np.array(tau_l), np.array(ei_l), np.array(ej_l)
    inter = MultiStreamSGrapp(3, NT_W, 0.95, config=cfg(flush_every=4))
    for a in range(0, len(sids), 97):
        inter.push(sids[a:a + 97], tau[a:a + 97], ei[a:a + 97],
                   ej[a:a + 97])
    srt = MultiStreamSGrapp(3, NT_W, 0.95, config=cfg(flush_every=4))
    order = np.argsort(sids, kind="stable")
    for a in range(0, len(order), 97):
        o = order[a:a + 97]
        srt.push(sids[o], tau[o], ei[o], ej[o])
    for res in (inter.finalize(), srt.finalize()):
        for sid, ref in enumerate(refs):
            assert_same_result(res[sid], ref)


def test_scalar_stream_id_tags_whole_batch():
    s = make_stream()
    ref = dedicated_results([s])[0]
    fleet = MultiStreamSGrapp(4, NT_W, 0.95, config=cfg(flush_every=3))
    for a in range(0, len(s), 41):
        fleet.push(2, s.tau[a:a + 41], s.edge_i[a:a + 41],
                   s.edge_j[a:a + 41])
    res = fleet.finalize()
    assert_same_result(res[2], ref)
    for sid in (0, 1, 3):
        assert len(res[sid].estimates) == 0


def _truths(s):
    edges = s.edges()
    return np.array([count_butterflies_np(edges[:e])
                     for _, e in window_bounds(s.tau, NT_W)], np.float64)


def test_per_tenant_truths_adapt_independently():
    streams = [make_stream(seed=3), make_stream(seed=4, temporal="bursty")]
    truths = [_truths(s) for s in streams]
    truths[1] = truths[1][:2]
    refs = dedicated_results(streams, truths=truths, alpha0=1.2)
    fleet = MultiStreamSGrapp(2, NT_W, 1.2, truths=truths,
                              config=cfg(flush_every=2))
    res = push_round_robin(fleet, streams).finalize()
    for sid, ref in enumerate(refs):
        assert_same_result(res[sid], ref)
        assert fleet.alpha(sid) == ref.alpha_final
    assert res[0].alpha_final != res[1].alpha_final
    jfleet = jst.MultiStreamSGrapp(2, NT_W, 1.2, truths=truths,
                                   config=JConfig(flush_every=2))
    want = push_round_robin(jfleet, streams).finalize()
    for sid in range(2):
        assert_close_to_reference(res[sid], want[sid])


def test_per_tenant_alpha0():
    streams = make_fleet_streams()[:2]
    fleet = MultiStreamSGrapp(2, NT_W, [0.9, 1.1], config=cfg())
    res = push_round_robin(fleet, streams).finalize()
    for sid, a0 in enumerate((0.9, 1.1)):
        assert_same_result(res[sid],
                           dedicated_results([streams[sid]], alpha0=a0)[0])
    assert list(fleet.state_dict()["alpha0"]) == [0.9, 1.1]


def test_tenant_clocks_are_independent():
    fleet = MultiStreamSGrapp(2, 2, 0.95, config=cfg())
    fleet.push(0, [1000.0], [1], [2])
    fleet.push(1, [1.0], [3], [4])
    with pytest.raises(ValueError, match="non-decreasing"):
        fleet.push(0, [999.0], [1], [2])
    fleet.push(0, [1001.0], [1], [2])
    fleet.push(1, [2.0], [3], [4])


def test_push_validates_and_rejects_before_mutation():
    fleet = MultiStreamSGrapp(2, NT_W, 0.95, config=cfg())
    with pytest.raises(ValueError, match="out of range"):
        fleet.push(2, [1.0], [0], [0])
    with pytest.raises(ValueError, match="out of range"):
        fleet.push([0, 5], [1.0, 2.0], [0, 1], [0, 1])
    with pytest.raises(ValueError, match="finite"):
        fleet.push(0, [np.nan], [0], [0])
    with pytest.raises(ValueError, match="equal-length"):
        fleet.push(0, [1.0, 2.0], [0], [0, 1])
    fleet.push(0, [5.0], [1], [1])
    with pytest.raises(ValueError, match="non-decreasing"):
        fleet.push([0, 1], [4.0, 1.0], [0, 1], [0, 1])
    fleet.push(1, [1.0], [0], [0])


def test_constructor_validates():
    with pytest.raises(ValueError):
        MultiStreamSGrapp(0, NT_W, 0.95, config=cfg())
    with pytest.raises(ValueError):
        MultiStreamSGrapp(2, 0, 0.95, config=cfg())
    with pytest.raises(ValueError):
        MultiStreamSGrapp(2, NT_W, 0.95, truths=[None], config=cfg())
    with pytest.raises(ValueError, match="alpha0"):
        MultiStreamSGrapp(2, NT_W, [0.9, 1.0, 1.1], config=cfg())
    with pytest.raises(ValueError):
        MultiStreamSGrapp(2, NT_W, 0.95, flush_every=0, device=CPU)
    with pytest.raises(ValueError, match="conflicts"):
        MultiStreamSGrapp(2, NT_W, 0.95, config=cfg(), flush_every=2)
    with pytest.raises(ValueError, match="device"):
        MultiStreamSGrapp(2, NT_W, 0.95,
                          executor=WindowExecutor("dense", device=CPU),
                          device=CPU)


def test_push_after_finalize_raises_and_finalize_stream_is_per_tenant():
    streams = make_fleet_streams()[:2]
    refs = dedicated_results(streams)
    fleet = MultiStreamSGrapp(2, NT_W, 0.95, config=cfg())
    push_round_robin(fleet, streams)
    assert_same_result(fleet.finalize_stream(0), refs[0])
    with pytest.raises(RuntimeError):
        fleet.push(0, [1e9], [1], [1])
    fleet.push(1, [1e9], [1], [1])      # the other tenant still takes records
    fleet.finalize()
    with pytest.raises(RuntimeError):
        fleet.push(1, [2e9], [1], [1])


def test_history_and_introspection():
    streams = make_fleet_streams()
    fleet = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                              config=cfg(flush_every=1000))
    push_round_robin(fleet, streams)
    assert fleet.n_counted(0) == 0 and fleet.n_pending > 0
    total = fleet.n_windows()
    fleet.flush()
    assert fleet.n_pending == 0 and fleet.n_windows() == total
    h = fleet.history(0, start=2)
    res = fleet.result(0)
    assert h["window"][0] == 2
    np.testing.assert_array_equal(h["count"], res.window_counts[2:])
    np.testing.assert_array_equal(np.float32(h["estimate"]),
                                  res.estimates[2:])
    assert h["cum_sgrs"] == [int(c) for c in res.cum_edges[2:]]
    assert fleet.cum_sgrs(0) == int(res.cum_edges[-1])
    with pytest.raises(ValueError, match="start"):
        fleet.history(0, start=-1)
    with pytest.raises(ValueError, match="out of range"):
        fleet.history(9)


def test_fleet_restore_is_strict():
    fleet = MultiStreamSGrapp(2, NT_W, 0.95, config=cfg())
    fleet.push(0, [1.0, 2.0], [0, 1], [0, 1])
    sd = fleet.state_dict()
    missing = dict(sd)
    del missing["carry_alpha"]
    with pytest.raises(ValueError, match="missing=\\['carry_alpha'\\]"):
        MultiStreamSGrapp(2, NT_W, 0.95, config=cfg()).restore(missing)
    unknown = dict(sd)
    unknown["bogus"] = np.int64(1)
    with pytest.raises(ValueError, match="unknown=\\['bogus'\\]"):
        MultiStreamSGrapp(2, NT_W, 0.95, config=cfg()).restore(unknown)
    wrong = dict(sd)
    wrong["version"] = np.int64(99)
    with pytest.raises(ValueError, match="version 99"):
        MultiStreamSGrapp(2, NT_W, 0.95, config=cfg()).restore(wrong)
    with pytest.raises(ValueError, match="n_streams"):
        MultiStreamSGrapp(3, NT_W, 0.95, config=cfg()).restore(sd)
    with pytest.raises(ValueError, match="nt_w"):
        MultiStreamSGrapp(2, NT_W + 1, 0.95, config=cfg()).restore(sd)


@pytest.mark.parametrize("version", (1, 2, 3, 4))
def test_fleet_checkpoints_of_every_version_restore(version):
    """A reference fleet dict cut back to schema v1-v3 (as the reference's
    tests build them) restores in the port and resumes every tenant: bit
    for bit against the port's uninterrupted fleet, and within rtol 1e-6
    of the reference's."""
    streams = make_fleet_streams()
    cut = [min(len(s), 300 + 50 * sid) for sid, s in enumerate(streams)]
    j = jst.MultiStreamSGrapp(len(streams), NT_W, 0.95,
                              config=JConfig(flush_every=3))
    push_round_robin(j, streams, stop=cut)
    sd = j.state_dict()
    want = push_round_robin(j, streams, start=cut).finalize()
    old = {k: v for k, v in sd.items() if k not in LACKS[version]}
    old["version"] = np.int64(version)
    mine = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                             config=cfg(flush_every=3)).restore(old)
    if version == 1:
        n0 = int(sd["buf_len"][0])
        np.testing.assert_array_equal(mine._state.buf_op[0, :n0],
                                      np.ones(n0, np.int8))
    if version <= 2:
        np.testing.assert_array_equal(mine._state.res_seed,
                                      np.arange(len(streams)))
    res = push_round_robin(mine, streams, start=cut).finalize()
    whole = push_round_robin(
        MultiStreamSGrapp(len(streams), NT_W, 0.95,
                          config=cfg(flush_every=3)), streams).finalize()
    for sid in range(len(streams)):
        assert_same_result(res[sid], whole[sid])
        assert_close_to_reference(res[sid], want[sid])
    if version < 4:
        with pytest.raises(ValueError, match="no EngineConfig"):
            MultiStreamSGrapp.from_state_dict(old, device=CPU)


def test_failed_flush_keeps_whole_fleet_pending():
    fleet = MultiStreamSGrapp(2, 2, 0.95, config=cfg(flush_every=1000))
    fleet.push(0, [1.0, 2.0, 3.0], [1, 2**40, 5], [0, 1, 2])
    fleet.push(1, [1.0, 2.0, 3.0], [1, 2, 3], [0, 1, 2])
    assert fleet.n_pending == 2
    with pytest.raises(ValueError, match="2\\*\\*32"):
        fleet.flush()
    assert fleet.n_pending == 2
    assert fleet.n_windows(0) == 1 and fleet.n_windows(1) == 1


def test_cobatched_flush_is_one_dispatch():
    """Every tenant's pending windows count in one bucketed dispatch: a
    fleet flush of same-rung windows is one chunk, where dedicated engines
    pay one each."""
    streams = make_fleet_streams()[:3]
    fleet = MultiStreamSGrapp(3, NT_W, 0.95, config=cfg(flush_every=1000))
    push_round_robin(fleet, streams)
    fleet.flush()
    assert fleet.executor.chunks_dispatched < sum(
        fleet.n_counted(s) for s in range(3))


@pytest.mark.parametrize("tier", ("dense", "pallas"))
def test_async_fleet_bit_identical_to_sync_dispatch(tier):
    streams = make_fleet_streams()
    for flush_every in (1, 4):
        sync = MultiStreamSGrapp(len(streams), NT_W, 0.95, config=cfg(
            tier, flush_every=flush_every, sync_dispatch=True))
        assert sync.sync_dispatch
        refs = push_round_robin(sync, streams).finalize()
        for mb in (1, 33):
            fleet = MultiStreamSGrapp(len(streams), NT_W, 0.95, config=cfg(
                tier, flush_every=flush_every))
            res = push_round_robin(fleet, streams, mb=mb).finalize()
            assert fleet.n_inflight == 0
            for sid, ref in enumerate(refs):
                assert_same_result(res[sid], ref)


def test_async_fleet_inflight_accounting():
    streams = make_fleet_streams()
    fleet = MultiStreamSGrapp(len(streams), NT_W, 0.95,
                              config=cfg(flush_every=2))
    saw = False
    for a in range(0, max(len(s) for s in streams), 40):
        for sid, s in enumerate(streams):
            if a < len(s):
                fleet.push(sid, s.tau[a:a + 40], s.edge_i[a:a + 40],
                           s.edge_j[a:a + 40])
        saw = saw or fleet.n_inflight > 0
    assert saw
    before = fleet.n_windows()
    fleet.flush()
    assert fleet.n_inflight == 0 and fleet.n_pending == 0
    assert fleet.n_windows() == before


def test_sampled_fleet_rejects_deletes_and_multiset():
    fleet = MultiStreamSGrapp(2, NT_W, 0.95, config=cfg("sampled"))
    with pytest.raises(NotImplementedError, match="deletions"):
        fleet.push(0, [1.0], [0], [0], op=[1])
    assert fleet.n_windows() == 0
    with pytest.raises(NotImplementedError, match="multiset"):
        MultiStreamSGrapp(2, NT_W, 0.95,
                          config=cfg("sampled", dup_policy="multiset"))


# -- the batched estimator step ---------------------------------------------

def test_estimator_step_batched_matches_scalar():
    """Inactive lanes pass their carry through unchanged; active lanes
    equal N scalar steps within rtol 1e-6 (torch's vectorized float32
    ``pow`` may round a lane differently from its scalar one, which is why
    the fleet engine advances tenants with the scalar step)."""
    rng = np.random.default_rng(1)
    n = 64
    step1 = estimator_step(device=CPU)
    step_n = estimator_step_batched(device=CPU)
    inits = [estimator_init(0.9 + 0.01 * s, device=CPU) for s in range(n)]
    carry = tuple(torch.stack(c) for c in zip(*inits))
    carry = (carry[0] + torch.from_numpy(
        (rng.random(n) * 1e3).astype(np.float32)),) + carry[1:]
    xs = (torch.from_numpy((rng.random(n) * 1e4).astype(np.float32)),
          torch.from_numpy((rng.random(n) * 1e5).astype(np.float32)),
          torch.from_numpy((rng.random(n) * 1e5).astype(np.float32)),
          torch.from_numpy(rng.random(n) > 0.5),
          torch.arange(n, dtype=torch.int32))
    active = torch.from_numpy(rng.random(n) > 0.3)
    c_n, e_n = step_n(carry, xs, active)
    for s in range(n):
        c1, e1 = step1(tuple(c[s] for c in carry), tuple(x[s] for x in xs))
        if not active[s]:
            for got, old in zip(c_n, carry):
                assert torch.equal(got[s], old[s])
            continue
        torch.testing.assert_close(e_n[s], e1, rtol=RTOL, atol=0)
        for got, want in zip(c_n, c1):
            torch.testing.assert_close(got[s], want, rtol=RTOL, atol=0)
