"""The port's executor entries against the reference's: ``run`` in tumbling
and sliding mode, the online ``count_edges``, and the late-deletion path
(``route_decrement``, ``butterfly_delta_np``, ``decrement_window_counts``).

Inputs are the adversarial corpus of ``test_tier_differential.py`` and
seeded numpy streams; every count is exact (the counts stay far below
2**24), so the tolerance is 0.  On the CPU the pallas tier runs K1's plain
version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.executor as jex  # noqa: E402
from repro.core.butterfly import butterfly_delta_np as j_delta  # noqa: E402
from repro.core.windows import pack_windows as j_pack  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
from repro_torch.core.butterfly import (  # noqa: E402
    butterfly_delta_np,
    count_butterflies_np,
)
from repro_torch.core.fleet import reservoir_run  # noqa: E402
from repro_torch.core.windows import pack_windows, windowize  # noqa: E402
from repro_torch.kernels.butterfly import butterfly_kernel as k1  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    MultiStreamSGrapp,
    bipartite_pa_stream,
)

from test_tier_differential import ADVERSARIAL  # noqa: E402

CPU = "cpu"
EXACT_TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto")


def corpus_batch():
    tau, ei, ej = [], [], []
    for k, edges in enumerate(ADVERSARIAL.values()):
        for i, j in edges:
            tau.append(float(k))
            ei.append(i)
            ej.append(j)
    return windowize(np.asarray(tau), np.asarray(ei), np.asarray(ej), 1)


def pa_batch():
    s = bipartite_pa_stream(6000, n_unique=1500, seed=5)
    return windowize(s.tau, s.edge_i, s.edge_j, 30)


# -- run: tumbling and sliding ----------------------------------------------

@pytest.mark.parametrize("tier", EXACT_TIERS)
@pytest.mark.parametrize("make", [corpus_batch, pa_batch])
def test_run_tumbling_equals_reference(tier, make):
    batch = make()
    want = jex.run(batch, tier="dense")
    got = tex.run(batch, tier=tier, device=CPU)
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.cum_sgrs, want.cum_sgrs)
    assert (got.tier, got.mode, got.span, got.n_shards) == (
        tier, "tumbling", 1, 1)
    assert got.n_windows == batch.n_windows
    assert got.stream_ids is None


@pytest.mark.parametrize("tier", ("dense", "pallas", "numpy"))
@pytest.mark.parametrize("span", (1, 2, 5, 1000))
def test_run_sliding_equals_reference(tier, span):
    batch = pa_batch()
    want = jex.run(batch, tier="dense", mode="sliding", span=span)
    got = tex.WindowExecutor(tier, device=CPU).run(batch, mode="sliding",
                                                   span=span)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert (got.mode, got.span) == ("sliding", span) == (want.mode,
                                                         want.span)
    # the prefix difference of the tumbling counts, computed directly
    tumbling = tex.run(batch, tier=tier, device=CPU).counts
    direct = [tumbling[max(0, k - span + 1):k + 1].sum()
              for k in range(len(tumbling))]
    np.testing.assert_array_equal(got.counts, direct)


def test_run_rejects_bad_mode_and_span():
    ex = tex.WindowExecutor("dense", device=CPU)
    with pytest.raises(ValueError, match="mode must be"):
        ex.run(corpus_batch(), mode="hopping")
    with pytest.raises(ValueError, match="span"):
        ex.run(corpus_batch(), mode="sliding", span=0)


def _two_stream_batch(stream_ids):
    per_edges = [np.array([[0, 0]]), np.array([[1, 1]])]
    return pack_windows(per_edges, n_sgrs=np.array([1, 1]),
                        cum_sgrs=np.array([1, 2]),
                        window_end_tau=np.zeros(2),
                        stream_ids=np.asarray(stream_ids, dtype=np.int32))


@pytest.mark.parametrize("tier", ("dense", "pallas"))
def test_sliding_rejects_multi_stream_batch_before_dispatch(tier):
    ex = tex.WindowExecutor(tier, device=CPU)
    with pytest.raises(ValueError, match="sliding"):
        ex.run(_two_stream_batch([0, 1]), mode="sliding", span=2)
    assert ex.chunks_dispatched == 0     # refused before any dispatch
    with pytest.raises(ValueError, match="sliding"):
        jex.WindowExecutor("dense").run(
            j_pack([np.array([[0, 0]]), np.array([[1, 1]])],
                   n_sgrs=np.array([1, 1]), cum_sgrs=np.array([1, 2]),
                   window_end_tau=np.zeros(2),
                   stream_ids=np.array([0, 1], dtype=np.int32)),
            mode="sliding", span=2)
    # one tenant's panes slide; tumbling mode takes any batch
    one = ex.run(_two_stream_batch([3, 3]), mode="sliding", span=2)
    np.testing.assert_array_equal(one.stream_ids, [3, 3])
    ex.run(_two_stream_batch([0, 1]))


def test_module_run_forwards_executor_knobs():
    batch = pa_batch()
    got = tex.run(batch, tier="pallas", mode="sliding", span=3, chunk=2,
                  align=8, device=CPU)
    want = jex.run(batch, tier="dense", mode="sliding", span=3, chunk=2,
                   align=8)
    np.testing.assert_array_equal(got.counts, want.counts)


# -- count_edges ----------------------------------------------------------

@pytest.mark.parametrize("tier", EXACT_TIERS)
def test_count_edges_on_raw_duplicated_edges(tier):
    ex = tex.WindowExecutor(tier, device=CPU)
    ref = jex.WindowExecutor("dense")
    for name, edges in ADVERSARIAL.items():
        e = np.asarray(edges, dtype=np.int64)
        got = ex.count_edges(e[:, 0], e[:, 1])
        assert got == ref.count_edges(e[:, 0], e[:, 1]), name
        assert got == count_butterflies_np(e), name


@pytest.mark.parametrize("tier", ("numpy", "dense", "pallas"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_count_edges_on_arbitrary_int64_ids(tier, seed):
    rng = np.random.default_rng(seed)
    ids_i = rng.integers(-2**62, 2**62, 40)
    ids_j = rng.integers(-2**40, 2**62, 30)
    ei = ids_i[rng.integers(0, 40, 400)]
    ej = ids_j[rng.integers(0, 30, 400)]
    got = tex.WindowExecutor(tier, device=CPU).count_edges(ei, ej)
    assert got == jex.WindowExecutor("numpy").count_edges(ei, ej)
    _, ci = np.unique(ei, return_inverse=True)
    _, cj = np.unique(ej, return_inverse=True)
    assert got == count_butterflies_np(np.stack([ci, cj], 1))


def test_count_edges_memoizes_its_counter_and_stays_on_the_plain_k1():
    """The counter is the process-wide one of the window's configuration
    (``compiled_bucket_cache_info``), emptied here first."""
    tex._bucket_counter.cache_clear()
    ex = tex.WindowExecutor("pallas", device=CPU)
    assert ex.count_edges([], []) == 0.0
    k1.reset_launch_count()
    e = np.asarray(ADVERSARIAL["complete_k9_7"], dtype=np.int64)
    first = ex.count_edges(e[:, 0], e[:, 1])
    cached = tex.compiled_bucket_cache_info()
    assert cached["single_device"] == 1
    assert ex.count_edges(e[::-1, 0], e[::-1, 1]) == first == 756
    assert tex.compiled_bucket_cache_info() == cached  # same rung: same counter
    ex.count_edges([0, 0, 1, 1] * 50, [0, 1, 0, 1] * 50)
    assert tex.compiled_bucket_cache_info() == cached  # edge rung: same ids
    ex.count_edges(np.repeat(np.arange(80), 2), [0, 1] * 80)
    assert tex.compiled_bucket_cache_info()["single_device"] == 2  # a new rung
    assert k1.launch_count() == 0                # CPU: K1's plain version


# -- the late-deletion path ---------------------------------------------------

def test_route_decrement_thresholds():
    assert tex.route_decrement(100, 10) == "delta"
    assert tex.route_decrement(100, 25) == "delta"
    assert tex.route_decrement(100, 26) == "recount"
    assert tex.route_decrement(100, 10, delta_frac=0.05) == "recount"
    for n in range(0, 40, 3):
        for d in range(0, 20, 2):
            for frac in (0.0, 0.1, 0.25, 1.0):
                assert tex.route_decrement(n, d, delta_frac=frac) == \
                    jex.route_decrement(n, d, delta_frac=frac)
    with pytest.raises(ValueError):
        tex.route_decrement(-1, 0)
    with pytest.raises(ValueError):
        tex.route_decrement(10, -1)


@pytest.mark.parametrize("seed", (5, 6, 7))
def test_butterfly_delta_equals_reference_and_recount(seed):
    rng = np.random.default_rng(seed)
    e = np.unique(rng.integers(0, 8, size=(30, 2)).astype(np.int64), axis=0)
    d = e[rng.choice(len(e), size=5, replace=False)]
    keep = ~np.isin(e[:, 0] << 32 | e[:, 1], d[:, 0] << 32 | d[:, 1])
    got = butterfly_delta_np(e, d)
    assert got == j_delta(e, d)
    assert count_butterflies_np(e) - got == count_butterflies_np(e[keep])
    with pytest.raises(ValueError, match="cannot delete absent edge"):
        butterfly_delta_np(e, np.array([[99, 99]]))


def _decrement_case(seed, n_windows=4):
    rng = np.random.default_rng(seed)
    per_edges, per_del, prior, want = [], [], [], []
    for _ in range(n_windows):
        e = np.unique(rng.integers(0, 10, size=(40, 2)).astype(np.int64),
                      axis=0)
        d = e[rng.choice(e.shape[0], size=max(1, e.shape[0] // 8),
                         replace=False)]
        keep = ~np.isin(e[:, 0] << 32 | e[:, 1], d[:, 0] << 32 | d[:, 1])
        per_edges.append(e)
        per_del.append(d)
        prior.append(count_butterflies_np(e))
        want.append(count_butterflies_np(e[keep]))
    return per_edges, per_del, np.array(prior, np.float64), np.array(want,
                                                                     float)


@pytest.mark.parametrize("tier", ("numpy", "dense", "pallas"))
@pytest.mark.parametrize("delta_frac", (0.0, 0.25, 1.0))
def test_decrement_window_counts_both_routes_equal_reference(tier,
                                                             delta_frac):
    """delta_frac=0 forces the recount, 1.0 the delta walk; both equal a
    from-scratch count of the survivors and the reference's result."""
    per_edges, per_del, prior, want = _decrement_case(2)
    ex = tex.WindowExecutor(tier, device=CPU)
    got = ex.decrement_window_counts(per_edges, per_del, prior,
                                     delta_frac=delta_frac)
    np.testing.assert_array_equal(got, want)
    ref = jex.WindowExecutor("numpy").decrement_window_counts(
        per_edges, per_del, prior, delta_frac=delta_frac)
    np.testing.assert_array_equal(got, ref)


def test_decrement_recount_is_one_bucketed_dispatch():
    per_edges, per_del, prior, want = _decrement_case(3, n_windows=6)
    # a window with nothing deleted keeps its prior count untouched
    per_del[4] = np.zeros((0, 2), np.int64)
    want[4] = prior[4]
    ex = tex.WindowExecutor("pallas", device=CPU)
    got = ex.decrement_window_counts(per_edges, per_del, prior,
                                     delta_frac=0.0)
    np.testing.assert_array_equal(got, want)
    # the five recounts share one bucket: one chunk, one K1 launch on a card
    assert ex.chunks_dispatched == 1


@pytest.mark.parametrize("delta_frac", (0.0, 1.0))
def test_decrement_rejects_absent_and_duplicate_deletes(delta_frac):
    ex = tex.WindowExecutor("pallas", device=CPU)
    e = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.int64)
    prior = np.array([1.0])
    with pytest.raises(ValueError, match="absent"):
        ex.decrement_window_counts([e], [np.array([[9, 9]])], prior,
                                   delta_frac=delta_frac)
    with pytest.raises(ValueError):
        ex.decrement_window_counts([e], [np.array([[0, 0], [0, 0]])],
                                   prior, delta_frac=delta_frac)
    with pytest.raises(ValueError, match="align"):
        ex.decrement_window_counts([e, e], [np.array([[0, 0]])], prior)


def test_expected_mape_equals_reference():
    for cap_e in (64, 100, 4096, 10**5):
        for capacity in (1, 64, 2048, 8192):
            for gamma in (0.3, 0.7, 0.95):
                assert tex.expected_mape(cap_e, capacity, gamma) == \
                    jex.expected_mape(cap_e, capacity, gamma)


@pytest.mark.parametrize("entry", [
    lambda: tex.run(pa_batch(), tier="pallas"),
    lambda: tex.WindowExecutor("sampled"),
    lambda: reservoir_run([0], [0], capacity=4),
    lambda: MultiStreamSGrapp(2, 20, 1.02),
], ids=["run", "executor_sampled", "reservoir_run", "multistream"])
def test_new_entries_raise_without_a_card(monkeypatch, entry):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
