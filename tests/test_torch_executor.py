"""The port's WindowExecutor against the reference executor.

Same planning (buckets, capacities, window membership), the same exact
counts on every ported tier (``numpy``, ``dense``, ``tiled``, ``pallas``,
``sparse``, ``auto``; on the CPU the pallas tier runs K1's plain version),
and the submit / reap handle.  Multiset batches, wedge rungs and routing
are in ``test_torch_multiset.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.executor as jex  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
from repro_torch.core.windows import WindowBatch, windowize  # noqa: E402
from repro_torch.kernels.butterfly import butterfly_kernel as k1  # noqa: E402
from repro_torch.streams import bipartite_pa_stream  # noqa: E402

from test_tier_differential import ADVERSARIAL  # noqa: E402

CPU = "cpu"


def corpus_batch(align=128):
    tau, ei, ej = [], [], []
    for k, edges in enumerate(ADVERSARIAL.values()):
        for i, j in edges:
            tau.append(float(k))
            ei.append(i)
            ej.append(j)
    return windowize(np.asarray(tau), np.asarray(ei), np.asarray(ej), 1,
                     align=align)


def pa_batch():
    s = bipartite_pa_stream(4000, n_unique=1000, seed=2)
    return windowize(s.tau, s.edge_i, s.edge_j, 25)


def empty_batch():
    z = np.zeros((2, 8), np.int32)
    zi = np.zeros(2, np.int64)
    return WindowBatch(
        edge_i=z, edge_j=z.copy(), valid=np.zeros((2, 8), bool),
        n_edges=zi.copy(), n_sgrs=zi.copy(), cum_sgrs=np.array([1, 2]),
        n_i=1, n_j=1, window_end_tau=np.zeros(2, np.float64),
        n_i_per_window=zi.copy(), n_j_per_window=zi.copy())


@pytest.mark.parametrize("make", [corpus_batch, pa_batch])
@pytest.mark.parametrize("align,snap", [(8, 0), (64, 16), (128, 0)])
def test_plan_equals_reference(make, align, snap):
    batch = make()
    got = tex.WindowExecutor("dense", align=align, snap=snap,
                             device=CPU).plan(batch)
    want = jex.WindowExecutor("dense", align=align, snap=snap).plan(batch)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.cap_e, g.cap_i, g.cap_j) == (w.cap_e, w.cap_i, w.cap_j)
        assert w.cap_w == 0          # wedge rungs belong to sparse tiers
        np.testing.assert_array_equal(g.windows, w.windows)


def test_capacity_ladders_equal_reference():
    for n in (0, 1, 7, 64, 65, 128, 129, 300, 5000):
        for align in (8, 64, 128):
            assert tex.bucket_capacity(n, align=align) == jex.bucket_capacity(
                n, align=align)
            assert tex.id_capacity(n, align=align) == jex.id_capacity(
                n, align=align)


@pytest.mark.parametrize("tier", tex.TIERS)
@pytest.mark.parametrize("align", [8, 128])
def test_counts_equal_reference_on_adversarial(tier, align):
    batch = corpus_batch(align)
    want = jex.WindowExecutor("dense", align=align).window_counts(batch)
    got = tex.WindowExecutor(tier, align=align, device=CPU).window_counts(
        batch)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", ("dense", "pallas"))
def test_counts_equal_reference_on_pa_stream(tier):
    batch = pa_batch()
    want = jex.WindowExecutor("dense").window_counts(batch)
    got = tex.WindowExecutor(tier, device=CPU).window_counts(batch)
    np.testing.assert_array_equal(got, want)


def test_pallas_tier_equals_reference_pallas_tier():
    batch = corpus_batch(8)
    want = jex.WindowExecutor("pallas", align=8, block_i=8,
                              block_k=128).window_counts(batch)
    got = tex.WindowExecutor("pallas", align=8, block_i=8,
                             device=CPU).window_counts(batch)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tier", ("dense", "pallas"))
def test_chunk_sweep_identical(tier):
    batch = corpus_batch(8)
    seq = tex.WindowExecutor(tier, align=8, chunk=1,
                             device=CPU).window_counts(batch)
    for chunk in (2, 3, 64):
        ex = tex.WindowExecutor(tier, align=8, chunk=chunk, device=CPU)
        np.testing.assert_array_equal(ex.window_counts(batch), seq)
        want = sum(-(-b.n_windows // chunk) for b in ex.plan(batch))
        assert ex.chunks_dispatched == want


@pytest.mark.parametrize("tier", tex.TIERS)
def test_empty_windows_count_zero(tier):
    got = tex.WindowExecutor(tier, device=CPU).window_counts(empty_batch())
    np.testing.assert_array_equal(got, np.zeros(2))
    ex = tex.WindowExecutor(tier, device=CPU)
    assert ex.window_counts(windowize(np.zeros(0), np.zeros(0, np.int64),
                                      np.zeros(0, np.int64), 3)).shape == (0,)


@pytest.mark.parametrize("tier", tex.TIERS)
def test_reap_is_idempotent(tier):
    ex = tex.WindowExecutor(tier, device=CPU)
    handle = ex.window_counts_submit(corpus_batch())
    first = handle.reap()
    assert handle.done
    second = handle.reap()
    assert second is first
    np.testing.assert_array_equal(second, ex.window_counts(corpus_batch()))


def test_staging_ring_reuses_buffers_without_changing_counts():
    ex = tex.WindowExecutor("pallas", align=8, device=CPU)
    a, b = corpus_batch(8), pa_batch()
    want_a, want_b = ex.window_counts(a), ex.window_counts(b)
    for _ in range(3):                   # ring of two, cycled past its length
        np.testing.assert_array_equal(ex.window_counts(a), want_a)
        np.testing.assert_array_equal(ex.window_counts(b), want_b)


@pytest.mark.parametrize("tier", ("sampled",))
def test_unported_tiers_name_their_roadmap_item(tier):
    """Every tier is ported now: ``sampled`` builds, and on windows that fit
    its reservoir it counts exactly what ``dense`` counts."""
    batch = corpus_batch()
    got = tex.WindowExecutor(tier, device=CPU).window_counts(batch)
    want = tex.WindowExecutor("dense", device=CPU).window_counts(batch)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,match", [
    (dict(tier="bogus"), "tier must be"),
    (dict(chunk=0), "chunk"),
    (dict(snap=-1), "snap"),
    (dict(align=0), "align"),
    (dict(block_i=12), "block_i"),
    (dict(capacity=0), "capacity"),
    (dict(gamma=1.0), "gamma"),
    (dict(memory_budget=0), "memory_budget"),
    (dict(target_mape=0.0), "target_mape"),
])
def test_constructor_validates(kw, match):
    with pytest.raises(ValueError, match=match):
        tex.WindowExecutor(**{"device": CPU, **kw})


@pytest.mark.parametrize("tier", tex.TIERS)
def test_warmup_runs_each_rung(tier):
    ex = tex.WindowExecutor(tier, device=CPU)
    k1.reset_launch_count()
    assert ex.warmup([(128, 64, 64), (256, 64, 128)]) == (
        0 if tier == "numpy" else 2)
    assert k1.launch_count() == 0        # CPU: K1's plain version only
