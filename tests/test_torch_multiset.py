"""The port's multiset counting, tiled / sparse / auto tiers, K2 and K3
against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
reference's Pallas kernels run in interpret mode; the port's wrappers run
their plain torch versions because the tensors lie on the CPU.  Counts
whose partial sums stay below 2**24 must be equal; past 2**24 float32 sums
round in an order that differs between the packages, and they are held
within a stated rtol.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.butterfly as jbf  # noqa: E402
import repro.core.executor as jex  # noqa: E402
import repro.core.windows as jwin  # noqa: E402
from repro.kernels.butterfly import ops as jops  # noqa: E402
from repro.kernels.butterfly.butterfly_kernel import (  # noqa: E402
    butterfly_pairs_windows_kernel_multiset_call as j_k2_call,
)
import repro_torch.core.butterfly as tbf  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
from repro_torch.core import windows as twin  # noqa: E402
from repro_torch.kernels.butterfly import butterfly_kernel as kk  # noqa: E402
from repro_torch.kernels.butterfly import ops as tops  # noqa: E402

from test_tier_differential import ADVERSARIAL  # noqa: E402

CPU = "cpu"
EXACT_TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto")


def weighted_stack(b, n, k, density, max_mult, seed):
    """``[b, n, k]`` float32 net multiplicities in ``[1, max_mult]``."""
    rng = np.random.default_rng(seed)
    present = rng.random((b, n, k)) < density
    return (present * rng.integers(1, max_mult + 1, (b, n, k))
            ).astype(np.float32)


def corpus_windows(seed=0):
    """Each ADVERSARIAL window resolved as the engine resolves a multiset
    window: unique edges, multiplicity = occurrences; edges that occur once
    get a seeded weight in [1, 3] so that weights vary in every window.
    Every count, partial and Gram entry stays below 2**24."""
    rng = np.random.default_rng(seed)
    edges, mults = [], []
    for raw in ADVERSARIAL.values():
        e, m = np.unique(np.asarray(raw, np.int64), axis=0, return_counts=True)
        edges.append(e)
        mults.append(np.where(m > 1, m, rng.integers(1, 4, m.shape[0])))
    return edges, mults


def corpus_batches(align, multiset):
    """The same corpus packed by both packages (one window per entry)."""
    edges, mults = corpus_windows()
    n = len(edges)
    kw = dict(n_sgrs=np.arange(1, n + 1), cum_sgrs=np.cumsum(np.arange(1, n + 1)),
              window_end_tau=np.arange(n, dtype=np.float64), align=align)
    if multiset:
        kw.update(dedupe=False, per_window_mult=mults)
    return jwin.pack_windows(edges, **kw), twin.pack_windows(edges, **kw)


# -- host oracles ------------------------------------------------------------

@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_multiset_oracle_equals_reference(name):
    edges, mults = corpus_windows(seed=len(name))
    k = list(ADVERSARIAL).index(name)
    got = tbf.count_butterflies_multiset_np(edges[k], mults[k])
    assert got == jbf.count_butterflies_multiset_np(edges[k], mults[k])
    assert tbf.count_butterflies_multiset_np(edges[k], np.ones_like(mults[k])) \
        == tbf.count_butterflies_np(edges[k])


def test_wedge_counts_equal_reference():
    jb, tb = corpus_batches(8, multiset=False)
    np.testing.assert_array_equal(
        tbf.window_wedge_counts_np(tb.edge_i, tb.edge_j, tb.valid),
        jbf.window_wedge_counts_np(jb.edge_i, jb.edge_j, jb.valid))


# -- device tiers, one window at a time --------------------------------------

@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_multiset_dense_tiled_sparse_equal_reference(name):
    edges, mults = corpus_windows(seed=3)
    k = list(ADVERSARIAL).index(name)
    e, m = edges[k], mults[k]
    n_i, n_j = int(e[:, 0].max()) + 1, int(e[:, 1].max()) + 1
    cap = len(e) + 5                              # padding lanes
    ei = np.zeros(cap, np.int32)
    ej = np.zeros(cap, np.int32)
    mm = np.zeros(cap, np.int32)
    v = np.zeros(cap, bool)
    ei[:len(e)], ej[:len(e)], mm[:len(e)], v[:len(e)] = e[:, 0], e[:, 1], m, True
    want = float(jbf.count_butterflies_from_edges_multiset(
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(mm), jnp.asarray(v),
        n_i, n_j))
    assert want == jbf.count_butterflies_multiset_np(e, m)
    t = [torch.from_numpy(x) for x in (ei, ej, mm, v)]
    adj = tbf.build_biadjacency_multiset(*t, n_i, n_j)
    np.testing.assert_array_equal(
        adj.numpy(), np.asarray(jbf.build_biadjacency_multiset(
            jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(mm), jnp.asarray(v),
            n_i, n_j)))
    wedges = int(jbf.window_wedge_counts_np(ei[None], ej[None], v[None])[0])
    got = {
        "dense": tbf.count_butterflies_from_edges_multiset(*t, n_i, n_j),
        "tiled": tbf.count_butterflies_tiled_multiset(adj, tile=8),
        "sparse": tbf.count_butterflies_sparse_multiset(
            *t, n_i, n_j, wedge_cap=max(wedges, 1)),
    }
    for tier, val in got.items():
        assert val.dtype == torch.float32 and float(val) == want, tier
    jt = float(jbf.count_butterflies_tiled_multiset(jnp.asarray(adj.numpy()),
                                                    tile=8))
    assert jt == want


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_distinct_tiled_sparse_equal_reference(name):
    e = np.asarray(ADVERSARIAL[name], np.int64)
    n_i, n_j = int(e[:, 0].max()) + 1, int(e[:, 1].max()) + 1
    ei, ej = e[:, 0].astype(np.int32), e[:, 1].astype(np.int32)
    v = np.ones(len(e), bool)
    want = jbf.count_butterflies_np(e)
    wedges = int(jbf.window_wedge_counts_np(ei[None], ej[None], v[None])[0])
    t = [torch.from_numpy(x) for x in (ei, ej, v)]
    adj = tbf.build_biadjacency(*t, n_i, n_j)
    for tile in (8, 64):
        assert float(tbf.count_butterflies_tiled(adj, tile=tile)) == want
    got = tbf.count_butterflies_sparse(*t, n_i, n_j, wedge_cap=max(wedges, 1))
    assert float(got) == want == float(jbf.count_butterflies_sparse(
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(v), n_i, n_j,
        max(wedges, 1)))


def test_sparse_batched_equals_one_window_at_a_time():
    jb, tb = corpus_batches(8, multiset=True)
    wedges = tbf.window_wedge_counts_np(tb.edge_i, tb.edge_j, tb.valid)
    cap_w = int(wedges.max())
    lanes = [torch.from_numpy(x) for x in (tb.edge_i, tb.edge_j,
                                           tb.edge_mult, tb.valid)]
    both = tbf.count_butterflies_sparse_multiset(*lanes, tb.n_i, tb.n_j, cap_w)
    for k in range(tb.n_windows):
        one = tbf.count_butterflies_sparse_multiset(
            *(x[k] for x in lanes), tb.n_i, tb.n_j, cap_w)
        assert float(one) == float(both[k])


def test_sparse_refuses_what_the_reference_refuses():
    z = torch.zeros(4, dtype=torch.int32)
    v = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="int32"):
        tbf.count_butterflies_sparse(z, z, v, 50_000, 50_000, wedge_cap=4)
    with pytest.raises(ValueError, match="wedge_cap"):
        tbf.count_butterflies_sparse_multiset(z, z, z, v, 8, 8, wedge_cap=0)
    with pytest.raises(ValueError, match="int32"):
        jbf.count_butterflies_sparse(jnp.asarray(z.numpy()),
                                     jnp.asarray(z.numpy()),
                                     jnp.asarray(v.numpy()), 50_000, 50_000,
                                     wedge_cap=4)


def test_tiled_restores_tf32_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tbf.count_butterflies_tiled_multiset(
            torch.from_numpy(weighted_stack(1, 20, 30, 0.3, 4, seed=1)), tile=8)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


# -- K2 and K3 against the reference kernels in interpret mode ---------------

@pytest.mark.parametrize("b,n,k,block_i,block_k,density,max_mult", [
    (2, 16, 128, 8, 128, 0.3, 8),
    (3, 32, 256, 16, 128, 0.2, 8),
    (1, 64, 128, 32, 128, 0.5, 3),
])
def test_k2_plain_partials_equal_reference_kernel(b, n, k, block_i, block_k,
                                                  density, max_mult):
    a = weighted_stack(b, n, k, density, max_mult, seed=n * k)
    want = np.asarray(j_k2_call(jnp.asarray(a), block_i=block_i,
                                block_k=block_k, interpret=True))
    assert want.max() < 2**24
    got = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(a),
                                                    block_i=block_i)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(
        kk.butterfly_pairs_windows_kernel_multiset_call(
            torch.from_numpy(a), block_i=block_i).numpy(), want)


def test_k2_plain_partials_past_2_24_within_rtol():
    """Multiplicities up to 300 put W^2 and S past 2**24: both packages
    round in float32, in different orders, and agree within rtol 1e-5."""
    a = weighted_stack(2, 32, 256, 0.3, 300, seed=9)
    want = np.asarray(j_k2_call(jnp.asarray(a), block_i=16, block_k=128,
                                interpret=True))
    assert want.max() > 2**24
    got = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(a),
                                                    block_i=16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_i,n_j,block_i", [(16, 40, 8), (40, 16, 8),
                                              (33, 130, 16)])
def test_k2_wrapper_counts_equal_reference(n_i, n_j, block_i):
    a = weighted_stack(3, n_i, n_j, 0.3, 6, seed=n_i + n_j)
    want = np.asarray(jops.butterfly_count_pallas_windows_multiset(
        jnp.asarray(a), block_i=block_i, interpret=True))
    got = tops.butterfly_count_pallas_windows_multiset(torch.from_numpy(a),
                                                       block_i=block_i)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for w in range(3):
        ii, jj = np.nonzero(a[w])
        assert float(got[w]) == tbf.count_butterflies_multiset_np(
            np.stack([ii, jj], 1), a[w][ii, jj])


@pytest.mark.parametrize("n_i,n_j,block_i", [(20, 30, 8), (45, 12, 16),
                                              (64, 64, 32), (5, 5, 8)])
def test_k3_entries_equal_reference(n_i, n_j, block_i):
    rng = np.random.default_rng(n_i * n_j)
    adj = (rng.random((n_i, n_j)) < 0.35).astype(np.float32)
    want = float(jops.butterfly_count_pallas(
        jnp.asarray(adj), block_i=block_i, block_k=128, interpret=True))
    got = tops.butterfly_count_pallas(torch.from_numpy(adj), block_i=block_i)
    assert got.dim() == 0 and float(got) == want
    tiles_want = jops.butterfly_count_tiles(adj, block_i=block_i,
                                            block_k=128, interpret=True)
    assert tops.butterfly_count_tiles(torch.from_numpy(adj),
                                      block_i=block_i) == tiles_want
    assert tops.butterfly_count_tiles(adj, block_i=block_i,
                                      device=CPU) == tiles_want
    batched = tops.butterfly_count_pallas_batched(
        torch.from_numpy(np.stack([adj, adj[::-1].copy()])), block_i=block_i)
    np.testing.assert_array_equal(batched.numpy(), [want, want])


def test_k3_partials_equal_k1_at_one_window():
    adj = torch.from_numpy((np.random.default_rng(4).random((40, 50)) < 0.3
                            ).astype(np.float32))
    np.testing.assert_array_equal(
        kk.butterfly_pairs_kernel_call(adj, block_i=16).numpy(),
        kk.butterfly_pairs_windows_kernel_call(adj[None], block_i=16)[0].numpy())
    with pytest.raises(ValueError, match=r"\[n, k\]"):
        kk.butterfly_pairs_kernel_call(adj[None], block_i=16)


def test_cpu_paths_count_no_launch():
    kk.reset_launch_count()
    a = torch.from_numpy(weighted_stack(2, 16, 20, 0.3, 4, seed=2))
    kk.butterfly_pairs_windows_kernel_multiset_call(a, block_i=8)
    kk.butterfly_pairs_kernel_call(a[0], block_i=8)
    assert {k: kk.launch_count(k) for k in kk.KERNELS} == dict.fromkeys(
        kk.KERNELS, 0)


def test_window_sums_are_exact_and_batch_independent():
    """Partials past 2**24 reduce to the float32 rounding of their exact
    sum, whatever the rows around them."""
    rng = np.random.default_rng(5)
    parts = (rng.integers(0, 2**40, (7, 300)) * 0.5).astype(np.float32)
    got = tops.window_sums(torch.from_numpy(parts))
    exact = [float(np.float32(sum(int(x * 2) for x in row) / 2))
             for row in parts.astype(np.float64)]
    np.testing.assert_array_equal(got.numpy(), np.float32(exact))
    for k in range(7):
        assert float(tops.window_sums(torch.from_numpy(parts[k:k + 1]))[0]) \
            == float(got[k])


# -- the executor: planning, routing and every exact tier --------------------

@pytest.mark.parametrize("tier", ("dense", "sparse", "auto"))
@pytest.mark.parametrize("multiset", (False, True))
@pytest.mark.parametrize("align,snap", [(8, 0), (64, 16)])
def test_plan_and_cap_w_equal_reference(tier, multiset, align, snap):
    jb, tb = corpus_batches(align, multiset)
    got = tex.WindowExecutor(tier, align=align, snap=snap,
                             device=CPU).plan(tb)
    jex_ = jex.WindowExecutor(tier, align=align, snap=snap)
    want = jex_.plan(jb)
    assert [(b.cap_e, b.cap_i, b.cap_j, b.cap_w) for b in got] == [
        (b.cap_e, b.cap_i, b.cap_j, b.cap_w) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.windows, w.windows)
    ex = tex.WindowExecutor(tier, align=align, snap=snap, device=CPU)
    assert [ex.bucket_tier(b) for b in got] == [jex_.bucket_tier(b)
                                                for b in want]


def test_route_tier_equals_reference():
    for cap_e in (64, 1024, 8192):
        for cap_i in (64, 512, 4096, 50_000):
            for cap_j in (64, 700, 5120, 50_000):
                for cap_w in (0, 1024, 2**21):
                    for cost in (1.0, 96.0, 4000.0):
                        args = (cap_e, cap_i, cap_j, cap_w)
                        assert tex.route_tier(*args, sort_cost=cost) == \
                            jex.route_tier(*args, sort_cost=cost)


def test_auto_regroups_dense_routed_buckets_as_the_reference(monkeypatch):
    """A sort cost that sends every bucket to dense fuses groups that differ
    only in their wedge rung."""
    from repro_torch.streams import bipartite_pa_stream

    s = bipartite_pa_stream(6000, n_unique=1500, seed=0)
    tb = twin.windowize(s.tau, s.edge_i, s.edge_j, 50)
    jb = jwin.windowize(s.tau, s.edge_i, s.edge_j, 50)
    for cost in (1e9, 96.0, 1e-3):
        # the port's router cost is a module constant, the reference's a knob
        monkeypatch.setattr(tex, "_SORT_COST", cost)
        got = tex.WindowExecutor("auto", device=CPU).plan(tb)
        want = jex.WindowExecutor("auto", sort_cost=cost).plan(jb)
        assert [(b.cap_e, b.cap_i, b.cap_j, b.cap_w, tuple(b.windows))
                for b in got] == [(b.cap_e, b.cap_i, b.cap_j, b.cap_w,
                                   tuple(b.windows)) for b in want]


@pytest.mark.parametrize("tier", EXACT_TIERS)
@pytest.mark.parametrize("multiset", (False, True))
@pytest.mark.parametrize("align", (8, 128))
def test_tier_counts_equal_reference_on_adversarial(tier, multiset, align):
    jb, tb = corpus_batches(align, multiset)
    want = jex.WindowExecutor(tier, align=align).window_counts(jb)
    got = tex.WindowExecutor(tier, align=align, device=CPU).window_counts(tb)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    oracle = jex.WindowExecutor("numpy", align=align).window_counts(jb)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("tier", ("tiled", "pallas", "sparse", "auto"))
def test_warmup_multiset_runs_each_rung(tier):
    ex = tex.WindowExecutor(tier, device=CPU)
    assert ex.warmup([(128, 64, 64), (256, 64, 128)], multiset=True) == 2


def big_multiset_batch():
    """Windows whose multiset counts pass 2**24: hubs of multiplicity up to
    400 over a few hundred vertices."""
    rng = np.random.default_rng(11)
    edges, mults = [], []
    for _ in range(5):
        e = np.unique(np.stack([rng.integers(0, 60, 900),
                                rng.integers(0, 45, 900)], 1), axis=0)
        edges.append(e)
        mults.append(rng.integers(1, 400, len(e)))
    n = len(edges)
    return twin.pack_windows(edges, n_sgrs=np.full(n, 900),
                             cum_sgrs=900 * np.arange(1, n + 1),
                             window_end_tau=np.arange(n, dtype=np.float64),
                             align=64, dedupe=False, per_window_mult=mults)


@pytest.mark.parametrize("tier", ("pallas", "sparse"))
def test_window_count_independent_of_chunk_past_2_24(tier):
    """A window's count depends on its own data and bucket shape only, not
    on how many windows share its chunk, also past 2**24 where float32 sums
    round."""
    batch = big_multiset_batch()
    runs = [tex.WindowExecutor(tier, chunk=c, device=CPU).window_counts(batch)
            for c in (1, 2, 32)]
    assert runs[0].max() > 2**24
    for r in runs[1:]:
        np.testing.assert_array_equal(r, runs[0])
    oracle = tex.WindowExecutor("numpy", device=CPU).window_counts(batch)
    np.testing.assert_allclose(runs[0], oracle, rtol=1e-4)


def test_kernel_module_has_every_reference_name():
    """Every public name of the reference's ``butterfly_kernel`` resolves
    in the port's module of the same path, K2's wrapper by the reference's
    own name, which the package exports and ``ops`` calls."""
    import repro.kernels.butterfly.butterfly_kernel as jkk
    import repro_torch.kernels.butterfly as tk

    for name in jkk.__all__:
        assert name in kk.__all__ and callable(getattr(kk, name)), name
    name = "butterfly_pairs_windows_kernel_multiset_call"
    assert name in tk.__all__
    assert getattr(tk, name) is getattr(kk, name) is tops.__dict__[name]
    assert not hasattr(kk, "butterfly_pairs_windows_multiset_kernel_call")
