"""The port's sampled (FLEET) tier and ``core/fleet.py`` against the
reference.

The coins first: ``prng_key`` / ``fold_in`` / ``uniform_bits`` equal
``jax.random``'s bits on 10**4 (key, i, j) triples, with the reference
pinned to the partitionable threefry draw (``jax.threefry_partitionable
(True)``, jax's default since 0.5), so the tests hold on any jax the
project admits.  Then ``gamma_ladder`` (the rung ``k`` equal on a sweep of
``t``; the power ``p`` bit-equal at every rung above 1e-12 for gamma in
{0.3, 0.5, 0.7, 0.9}, within one ulp elsewhere), ``sample_keep_mask``
(equal masks), the sampled tier's window counts (within rtol 1e-6; they
come out equal), the reservoir's final state and estimate (equal), and the
FLEET baselines (equal: they draw the same numpy coins).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.core.executor as jex  # noqa: E402
import repro.core.fleet as jf  # noqa: E402
import repro.streams as jst  # noqa: E402
from jax._src.prng import threefry_2x32  # noqa: E402
from repro.streams.config import EngineConfig as JConfig  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
import repro_torch.core.fleet as tf  # noqa: E402
from repro_torch.core.butterfly import count_butterflies_np  # noqa: E402
from repro_torch.core.sgrapp import run_sgrapp  # noqa: E402
from repro_torch.core.windows import pack_windows, windowize  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    StreamingSGrapp,
    bipartite_pa_stream,
    synthetic_rating_stream,
)

from test_tier_differential import ADVERSARIAL  # noqa: E402

CPU = "cpu"
RTOL = 1e-6
NT_W = 40


@pytest.fixture(autouse=True)
def partitionable():
    """Pin the reference to the partitionable threefry draw, which the port
    reproduces (jax's default since 0.5; older jax defaults to the legacy
    draw)."""
    with jax.threefry_partitionable(True):
        yield


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.int64))


# -- the coins ---------------------------------------------------------------

def test_known_draw():
    """``fold_in^4(PRNGKey(0); 0, 5, 17, 42)``: raw draw 1949598912, float32
    bits 1055418632 under the partitionable draw."""
    k = tf.prng_key(0, CPU)
    for x in (0, 5, 17, 42):
        k = tf.fold_in(k, x)
    bits = tf.uniform_bits(k)
    assert int(bits) == 1949598912
    u = tf.edge_uniforms(tf.prng_key(0, CPU), torch.tensor(0),
                         torch.tensor(5))
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 0), 5)
    assert np.float32(u).view(np.int32) == np.asarray(
        jax.random.uniform(jk, (), jnp.float32)).view(np.int32)
    k2 = tf.prng_key(0, CPU)
    for x in (0, 5, 17, 42):
        k2 = tf.fold_in(k2, x)
    assert tf._bits_to_unit(tf.uniform_bits(k2)).numpy().view(
        np.int32) == 1055418632


def test_threefry2x32_equals_jax():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, (2, 5000), dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2**32, (2, 5000), dtype=np.uint64).astype(np.uint32)
    for a in range(0, 5000, 1000):
        want = np.asarray(jax.vmap(lambda kk, xx: threefry_2x32(kk, xx))(
            jnp.asarray(k[:, a:a + 1000].T), jnp.asarray(x[:, a:a + 1000].T)))
        o1, o2 = tf.threefry2x32(_t(k[0, a:a + 1000]), _t(k[1, a:a + 1000]),
                                 _t(x[0, a:a + 1000]), _t(x[1, a:a + 1000]))
        np.testing.assert_array_equal(o1.numpy(), want[:, 0].astype(np.int64))
        np.testing.assert_array_equal(o2.numpy(), want[:, 1].astype(np.int64))


@pytest.mark.parametrize("seed", (0, 1, 3, 7, 12345, 2**31 - 1, 2**31,
                                  2**32 - 1, -1, -3))
def test_prng_key_equals_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    got = [int(v) for v in tf.prng_key(seed, CPU)]
    assert got == list(want)


def test_coins_never_move_lanes_between_devices():
    """A key and its data on two devices raise: the coins never copy lanes
    to the key's device (``meta`` stands in for a second device here)."""
    key = tf.prng_key(0, CPU)
    other = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="one device"):
        tf.fold_in(key, other)
    with pytest.raises(ValueError, match="one device"):
        tf.edge_uniforms(key, other, other)
    with pytest.raises(ValueError, match="one device"):
        tf.window_keys(other, 0, 3, CPU)
    with pytest.raises(ValueError, match="key halves"):
        tf.fold_in((key[0], key[1].to("meta")), 1)
    with pytest.raises(TypeError, match="tensor"):
        tf.gamma_ladder(0.5, 0.7)


@pytest.mark.parametrize("entry", (
    lambda: tf.prng_key(0)[0],
    lambda: tf.window_keys(1, 2, 3)[0],
    lambda: tf.gamma_powers(0.7),
), ids=("prng_key", "window_keys", "gamma_powers"))
def test_coin_entries_default_to_the_card(entry):
    """Without ``device=`` the coins' entries build on the card, and raise
    where there is none."""
    if torch.cuda.is_available():
        assert entry().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_fold_in_and_uniform_bits_equal_jax_on_10k_triples():
    rng = np.random.default_rng(1)
    n = 10_000
    seeds = rng.integers(0, 2**31, n)
    ii = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    jj = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)

    @jax.jit
    def ref(s, i, j):
        def one(s, i, j):
            k = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(s), i), j)
            return (k, jax.random.bits(k, (), jnp.uint32),
                    jax.random.uniform(k, (), jnp.float32))
        return jax.vmap(one)(s, i, j)

    keys, bits, u = (np.asarray(a) for a in ref(
        jnp.asarray(seeds, jnp.int32), jnp.asarray(ii), jnp.asarray(jj)))
    key = (torch.zeros(n, dtype=torch.int64), _t(seeds))
    k = tf.fold_in(tf.fold_in(key, _t(ii)), _t(jj))
    np.testing.assert_array_equal(k[0].numpy(), keys[:, 0].astype(np.int64))
    np.testing.assert_array_equal(k[1].numpy(), keys[:, 1].astype(np.int64))
    np.testing.assert_array_equal(tf.uniform_bits(k).numpy(),
                                  bits.astype(np.int64))
    got = tf.edge_uniforms(key, _t(ii), _t(jj)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), u.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_edge_uniforms_equal_reference_per_window_key():
    rng = np.random.default_rng(2)
    ei = rng.integers(0, 500, 3000).astype(np.int32)
    ej = rng.integers(0, 700, 3000).astype(np.int32)
    jkey = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(9), 3),
                              123456)
    want = np.asarray(jf.edge_uniforms(jkey, jnp.asarray(ei),
                                       jnp.asarray(ej)))
    key = tf.window_keys(3, 123456, 9, CPU)
    got = tf.edge_uniforms(key, _t(ei), _t(ej)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- the ladder --------------------------------------------------------------

def _sweep_t(gamma, rng):
    return np.concatenate([
        rng.random(20000).astype(np.float32),
        (rng.integers(0, 2**23, 20000) / 2**23).astype(np.float32),
        np.array([0, 1, np.inf, 1e-30, 0.7, 0.49, 2.0**-10], np.float32),
        tf.gamma_powers(gamma, CPU).numpy()[:200],
    ])


@pytest.mark.parametrize("gamma", (0.3, 0.5, 0.7, 0.9, 0.99))
def test_gamma_ladder_rung_equals_reference(gamma):
    """The rung k is equal on the whole sweep; the power p is bit-equal at
    every t above 1e-12 for gamma <= 0.9 and within one ulp everywhere.
    (XLA's float32 ``pow`` on the CPU is off the correctly rounded power by
    one ulp at a few rungs: for 0.7 first at k = 95, p ~ 2e-15; for 0.99
    from k = 349, p ~ 0.03.)"""
    t = _sweep_t(gamma, np.random.default_rng(1))
    kr, pr = (np.asarray(a) for a in jax.vmap(
        lambda x: jf.gamma_ladder(x, gamma))(jnp.asarray(t)))
    kt, pt = tf.gamma_ladder(torch.from_numpy(t), gamma)
    np.testing.assert_array_equal(kt.numpy(), kr)
    ulps = np.abs(pt.numpy().view(np.int32).astype(np.int64)
                  - pr.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    if gamma <= 0.9:
        assert (ulps[t > 1e-12] == 0).all()
    k, p = tf.gamma_ladder(torch.tensor(0.0), gamma)
    assert (int(k), float(p)) == (tf._K_MAX, 0.0)
    k, p = tf.gamma_ladder(torch.tensor(float("inf")), gamma)
    assert (int(k), float(p)) == (0, 1.0)


@pytest.mark.parametrize("gamma", (0.5, 0.7, 0.9))
def test_gamma_powers_table_against_xla(gamma):
    """The host table of float32 powers: XLA's ``jnp.power`` flushes
    subnormal powers to 0 and so does the table; every normal power is
    within one ulp of XLA's."""
    table = tf.gamma_powers(gamma, CPU).numpy()
    xla = np.asarray(jnp.power(jnp.float32(gamma),
                               jnp.arange(len(table), dtype=jnp.float32)))
    assert table[-1] == 0 and xla[-1] == 0 and (table[:-1] > 0).all()
    ulps = np.abs(table.view(np.int32).astype(np.int64)
                  - xla.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_subsample_cutoff_equals_reference():
    rng = np.random.default_rng(3)
    u = rng.random(500).astype(np.float32)
    v = rng.random(500) > 0.3
    for cap in (1, 10, 349, 350, 499, 500, 1000):
        want = float(jf.subsample_cutoff(jnp.asarray(u), jnp.asarray(v),
                                         cap))
        got = float(tf.subsample_cutoff(torch.from_numpy(u),
                                        torch.from_numpy(v), cap))
        assert got == want or (np.isinf(got) and np.isinf(want))


def _corpus_lanes(cap_e=700):
    rows = []
    for edges in ADVERSARIAL.values():
        e = np.asarray(edges, dtype=np.int32)
        ei = np.zeros(cap_e, np.int32)
        ej = np.zeros(cap_e, np.int32)
        v = np.zeros(cap_e, bool)
        ei[:len(e)], ej[:len(e)], v[:len(e)] = e[:, 0], e[:, 1], True
        rows.append((ei, ej, v))
    return rows


@pytest.mark.parametrize("capacity", (8, 30, 64, 200))
@pytest.mark.parametrize("seed", (0, 5))
def test_sample_keep_mask_equals_reference(capacity, seed):
    rows = _corpus_lanes()
    for w, (ei, ej, v) in enumerate(rows):
        jk, jp = jf.sample_keep_mask(jnp.asarray(ei), jnp.asarray(ej),
                                     jnp.asarray(v), jnp.uint32(w),
                                     jnp.uint32(1000 + w), capacity=capacity,
                                     gamma=0.7, seed=seed)
        tk, tp = tf.sample_keep_mask(torch.from_numpy(ei),
                                     torch.from_numpy(ej),
                                     torch.from_numpy(v), w, 1000 + w,
                                     capacity=capacity, gamma=0.7, seed=seed)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert float(tp) == float(jp)
        assert int(tk.sum()) <= capacity
    # the batched form ([B, cap_e] lanes, [B] uid halves) is the same mask
    ei, ej, v = (torch.from_numpy(np.stack(x)) for x in zip(*rows))
    b = ei.shape[0]
    bk, bp = tf.sample_keep_mask(ei, ej, v, torch.arange(b),
                                 torch.arange(b) + 1000, capacity=capacity,
                                 gamma=0.7, seed=seed)
    for w in range(b):
        tk, tp = tf.sample_keep_mask(ei[w], ej[w], v[w], w, 1000 + w,
                                     capacity=capacity, gamma=0.7, seed=seed)
        assert torch.equal(bk[w], tk) and float(bp[w]) == float(tp)


# -- the sampled tier ---------------------------------------------------------

def pa_batch(n=20000, nt_w=100, seed=2):
    s = bipartite_pa_stream(n, n_unique=n // 10, seed=seed)
    return windowize(s.tau, s.edge_i, s.edge_j, nt_w)


@pytest.mark.parametrize("capacity", (64, 128, 300))
@pytest.mark.parametrize("seed", (0, 1))
def test_sampled_window_counts_equal_reference(capacity, seed):
    batch = pa_batch()
    assert int(batch.n_edges.max()) > capacity      # sampling is real
    want = jex.WindowExecutor("sampled", capacity=capacity,
                              seed=seed).window_counts(batch)
    got = tex.WindowExecutor("sampled", capacity=capacity, seed=seed,
                             device=CPU).window_counts(batch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.isfinite(got).all() and (got >= 0).all()


@pytest.mark.parametrize("align", (8, 128))
def test_sampled_degenerate_equals_dense(align):
    tau, ei, ej = [], [], []
    for k, edges in enumerate(ADVERSARIAL.values()):
        for i, j in edges:
            tau.append(float(k))
            ei.append(i)
            ej.append(j)
    batch = windowize(np.asarray(tau), np.asarray(ei), np.asarray(ej), 1,
                      align=align)
    dense = tex.WindowExecutor("dense", align=align,
                               device=CPU).window_counts(batch)
    got = tex.WindowExecutor("sampled", align=align,
                             device=CPU).window_counts(batch)
    np.testing.assert_array_equal(got, dense)


def test_sampled_count_edges_equals_reference():
    rng = np.random.default_rng(4)
    ex = tex.WindowExecutor("sampled", capacity=50, device=CPU)
    ref = jex.WindowExecutor("sampled", capacity=50)
    for _ in range(4):                 # each call draws its own uid
        ei = rng.integers(0, 30, 400)
        ej = rng.integers(0, 25, 400)
        got, want = ex.count_edges(ei, ej), ref.count_edges(ei, ej)
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert ex._online_seq == 4
    e = np.asarray(ADVERSARIAL["complete_k9_7"])
    assert tex.WindowExecutor("sampled", device=CPU).count_edges(
        e[:, 0], e[:, 1]) == count_butterflies_np(e)


def test_budget_router_equals_reference():
    batch = pa_batch()
    for kw in (dict(memory_budget=10**6), dict(memory_budget=256),
               dict(target_mape=0.05), dict(target_mape=100.0), {}):
        ex = tex.WindowExecutor("sampled", capacity=64, device=CPU, **kw)
        ref = jex.WindowExecutor("sampled", capacity=64, **kw)
        routes = [ex.bucket_tier(b) for b in ex.plan(batch)]
        assert routes == [ref.bucket_tier(b) for b in ref.plan(batch)]
        np.testing.assert_allclose(ex.window_counts(batch),
                                   ref.window_counts(batch), rtol=RTOL)
    ex = tex.WindowExecutor("sampled", capacity=64, memory_budget=10**6,
                            device=CPU)
    np.testing.assert_array_equal(
        ex.window_counts(batch),
        tex.WindowExecutor("dense", device=CPU).window_counts(batch))


def test_sampled_refuses_multiset_and_decrement():
    e = np.asarray(ADVERSARIAL["dense_random"], dtype=np.int64)
    batch = pack_windows([e], n_sgrs=np.array([len(e)]),
                         cum_sgrs=np.array([len(e)]),
                         window_end_tau=np.array([0.0]), dedupe=False,
                         per_window_mult=[np.ones(len(e), np.int64)])
    ex = tex.WindowExecutor("sampled", device=CPU)
    with pytest.raises(NotImplementedError, match="multiset"):
        ex.window_counts(batch)
    with pytest.raises(NotImplementedError, match="multiset"):
        ex.warmup([(128, 64, 64)], multiset=True)
    with pytest.raises(NotImplementedError, match="decrement"):
        ex.decrement_window_counts([e[:4]], [e[:1]], np.array([1.0]))
    with pytest.raises(NotImplementedError, match="multiset"):
        EngineConfig(tier="sampled", dup_policy="multiset", device=CPU)
    assert ex.warmup([(128, 64, 64), (16384, 64, 64)]) == 2


def test_lane_less_replay_uses_the_seed0_engine_uid():
    batch = pa_batch()
    uids = tex.WindowExecutor._batch_uids(batch)
    np.testing.assert_array_equal(uids[:, 0], 0)
    np.testing.assert_array_equal(uids[:, 1], batch.cum_sgrs)


def test_sampled_engine_streaming_equals_replay_and_reference():
    s = synthetic_rating_stream(n_users=80, n_items=60, n_edges=3000,
                                seed=9, temporal="uniform", n_unique=600)
    c = EngineConfig(tier="sampled", capacity=96, flush_every=3, device=CPU)
    eng = StreamingSGrapp(NT_W, 0.95, config=c)
    for a in range(0, len(s), 33):
        eng.push(s.tau[a:a + 33], s.edge_i[a:a + 33], s.edge_j[a:a + 33])
    res = eng.finalize()
    batch = windowize(s.tau, s.edge_i, s.edge_j, NT_W)
    replay = run_sgrapp(batch, 0.95, executor=tex.WindowExecutor(
        "sampled", capacity=96, snap=0, device=CPU))
    np.testing.assert_array_equal(res.window_counts, replay.window_counts)
    np.testing.assert_array_equal(res.estimates, replay.estimates)
    j = jst.StreamingSGrapp(NT_W, 0.95, config=JConfig(
        tier="sampled", capacity=96, flush_every=3))
    for a in range(0, len(s), 33):
        j.push(s.tau[a:a + 33], s.edge_i[a:a + 33], s.edge_j[a:a + 33])
    want = j.finalize()
    np.testing.assert_allclose(res.window_counts, want.window_counts,
                               rtol=RTOL)
    np.testing.assert_allclose(res.estimates, want.estimates, rtol=RTOL)
    assert (np.asarray(batch.n_edges) > 96).any()


# -- the reservoir -----------------------------------------------------------

def _assert_same_reservoir(got, want):
    for name in ("edge_i", "edge_j", "valid", "k"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.u.cpu().numpy().view(np.int32),
                                  np.asarray(want.u).view(np.int32))


@pytest.mark.parametrize("capacity,chunk", ((64, 100), (256, 1000),
                                            (1000, 4096)))
@pytest.mark.parametrize("seed", (0, 3))
def test_reservoir_run_equals_reference(capacity, chunk, seed):
    s = bipartite_pa_stream(6000, n_unique=1000, seed=11)
    want_est, want = jf.reservoir_run(s.edge_i, s.edge_j, capacity=capacity,
                                      gamma=0.7, seed=seed, chunk=chunk)
    got_est, got = tf.reservoir_run(s.edge_i, s.edge_j, capacity=capacity,
                                    gamma=0.7, seed=seed, chunk=chunk,
                                    device=CPU)
    _assert_same_reservoir(got, want)
    assert got_est == want_est
    assert int(got.valid.sum()) <= capacity
    # the estimate does not depend on the chunking
    other, _ = tf.reservoir_run(s.edge_i, s.edge_j, capacity=capacity,
                                gamma=0.7, seed=seed, chunk=chunk // 2 + 7,
                                device=CPU)
    assert other == got_est


def test_reservoir_ingest_dedupe_equals_reference():
    rng = np.random.default_rng(6)
    res_t = tf.reservoir_init(40, device=CPU)
    res_j = jf.reservoir_init(40)
    key_t, key_j = tf.prng_key(2, CPU), jax.random.PRNGKey(2)
    for _ in range(6):
        ci = rng.integers(0, 15, 64).astype(np.int32)
        cj = rng.integers(0, 15, 64).astype(np.int32)
        cv = rng.random(64) > 0.1
        u_j = jf.edge_uniforms(key_j, jnp.asarray(ci), jnp.asarray(cj))
        res_j = jf.reservoir_ingest(res_j, jnp.asarray(ci), jnp.asarray(cj),
                                    jnp.asarray(cv), u_j, gamma=0.7)
        u_t = tf.edge_uniforms(key_t, torch.from_numpy(ci),
                               torch.from_numpy(cj))
        res_t = tf.reservoir_ingest(res_t, torch.from_numpy(ci),
                                    torch.from_numpy(cj),
                                    torch.from_numpy(cv), u_t, gamma=0.7)
        _assert_same_reservoir(res_t, res_j)
    assert int(res_t.k) > 0


def test_reservoir_validates():
    with pytest.raises(ValueError, match="chunk"):
        tf.reservoir_run([0], [0], capacity=4, chunk=0, device=CPU)
    with pytest.raises(ValueError, match="same length"):
        tf.reservoir_run([0, 1], [0], capacity=4, device=CPU)
    with pytest.raises(ValueError, match="capacity"):
        tf.reservoir_init(0, device=CPU)
    est, res = tf.reservoir_run([], [], capacity=4, device=CPU)
    assert est == 0.0 and not res.valid.any()


# -- the FLEET baselines -----------------------------------------------------

@pytest.mark.parametrize("variant", (1, 2, 3))
def test_fleet_run_equals_reference(variant):
    s = bipartite_pa_stream(3000, n_unique=600, seed=4)
    cps = np.array([500, 1500, 3000])
    got, st = tf.fleet_run(s.edge_i, s.edge_j, variant=variant, capacity=300,
                           gamma=0.7, seed=2, checkpoints=cps)
    want, jst_ = jf.fleet_run(s.edge_i, s.edge_j, variant=variant,
                              capacity=300, gamma=0.7, seed=2,
                              checkpoints=cps)
    np.testing.assert_array_equal(got, want)
    assert st.p == jst_.p and st.n_edges == jst_.n_edges


@pytest.mark.parametrize("variant", (1, 2, 3))
def test_fleet_run_chunked_equals_reference(variant):
    s = bipartite_pa_stream(3000, n_unique=600, seed=4)
    kw = dict(variant=variant, capacity=300, gamma=0.7, seed=2, chunk=512)
    assert tf.fleet_run_chunked(s.edge_i, s.edge_j, **kw) == \
        jf.fleet_run_chunked(s.edge_i, s.edge_j, **kw)


def test_sampling_knobs_validate():
    for kw, match in ((dict(capacity=0), "capacity"),
                      (dict(capacity=True), "capacity"),
                      (dict(gamma=1.0), "gamma"), (dict(gamma=0.0), "gamma"),
                      (dict(seed=1.5), "seed")):
        args = dict(capacity=8, gamma=0.5, seed=0, **{})
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            tf.check_sampling_knobs(**args)
        with pytest.raises(ValueError, match=match):
            tex.WindowExecutor("sampled", device=CPU, **args)
    with pytest.raises(ValueError, match="variant"):
        tf.FleetState(variant=4, capacity=8, gamma=0.5)
