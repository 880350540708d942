"""The port's window sharding (``devices=`` / ``mesh=``) against the JAX
package's single-device counts, on repeated CPU devices in one process.

A mesh may name one device more than once; ``[cpu] * k`` runs k shards one
after another, which exercises the whole sharded dispatch (staging once,
padding to a multiple of the shard count, one slice per shard, the gather
in window order) without a card.  The reference's own sharded ``tiled``
tier fails under ``shard_map`` on this jax, so the port is held to the
reference's single-device counts.  Counts whose partial sums stay below
2**24 must be equal; the sampled tier is held to the reference within rtol
1e-6 and to the unsharded port bit for bit.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.executor as jex  # noqa: E402
import repro.core.windows as jwin  # noqa: E402
import repro.streams as jst  # noqa: E402
from repro.core.sgrapp import run_sgrapp as j_run_sgrapp  # noqa: E402
from repro.streams import bipartite_pa_stream  # noqa: E402
from repro.streams.config import EngineConfig as JConfig  # noqa: E402
import repro_torch.core.executor as tex  # noqa: E402
from repro_torch.core import windows as twin  # noqa: E402
from repro_torch.core.sgrapp import (  # noqa: E402
    run_sgrapp,
    run_sgrapp_x,
    window_exact_counts,
)
from repro_torch.distributed import batch_partition_axes  # noqa: E402
from repro_torch.kernels.butterfly import ops  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_mesh, make_window_mesh  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    MultiStreamSGrapp,
    StreamingSGrapp,
)
from repro_torch.streams.engine import config_from_bytes  # noqa: E402

from test_tier_differential import ADVERSARIAL  # noqa: E402

CPU = "cpu"
RTOL = 1e-6
NT_W = 40
MULTISET_TIERS = ("numpy", "dense", "tiled", "pallas", "sparse", "auto")


@pytest.fixture(autouse=True)
def partitionable():
    """Pin the reference to the partitionable threefry draw, which the
    port's sampled tier reproduces."""
    with jax.threefry_partitionable(True):
        yield


def cpus(k):
    return [CPU] * k


@functools.lru_cache(maxsize=None)
def stream():
    """The stream of the reference's sharded differential test."""
    return bipartite_pa_stream(2500, temporal="uniform", n_unique=600, seed=5)


@functools.lru_cache(maxsize=None)
def batches(name, multiset):
    """(reference batch, port batch) of the same windows: the stream's
    windows of ``NT_W`` timestamps, or one window per adversarial edge
    list; multiset batches carry each window's unique edges with their
    multiplicities."""
    if name == "stream":
        s = stream()
        bounds = twin.window_bounds(s.tau, NT_W)
        raw = [s.edges()[a:b] for a, b in bounds]
    else:
        raw = [np.asarray(e, np.int64) for e in ADVERSARIAL.values()]
    n = len(raw)
    kw = dict(n_sgrs=np.array([len(e) for e in raw]),
              cum_sgrs=np.cumsum([len(e) for e in raw]),
              window_end_tau=np.arange(n, dtype=np.float64), align=8)
    if multiset:
        uniq = [np.unique(e, axis=0, return_counts=True) for e in raw]
        raw = [u for u, _ in uniq]
        kw.update(dedupe=False, per_window_mult=[m for _, m in uniq])
    return jwin.pack_windows(raw, **kw), twin.pack_windows(raw, **kw)


@functools.lru_cache(maxsize=None)
def reference_counts(tier, name, multiset):
    return jex.WindowExecutor(tier, align=8).window_counts(
        batches(name, multiset)[0])


# -- counts ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ("stream", "adversarial"))
@pytest.mark.parametrize("k", (2, 3))
@pytest.mark.parametrize("tier", [t for t in tex.TIERS if t != "sampled"])
def test_sharded_counts_equal_reference_single_device(tier, k, name):
    """Every exact tier on k shards equals the reference's single-device
    count of the same tier (buckets are padded to a multiple of the shard
    count; some buckets here hold a number of windows 3 does not divide,
    so the pad windows are live)."""
    _, tb = batches(name, False)
    plan = tex.WindowExecutor(tier, align=8, device=CPU).plan(tb)
    assert any(b.n_windows % 3 for b in plan)
    ex = tex.WindowExecutor(tier, align=8, devices=cpus(k))
    assert ex.n_shards == (1 if tier == "numpy" else k)
    np.testing.assert_array_equal(ex.window_counts(tb),
                                  reference_counts(tier, name, False))


@pytest.mark.parametrize("name", ("stream", "adversarial"))
@pytest.mark.parametrize("k", (2, 3))
@pytest.mark.parametrize("tier", MULTISET_TIERS)
def test_sharded_multiset_counts_equal_reference(tier, k, name):
    _, tb = batches(name, True)
    got = tex.WindowExecutor(tier, align=8, devices=cpus(k)).window_counts(tb)
    np.testing.assert_array_equal(got, reference_counts(tier, name, True))


@pytest.mark.parametrize("k", (2, 3))
@pytest.mark.parametrize("seed", (0, 1))
def test_sharded_sampled_equals_unsharded_and_reference(k, seed):
    """Each window keeps its own coins (keyed by its uid), so sharding
    draws the same sample: bit-equal to the unsharded port, within rtol of
    the reference."""
    jb, tb = batches("stream", False)
    assert int(tb.n_edges.max()) > 64                  # sampling is real
    kw = dict(capacity=64, seed=seed, align=8)
    got = tex.WindowExecutor("sampled", devices=cpus(k), **kw
                             ).window_counts(tb)
    one = tex.WindowExecutor("sampled", device=CPU, **kw).window_counts(tb)
    np.testing.assert_array_equal(got, one)
    want = jex.WindowExecutor("sampled", **kw).window_counts(jb)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("chunk", (1, 2, 32))
def test_sharded_counts_independent_of_chunk(chunk):
    _, tb = batches("stream", False)
    got = tex.WindowExecutor("pallas", align=8, chunk=chunk,
                             devices=cpus(3)).window_counts(tb)
    np.testing.assert_array_equal(got, reference_counts("pallas", "stream",
                                                        False))


def test_staging_ring_reuses_sharded_buffers():
    ex = tex.WindowExecutor("dense", align=8, devices=cpus(3))
    a, b = batches("stream", False)[1], batches("adversarial", False)[1]
    for _ in range(3):
        np.testing.assert_array_equal(
            ex.window_counts(a), reference_counts("dense", "stream", False))
        np.testing.assert_array_equal(
            ex.window_counts(b),
            reference_counts("dense", "adversarial", False))


def test_sharded_sliding_run_and_entries():
    _, tb = batches("stream", False)
    ex = tex.WindowExecutor("pallas", align=8, devices=cpus(2))
    one = tex.WindowExecutor("pallas", align=8, device=CPU)
    for mode, span in (("tumbling", 1), ("sliding", 4)):
        got, want = ex.run(tb, mode=mode, span=span), one.run(
            tb, mode=mode, span=span)
        np.testing.assert_array_equal(got.counts, want.counts)
        assert (got.n_shards, want.n_shards) == (2, 1)
    e = stream().edges()[:300]
    assert ex.count_edges(e[:, 0], e[:, 1]) == one.count_edges(e[:, 0],
                                                               e[:, 1])
    assert ex.warmup([(128, 64, 64)]) == 1
    assert ex.warmup([(128, 64, 64)], multiset=True) == 1


def test_a_shard_failure_raises_and_is_not_hidden(monkeypatch):
    """No fallback: a failing shard's error reaches the caller."""
    _, tb = batches("stream", False)
    real = ops.butterfly_count_pallas_windows
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("shard kernel failed")
        return real(*a, **kw)

    monkeypatch.setattr(ops, "butterfly_count_pallas_windows", flaky)
    ex = tex.WindowExecutor("pallas", align=8, chunk=64, devices=cpus(2))
    with pytest.raises(RuntimeError, match="shard kernel failed"):
        ex.window_counts(tb)


@pytest.mark.parametrize("k", (2, 3, 4))
def test_pad_only_shards_are_not_dispatched(monkeypatch, k):
    """A shard whose slice of a bucket holds only pad windows launches
    nothing: a bucket of n windows runs on ceil(n / ceil(n / k)) shards."""
    _, tb = batches("stream", False)
    real = ops.butterfly_count_pallas_windows
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "butterfly_count_pallas_windows", counted)
    ex = tex.WindowExecutor("pallas", align=8, chunk=1 << 20, devices=cpus(k))
    got = ex.window_counts(tb)
    np.testing.assert_array_equal(got, reference_counts("pallas", "stream",
                                                        False))
    sizes = [len(b.windows) for b in ex.plan(tb)]
    assert len(calls) == sum(-(-n // -(-n // k)) for n in sizes)
    calls.clear()
    one = ex.window_counts(tb.take(np.array([0])))
    np.testing.assert_array_equal(one, got[:1])
    assert len(calls) == 1


def test_pending_counts_gather_in_window_order():
    _, tb = batches("stream", False)
    ex = tex.WindowExecutor("dense", align=8, devices=cpus(3))
    handle = ex.window_counts_submit(tb)
    assert not handle.done
    first = handle.reap()
    assert handle.reap() is first
    np.testing.assert_array_equal(first, reference_counts("dense", "stream",
                                                          False))


# -- the estimators ----------------------------------------------------------------

def test_run_sgrapp_on_four_shards():
    jb, tb = batches("stream", False)
    got = run_sgrapp(tb, 0.95, tier="dense", devices=cpus(4))
    one = run_sgrapp(tb, 0.95, tier="dense", device=CPU)
    want = j_run_sgrapp(jb, 0.95, tier="dense")
    np.testing.assert_array_equal(got.window_counts, one.window_counts)
    np.testing.assert_array_equal(got.estimates, one.estimates)
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)
    assert tex.WindowExecutor("dense", devices=cpus(4)).run(tb).n_shards == 4
    truths = one.estimates[:3] * 1.1
    x4 = run_sgrapp_x(tb, 0.95, truths, tier="pallas", devices=cpus(4))
    x1 = run_sgrapp_x(tb, 0.95, truths, tier="pallas", device=CPU)
    np.testing.assert_array_equal(x4.estimates, x1.estimates)
    assert x4.alpha_final == x1.alpha_final
    counts = window_exact_counts(tb, tier="tiled", mesh=make_window_mesh(
        cpus(3)))
    np.testing.assert_array_equal(counts.numpy(), one.window_counts)


# -- the knobs -----------------------------------------------------------------------

def test_knob_errors():
    _, tb = batches("adversarial", False)
    ex = tex.WindowExecutor("dense", device=CPU)
    with pytest.raises(ValueError, match="not both"):
        tex.WindowExecutor("dense", devices=cpus(2),
                           mesh=make_window_mesh(cpus(2)))
    for kw in (dict(devices=cpus(2)), dict(mesh=make_window_mesh(cpus(2)))):
        with pytest.raises(ValueError, match="conflict with executor"):
            run_sgrapp(tb, 0.9, executor=ex, **kw)
        with pytest.raises(ValueError, match="conflict with executor"):
            StreamingSGrapp(NT_W, 0.9, config=EngineConfig(**kw), executor=ex)
    n_cards = torch.cuda.device_count()
    with pytest.raises(ValueError if n_cards else RuntimeError,
                       match="outside" if n_cards else "no CUDA device"):
        tex.WindowExecutor("dense", devices=n_cards + 1)
    with pytest.raises(ValueError, match="outside"):
        tex.WindowExecutor("dense", devices=0)
    with pytest.raises(ValueError, match="empty"):
        tex.WindowExecutor("dense", devices=[])
    with pytest.raises(ValueError, match="first device"):
        tex.WindowExecutor("dense", devices=cpus(2), device="cuda")
    ok = tex.WindowExecutor("dense", devices=cpus(2), device=CPU)
    assert ok.device == torch.device(CPU) and ok.n_shards == 2


def test_numpy_tier_ignores_the_sharding():
    _, tb = batches("stream", False)
    ex = tex.WindowExecutor("numpy", devices=cpus(3))
    assert ex.n_shards == 1 and ex.device == torch.device(CPU)
    assert ex.run(tb).n_shards == 1


def test_mesh_and_sharder():
    m = make_mesh((2, 3), ("data", "model"), cpus(6))
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.axis_names == ("data", "model")
    assert m.devices.shape == (2, 3)
    assert m.axis_devices("model", data=1) == [torch.device(CPU)] * 3
    assert batch_partition_axes(m) == ("data",)
    rep = make_mesh((2, 2), ("replica", "model"), cpus(4))
    assert batch_partition_axes(rep) == ("replica",)
    pod = Mesh(np.array(cpus(8), dtype=object).reshape(2, 2, 2),
               ("pod", "data", "model"))
    assert batch_partition_axes(pod) == ("pod", "data")
    flat = make_mesh((4,), ("x",), cpus(4))
    assert batch_partition_axes(flat) == ("x",)
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), cpus(3))
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(cpus(2), dtype=object), ("data", "model"))
    with pytest.raises(ValueError, match="no axis"):
        m.axis_devices("replica")
    # windows shard over the data axes only, replicated over "model"
    ex = tex.WindowExecutor("dense", mesh=m)
    assert ex.n_shards == 2 and ex.device == torch.device(CPU)
    assert tex.WindowExecutor("dense", mesh=pod).n_shards == 4
    assert tex.WindowExecutor("dense", mesh=flat).n_shards == 4
    one = make_mesh((1, 2), ("data", "model"), cpus(2))
    assert tex.WindowExecutor("dense", mesh=one).n_shards == 1
    _, tb = batches("stream", False)
    np.testing.assert_array_equal(
        tex.WindowExecutor("sparse", align=8, mesh=pod).window_counts(tb),
        reference_counts("sparse", "stream", False))


def test_window_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the first-N-cards form is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_window_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_window_mesh(["cuda"])


# -- the engines ---------------------------------------------------------------------

def push(eng, s, mb, start=0, stop=None):
    stop = len(s) if stop is None else stop
    for a in range(start, stop, mb):
        b = min(a + mb, stop)
        eng.push(s.tau[a:b], s.edge_i[a:b], s.edge_j[a:b])
    return eng


@pytest.mark.parametrize("tier", ("pallas", "dense"))
def test_sharded_engine_checkpoint_restores_unsharded_and_in_reference(tier):
    s = stream()
    cut = len(s) // 2
    sharded = EngineConfig(tier=tier, flush_every=3, devices=cpus(3))
    plain = EngineConfig(tier=tier, flush_every=3, device=CPU)
    eng = push(StreamingSGrapp(NT_W, 0.95, config=sharded), s, 97, stop=cut)
    assert eng.executor.n_shards == 3
    want = push(StreamingSGrapp(NT_W, 0.95, config=plain), s, 97).finalize()
    sd = eng.state_dict()
    assert sharded.to_json() == plain.to_json()
    assert config_from_bytes(sd["config"]) == plain.to_json()
    into_port = StreamingSGrapp.from_state_dict(sd, device=CPU)
    assert into_port.executor.n_shards == 1
    into_ref = jst.StreamingSGrapp.from_state_dict(sd)
    for rest in (eng, into_port):
        got = push(rest, s, 97, start=cut).finalize()
        np.testing.assert_array_equal(got.window_counts, want.window_counts)
        np.testing.assert_array_equal(got.estimates, want.estimates)
    ref = push(into_ref, s, 97, start=cut).finalize()
    np.testing.assert_array_equal(ref.window_counts, want.window_counts)
    np.testing.assert_allclose(ref.estimates, want.estimates, rtol=RTOL)
    # the reference's sharded-engine config differs from its plain one only
    # in knobs it never serializes, as the port's
    assert JConfig(tier=tier, devices=2).to_json() == JConfig(
        tier=tier).to_json()


def test_sharded_multiset_engine_and_fleet_equal_unsharded():
    s = stream()
    cfg = dict(tier="pallas", dup_policy="multiset", flush_every=4)
    got = push(StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
        devices=cpus(2), **cfg)), s, 64).finalize()
    want = push(StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
        device=CPU, **cfg)), s, 64).finalize()
    np.testing.assert_array_equal(got.window_counts, want.window_counts)
    np.testing.assert_array_equal(got.estimates, want.estimates)
    fleets = []
    for kw in (dict(devices=cpus(3)), dict(device=CPU)):
        fleet = MultiStreamSGrapp(2, NT_W, 0.95, config=EngineConfig(
            tier="dense", flush_every=5, **kw))
        for a in range(0, len(s), 128):
            b = min(a + 128, len(s))
            for sid in (0, 1):
                fleet.push(sid, s.tau[a:b], s.edge_i[a:b], s.edge_j[a:b])
        fleets.append(fleet.finalize())
    for g, w in zip(*fleets):
        np.testing.assert_array_equal(g.window_counts, w.window_counts)
        np.testing.assert_array_equal(g.estimates, w.estimates)
