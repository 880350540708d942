"""The port's host stream inputs and windowing against the reference.

Generators, the wire schema, adaptive windows and ``WindowBatch`` packing
are numpy in both packages (the port keeps its own copy), so every output
must be exactly equal on the same seeded inputs, including the
``ADVERSARIAL`` window corpus of ``tests/test_tier_differential.py``.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.butterfly as jbf  # noqa: E402
import repro.core.windows as jwin  # noqa: E402
import repro.streams.generators as jgen  # noqa: E402
import repro.streams.wire as jwire  # noqa: E402
import repro_torch.core.butterfly as tbf  # noqa: E402
import repro_torch.core.windows as twin  # noqa: E402
import repro_torch.streams.generators as tgen  # noqa: E402
import repro_torch.streams.wire as twire  # noqa: E402
from repro_torch.streams import SgrStream, dedupe_stream, stream_chunks  # noqa: E402

from test_tier_differential import ADVERSARIAL  # noqa: E402

BATCH_FIELDS = ("edge_i", "edge_j", "valid", "n_edges", "n_sgrs", "cum_sgrs",
                "n_i", "n_j", "window_end_tau", "n_i_per_window",
                "n_j_per_window", "stream_ids", "edge_mult", "sample_uid")


def assert_batches_equal(got, want):
    for f in BATCH_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def corpus_columns():
    tau, ei, ej = [], [], []
    for k, edges in enumerate(ADVERSARIAL.values()):
        for i, j in edges:
            tau.append(float(k))
            ei.append(i)
            ej.append(j)
    return np.asarray(tau), np.asarray(ei), np.asarray(ej)


GENERATORS = {
    "bipartite_pa_uniform": lambda g: g.bipartite_pa_stream(
        3000, n_unique=700, seed=3),
    "bipartite_pa_bursty": lambda g: g.bipartite_pa_stream(
        2000, temporal="bursty", seed=4),
    "synthetic_rating_wave": lambda g: g.synthetic_rating_stream(
        n_users=90, n_items=70, n_edges=1500, temporal="wave", n_unique=300,
        seed=5),
    "ba_bipartite": lambda g: g.ba_bipartite_stream(n=300, m=3, seed=6),
    "dynamic_sgr": lambda g: g.dynamic_sgr_stream(600, 5, delete_frac=0.2,
                                                  dup_frac=0.2, seed=7),
    "assign_timestamps": lambda g: g.assign_timestamps(
        500, n_unique=50, seed=8),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_equal_reference(name):
    got, want = GENERATORS[name](tgen), GENERATORS[name](jgen)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        return
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        return
    for col in ("tau", "edge_i", "edge_j", "op"):
        g, w = getattr(got, col), getattr(want, col)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("nt_w,align", [(1, 128), (25, 128), (40, 8),
                                        (100, 64)])
@pytest.mark.parametrize("drop_partial", [True, False])
def test_windowize_lanes_equal_on_pa_stream(nt_w, align, drop_partial):
    s = tgen.bipartite_pa_stream(3000, n_unique=700, seed=3)
    args = (s.tau, s.edge_i, s.edge_j, nt_w)
    got = twin.windowize(*args, align=align, drop_partial=drop_partial)
    want = jwin.windowize(*args, align=align, drop_partial=drop_partial)
    assert got.n_windows > 0
    assert_batches_equal(got, want)
    assert_batches_equal(s.windowize(nt_w, align=align,
                                     drop_partial=drop_partial), want)


@pytest.mark.parametrize("align", [8, 128])
def test_windowize_lanes_equal_on_adversarial_corpus(align):
    tau, ei, ej = corpus_columns()
    got = twin.windowize(tau, ei, ej, 1, align=align)
    want = jwin.windowize(tau, ei, ej, 1, align=align)
    assert got.n_windows == len(ADVERSARIAL)
    assert_batches_equal(got, want)


def test_pack_windows_lanes_and_take_equal():
    per = [np.asarray(e, dtype=np.int64) for e in ADVERSARIAL.values()]
    n = len(per)
    kw = dict(n_sgrs=np.arange(n) + 5, cum_sgrs=np.cumsum(np.arange(n) + 5),
              window_end_tau=np.arange(n, dtype=np.float64), align=16,
              stream_ids=np.arange(n) % 3,
              sample_uid=(np.int64(7) << 32) + np.arange(n))
    got = twin.pack_windows(per, **kw)
    want = jwin.pack_windows(per, **kw)
    assert_batches_equal(got, want)
    idx = [1, 4, 6]
    cap = int(want.n_edges[idx].max())
    assert_batches_equal(got.take(idx, capacity=cap),
                         want.take(idx, capacity=cap))
    mult = [np.full(len(e), 2) for e in per]
    assert_batches_equal(
        twin.pack_windows(per, dedupe=False, per_window_mult=mult, **kw),
        jwin.pack_windows(per, dedupe=False, per_window_mult=mult, **kw))


def test_window_ids_bounds_and_online_windows_equal():
    s = tgen.bipartite_pa_stream(2000, n_unique=500, seed=9)
    np.testing.assert_array_equal(twin.window_ids(s.tau, 30),
                                  jwin.window_ids(s.tau, 30))
    for drop in (True, False):
        np.testing.assert_array_equal(
            twin.window_bounds(s.tau, 30, drop_partial=drop),
            jwin.window_bounds(s.tau, 30, drop_partial=drop))
        got = list(twin.adaptive_window_stream(s.records(), 30,
                                               drop_partial=drop))
        want = list(jwin.adaptive_window_stream(s.records(), 30,
                                                drop_partial=drop))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad", [np.array([0.0, np.nan]),
                                 np.array([1.0, 0.0])])
def test_window_ids_reject_like_reference(bad):
    with pytest.raises(ValueError) as want:
        jwin.window_ids(bad, 2)
    with pytest.raises(ValueError) as got:
        twin.window_ids(bad, 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_numpy_oracle_equal(name):
    e = np.asarray(ADVERSARIAL[name], dtype=np.int64)
    assert tbf.count_butterflies_np(e) == jbf.count_butterflies_np(e)


def test_numpy_oracle_rejects_out_of_range_ids():
    with pytest.raises(ValueError, match="2\\*\\*32"):
        tbf.count_butterflies_np(np.array([[0, 1 << 32]]))


def test_wire_normalization_equal():
    got = twire.normalize_records([1.0, 2.0], [3, 4], [5, 6], op=[0, 0],
                                  stream_id=np.array([0, 1]))
    want = jwire.normalize_records([1.0, 2.0], [3, 4], [5, 6], op=[0, 0],
                                   stream_id=np.array([0, 1]))
    assert got.op is None and want.op is None
    np.testing.assert_array_equal(got.stream_id, want.stream_id)
    for g, w in zip(twire.as_columns([1.0], [2], [3], op=[1]),
                    jwire.as_columns([1.0], [2], [3], op=[1])):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    with pytest.raises(ValueError, match="op must be"):
        twire.normalize_records([1.0], [2], [3], op=[2])


def test_stream_helpers():
    s = SgrStream([3.0, 1.0, 2.0, 2.0], [1, 0, 1, 1], [1, 0, 2, 2])
    np.testing.assert_array_equal(s.tau, [1.0, 2.0, 2.0, 3.0])
    d = dedupe_stream(s)
    assert len(d) == 3
    assert [len(c) for c in stream_chunks(s, 3)] == [3, 1]
