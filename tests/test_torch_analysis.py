"""The port's SS3 analysis toolkit and its butterfly helpers against the JAX
package's, on the CPU.

The inputs are the stream of ``tests/test_fleet_analysis.py`` (made with
numpy from a seed) and the adversarial window corpus.  The analysis and the
numpy helpers are the same numpy arithmetic in both packages, so results
must be equal, not close.  ``butterfly_support_dense`` is a float32 Gram in
both; its integer supports stay below 2**24 here, so it too must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.analysis as jan  # noqa: E402
import repro.core.butterfly as jbf  # noqa: E402
from repro.streams import bipartite_pa_stream  # noqa: E402
import repro_torch.core.analysis as tan  # noqa: E402
import repro_torch.core.butterfly as tbf  # noqa: E402

from test_tier_differential import ADVERSARIAL  # noqa: E402

PREFIXES = (600, 1200, 2000)


@pytest.fixture(scope="module")
def stream():
    return bipartite_pa_stream(3000, seed=0, n_unique=800)


def assert_equal(got, want):
    """Equal values, nan equal to nan, through dicts, tuples and lists."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_analysis_exports_the_reference_names():
    assert tan.__all__ == jan.__all__
    assert len(tan.__all__) == 11
    for name in tan.__all__:
        assert callable(getattr(tan, name))


# -- SS3.2: growth curve and fits ---------------------------------------------

@pytest.mark.parametrize("max_edges,stride", [(1500, 100), (2500, 100),
                                              (5000, 50)])
def test_growth_curve_and_power_law_equal_reference(stream, max_edges, stride):
    got = tan.butterfly_growth_curve(stream.edge_i, stream.edge_j,
                                     max_edges=max_edges, stride=stride)
    want = jan.butterfly_growth_curve(stream.edge_i, stream.edge_j,
                                      max_edges=max_edges, stride=stride)
    assert_equal(got, want)
    assert_equal(tan.fit_power_law(*got), jan.fit_power_law(*want))


def test_power_law_degenerate_input_equals_reference():
    x, y = np.array([1.0, 2.0]), np.array([0.0, 5.0])
    assert_equal(tan.fit_power_law(x, y), jan.fit_power_law(x, y))


def test_polynomial_fits_equal_reference(stream):
    t, b = tan.butterfly_growth_curve(stream.edge_i, stream.edge_j,
                                      max_edges=1500, stride=100)
    got, want = tan.fit_polynomials(t, b), jan.fit_polynomials(t, b)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        assert_equal(dataclasses.astuple(g), dataclasses.astuple(w))


# -- SS3.3: hubs ---------------------------------------------------------------

@pytest.mark.parametrize("deg", [[0, 1, 1, 2, 9], [0, 0, 0], [3, 3, 3],
                                 list(range(20))])
def test_hub_mask_equals_reference(deg):
    deg = np.asarray(deg)
    assert_equal(tan.hub_mask(deg), jan.hub_mask(deg))


@pytest.mark.parametrize("n", PREFIXES)
def test_hub_fractions_and_exponent_equal_reference(stream, n):
    args = (stream.edge_i[:n], stream.edge_j[:n], stream.n_i, stream.n_j)
    assert_equal(tan.butterfly_hub_fractions(*args),
                 jan.butterfly_hub_fractions(*args))
    full = (stream.edge_i, stream.edge_j, stream.n_i, stream.n_j, n)
    assert_equal(tan.hub_probability_exponent(*full),
                 jan.hub_probability_exponent(*full))


def test_hub_fractions_without_butterflies_equal_reference():
    e = np.asarray(ADVERSARIAL["i_hub_star"])
    args = (e[:, 0], e[:, 1], 1, 37)
    assert_equal(tan.butterfly_hub_fractions(*args),
                 jan.butterfly_hub_fractions(*args))
    assert np.isnan(tan.hub_probability_exponent(*args, len(e)))


@pytest.mark.parametrize("n", PREFIXES)
def test_degree_support_correlation_equals_reference(stream, n):
    args = (stream.edge_i[:n], stream.edge_j[:n], stream.n_i, stream.n_j)
    assert_equal(tan.degree_support_correlation(*args),
                 jan.degree_support_correlation(*args))


@pytest.mark.parametrize("n", (0, 500, 1500, 3000))
def test_hub_connection_fraction_equals_reference(stream, n):
    deg = np.bincount(stream.edge_i[:n], minlength=stream.n_i)
    assert tan.hub_connection_fraction(deg, n) == \
        jan.hub_connection_fraction(deg, n)


@pytest.mark.parametrize("quantile", (0.1, 0.25, 0.5))
def test_young_old_hubs_equal_reference(stream, quantile):
    n = 2000
    deg = np.bincount(stream.edge_i[:n], minlength=stream.n_i)
    vertex_ts = np.full(stream.n_i, np.inf)
    for t in range(n):
        if vertex_ts[stream.edge_i[t]] == np.inf:
            vertex_ts[stream.edge_i[t]] = stream.tau[t]
    seen = np.unique(stream.tau[:n])
    assert tan.young_old_hubs(deg, vertex_ts, seen, quantile=quantile) == \
        jan.young_old_hubs(deg, vertex_ts, seen, quantile=quantile)


# -- SS3.3: inter-arrival --------------------------------------------------------

@pytest.mark.parametrize("max_edges", (3, 800, 1200))
def test_interarrival_distribution_equals_reference(stream, max_edges):
    got = tan.interarrival_distribution(stream.tau, stream.edge_i,
                                        stream.edge_j, max_edges=max_edges)
    want = jan.interarrival_distribution(stream.tau, stream.edge_i,
                                         stream.edge_j, max_edges=max_edges)
    assert_equal(got, want)


# -- the numpy helpers -----------------------------------------------------------

def corpus_and_prefixes(stream):
    cases = [np.asarray(e, np.int64).reshape(-1, 2)
             for e in ADVERSARIAL.values()]
    cases += [stream.edges()[:n] for n in PREFIXES]
    cases.append(np.zeros((0, 2), np.int64))
    return cases


def test_numpy_helpers_equal_reference(stream):
    for e in corpus_and_prefixes(stream):
        quads = tbf.enumerate_butterflies_np(e)
        assert_equal(quads, jbf.enumerate_butterflies_np(e))
        assert quads.shape[0] == tbf.count_butterflies_np(e)
        n_i = int(e[:, 0].max()) + 1 if len(e) else 1
        n_j = int(e[:, 1].max()) + 1 if len(e) else 1
        assert_equal(tbf.butterfly_support_np(e, n_i, n_j),
                     jbf.butterfly_support_np(e, n_i, n_j))
        assert tbf.count_caterpillars_np(e) == jbf.count_caterpillars_np(e)


# -- the dense support and the snapshot ------------------------------------------

def dense_cases(stream):
    """(edges, n_i, n_j) of the corpus windows and stream prefixes, compact
    ids, each supports' sum below 2**24."""
    out = []
    for e in corpus_and_prefixes(stream)[:-1]:
        _, ci = np.unique(e[:, 0], return_inverse=True)
        _, cj = np.unique(e[:, 1], return_inverse=True)
        out.append((np.stack([ci, cj], 1), int(ci.max()) + 1,
                    int(cj.max()) + 1))
    return out


def test_support_dense_equals_reference_and_oracle(stream):
    for e, n_i, n_j in dense_cases(stream):
        adj = np.zeros((n_i, n_j), np.float32)
        adj[e[:, 0], e[:, 1]] = 1.0
        got = tbf.butterfly_support_dense(torch.from_numpy(adj))
        want = jbf.butterfly_support_dense(jnp.asarray(adj))
        oracle = tbf.butterfly_support_np(e, n_i, n_j)
        for g, w, o in zip(got, want, oracle):
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            assert o.sum() < 2**24
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), o)


@pytest.mark.parametrize("pad", (0, 5))
def test_snapshot_count_equals_reference(stream, pad):
    for e, n_i, n_j in dense_cases(stream):
        cap = len(e) + pad
        ei = np.zeros(cap, np.int32)
        ej = np.zeros(cap, np.int32)
        v = np.zeros(cap, bool)
        ei[:len(e)], ej[:len(e)], v[:len(e)] = e[:, 0], e[:, 1], True
        got = tbf.Snapshot(torch.from_numpy(ei), torch.from_numpy(ej),
                           torch.from_numpy(v), n_i, n_j).count()
        want = jbf.Snapshot(jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(v),
                            n_i, n_j).count()
        assert float(got) == float(want) == tbf.count_butterflies_np(e)
