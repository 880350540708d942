"""sGrapp / sGrapp-x replay in the port against the reference.

The quickstart stream family (``examples/quickstart.py``): counts are exact
in both packages; estimates agree within rtol 1e-6, because the float32
recurrence raises ``|E_k|**alpha`` and torch's and XLA's ``pow`` may differ
in the last ulp; sGrapp-x's adapted alpha is equal.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.sgrapp as jsg  # noqa: E402
import repro_torch.core.sgrapp as tsg  # noqa: E402
from repro.core.butterfly import count_butterflies_np  # noqa: E402
from repro.core.windows import window_bounds  # noqa: E402
from repro.streams import bipartite_pa_stream as j_pa  # noqa: E402
from repro_torch.core.executor import WindowExecutor  # noqa: E402
from repro_torch.streams import bipartite_pa_stream  # noqa: E402

CPU = "cpu"
RTOL = 1e-6   # float32 pow may differ in the last ulp between frameworks


def quickstart(n=8000, n_unique=2000, seed=0, nt_w=100):
    s = bipartite_pa_stream(n, temporal="uniform", n_unique=n_unique,
                            seed=seed)
    return s, s.windowize(nt_w)


def truths_of(s, nt_w, n_windows):
    return np.array([count_butterflies_np(s.edges()[:e])
                     for _, e in window_bounds(s.tau, nt_w)[:n_windows]],
                    dtype=float)


@pytest.fixture(scope="module")
def qs():
    s, wb = quickstart()
    ref = jsg.run_sgrapp(wb, 1.02, tier="dense")
    return s, wb, ref


def test_stream_family_matches_reference_generator():
    s, _ = quickstart()
    r = j_pa(8000, temporal="uniform", n_unique=2000, seed=0)
    np.testing.assert_array_equal(s.tau, r.tau)
    np.testing.assert_array_equal(s.edge_i, r.edge_i)


@pytest.mark.parametrize("tier", ("numpy", "dense", "pallas"))
def test_run_sgrapp_equals_reference(qs, tier):
    _, wb, ref = qs
    got = tsg.run_sgrapp(wb, 1.02, tier=tier, device=CPU)
    np.testing.assert_array_equal(got.window_counts, ref.window_counts)
    assert got.window_counts.dtype == ref.window_counts.dtype
    np.testing.assert_allclose(got.estimates, ref.estimates, rtol=RTOL)
    np.testing.assert_array_equal(got.cum_edges, ref.cum_edges)
    assert got.alpha_final == ref.alpha_final


@pytest.mark.parametrize("x_percent,alpha0", [(100, 1.02), (50, 1.02),
                                              (100, 0.9)])
def test_run_sgrapp_x_equals_reference(qs, x_percent, alpha0):
    s, wb, _ = qs
    truths = truths_of(s, 100, 12)
    want = jsg.run_sgrapp_x(wb, alpha0, truths, x_percent=x_percent,
                            tier="dense")
    got = tsg.run_sgrapp_x(wb, alpha0, truths, x_percent=x_percent,
                           tier="pallas", device=CPU)
    np.testing.assert_array_equal(got.window_counts, want.window_counts)
    np.testing.assert_allclose(got.estimates, want.estimates, rtol=RTOL)
    assert got.alpha_final == want.alpha_final
    assert got.alpha_final != alpha0          # the supervision did adapt
    assert got.mape() == pytest.approx(want.mape(), rel=1e-5)


def test_estimators_equal_reference_on_given_counts():
    rng = np.random.default_rng(4)
    wc = rng.integers(0, 5000, 60).astype(np.float32)
    ce = np.cumsum(rng.integers(50, 400, 60))
    got = tsg.sgrapp_estimate(wc, ce, 1.05, device=CPU).numpy()
    np.testing.assert_allclose(got, np.asarray(jsg.sgrapp_estimate(
        wc, ce, 1.05)), rtol=RTOL)
    truths = np.cumsum(wc) * 1.3
    mask = np.arange(60) < 30
    est, alpha = tsg.sgrapp_x_estimate(wc, ce, 1.0, truths, mask, device=CPU)
    j_est, j_alpha = jsg.sgrapp_x_estimate(wc, ce, 1.0, truths, mask)
    np.testing.assert_allclose(est.numpy(), np.asarray(j_est), rtol=RTOL)
    assert float(alpha) == float(j_alpha)


def test_window_exact_counts_on_device_and_conflicts(qs):
    _, wb, ref = qs
    ex = WindowExecutor("pallas", device=CPU)
    wc = tsg.window_exact_counts(wb, executor=ex)
    assert wc.dtype.is_floating_point and wc.device.type == "cpu"
    np.testing.assert_array_equal(wc.numpy(), ref.window_counts)
    with pytest.raises(ValueError, match="conflicts"):
        tsg.window_exact_counts(wb, tier="dense", executor=ex)


def test_mape_and_relative_errors_equal_reference(qs):
    s, wb, _ = qs
    truths = truths_of(s, 100, 10)
    got = tsg.run_sgrapp(wb, 1.02, truths=truths, tier="dense", device=CPU)
    want = jsg.run_sgrapp(wb, 1.02, truths=truths, tier="dense")
    assert got.mape() == pytest.approx(want.mape(), rel=1e-5)
    assert tsg.mape(got.estimates[:10], truths) == pytest.approx(
        jsg.mape(want.estimates[:10], truths), rel=1e-5)


def test_replay_is_deterministic_across_tiers(qs):
    _, wb, _ = qs
    a = tsg.run_sgrapp(wb, 1.02, tier="dense", device=CPU)
    b = tsg.run_sgrapp(wb, 1.02, tier="pallas", device=CPU)
    np.testing.assert_array_equal(a.estimates, b.estimates)
