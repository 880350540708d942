"""The engines' ``defer_dispatch`` attribute, held to the reference.

While ``defer_dispatch`` is true, ``push()`` never self-submits a flush at
the ``flush_every`` threshold: the engine's owner (the server's deadline
coalescer) schedules ``_submit_flush`` / ``_reap_flush`` itself.  The port's
single-stream and fleet engines must defer exactly as the reference's do
(the same ``n_inflight`` and ``n_pending`` after every push), never
serialize the attribute, and count the same windows once flushed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.streams.config import EngineConfig as JConfig  # noqa: E402
from repro.streams.engine import StreamingSGrapp as JEngine  # noqa: E402
from repro.streams.multi import MultiStreamSGrapp as JFleet  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    MultiStreamSGrapp,
    StreamingSGrapp,
    bipartite_pa_stream,
)

NT_W = 30
ALPHA0 = 0.95
RTOL = 1e-6


def streams(n=3):
    return [bipartite_pa_stream(700, temporal="uniform", n_unique=175,
                                seed=40 + s) for s in range(n)]


def make(kind, port: bool, defer: bool):
    knobs = dict(tier="dense", flush_every=1)
    cfg = (EngineConfig(device="cpu", **knobs) if port
           else JConfig(**knobs))
    if kind == "single":
        eng = (StreamingSGrapp if port else JEngine)(NT_W, ALPHA0, config=cfg)
    else:
        eng = (MultiStreamSGrapp if port else JFleet)(3, NT_W, ALPHA0,
                                                     config=cfg)
    eng.defer_dispatch = defer
    return eng


def drive(eng, kind, mb=40):
    """Push every stream round-robin; after each push record
    ``(n_inflight, n_pending)``."""
    ss = streams(1 if kind == "single" else 3)
    trace = []
    for a in range(0, 700, mb):
        for sid, s in enumerate(ss):
            cols = (s.tau[a:a + mb], s.edge_i[a:a + mb], s.edge_j[a:a + mb])
            if kind == "single":
                eng.push(*cols)
            else:
                eng.push(sid, *cols)
            trace.append((eng.n_inflight, eng.n_pending))
    return trace


def results(eng, kind):
    return [eng.finalize()] if kind == "single" else eng.finalize()


@pytest.mark.parametrize("kind", ["single", "fleet"])
def test_defer_dispatch_matches_the_reference(kind):
    port, ref = make(kind, True, True), make(kind, False, True)
    assert make(kind, True, False).defer_dispatch is False
    trace, want = drive(port, kind), drive(ref, kind)
    assert trace == want
    # push never dispatched: every closed window is still awaiting dispatch
    assert all(inflight == 0 for inflight, _ in trace)
    assert trace[-1][1] > 0
    assert "defer_dispatch" not in port.state_dict()
    for got, exp in zip(results(port, kind), results(ref, kind)):
        np.testing.assert_array_equal(got.window_counts, exp.window_counts)
        np.testing.assert_allclose(got.estimates, exp.estimates, rtol=RTOL)


@pytest.mark.parametrize("kind", ["single", "fleet"])
def test_deferred_engine_equals_self_dispatching_engine(kind):
    """Owner-driven dispatch changes the schedule, never a count or an
    estimate: a deferred engine flushed by its owner equals one that
    submits at every closed window, bit for bit."""
    deferred, eager = make(kind, True, True), make(kind, True, False)
    drive(deferred, kind)
    eager_trace = drive(eager, kind)
    assert any(inflight > 0 for inflight, _ in eager_trace)
    deferred.flush()
    assert deferred.n_pending == 0
    for got, exp in zip(results(deferred, kind), results(eager, kind)):
        np.testing.assert_array_equal(got.window_counts, exp.window_counts)
        np.testing.assert_array_equal(got.estimates, exp.estimates)
        np.testing.assert_array_equal(got.cum_edges, exp.cum_edges)
