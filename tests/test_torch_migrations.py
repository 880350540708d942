"""Single-stream checkpoint migrations: the reference's v1, v2 and v3
``state_dict`` schemas restore in the port.

Each old dict is built as the reference's tests build it: a v4 dict of the
reference engine with the later schemas' keys dropped and ``version`` set
back.  Restored in the port, the engine continues the stream: counts equal
the reference's exactly and estimates within rtol 1e-6 (float32 ``pow`` may
differ in the last ulp between torch and XLA), and bit for bit the port's
own engine that never checkpointed.  The migration functions equal the
reference's, leaf for leaf.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.streams as jst  # noqa: E402
import repro.streams.engine as jeng  # noqa: E402
from repro.streams.config import EngineConfig as JConfig  # noqa: E402
import repro_torch.streams.engine as teng  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    StreamingSGrapp,
    dynamic_sgr_stream,
    synthetic_rating_stream,
)

NT_W = 40
CPU = "cpu"
RTOL = 1e-6
LACKS = {1: ("buf_op", "res_seed", "config", "alpha0"),
         2: ("res_seed", "config", "alpha0"), 3: ("config", "alpha0")}


def make_stream(n=1500, seed=6):
    return synthetic_rating_stream(n_users=80, n_items=60, n_edges=n,
                                   seed=seed, temporal="uniform",
                                   n_unique=n // 5)


def push(eng, s, start=0, stop=None, mb=37):
    stop = len(s) if stop is None else stop
    for a in range(start, stop, mb):
        b = min(a + mb, stop)
        eng.push(s.tau[a:b], s.edge_i[a:b], s.edge_j[a:b])
    return eng


def old_dict(sd, version):
    out = {k: v for k, v in sd.items() if k not in LACKS[version]}
    out["version"] = np.int64(version)
    return out


@pytest.mark.parametrize("version", (1, 2, 3))
@pytest.mark.parametrize("tier", ("dense", "pallas"))
def test_old_single_stream_dicts_restore_to_the_reference_estimates(version,
                                                                    tier):
    s = make_stream()
    cut = 731                         # mid-window, not micro-batch aligned
    j = push(jst.StreamingSGrapp(NT_W, 0.95, config=JConfig(flush_every=3)),
             s, stop=cut)
    sd = j.state_dict()
    want = push(j, s, start=cut).finalize()
    mine = StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
        tier=tier, flush_every=3, device=CPU)).restore(old_dict(sd, version))
    if version == 1:
        n = int(sd["buf_len"])
        np.testing.assert_array_equal(mine._state.buf_op[0, :n],
                                      np.ones(n, np.int8))
    res = push(mine, s, start=cut).finalize()
    np.testing.assert_array_equal(res.window_counts, want.window_counts)
    np.testing.assert_array_equal(res.cum_edges, want.cum_edges)
    np.testing.assert_allclose(res.estimates, want.estimates, rtol=RTOL)
    whole = push(StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
        tier=tier, flush_every=3, device=CPU)), s).finalize()
    np.testing.assert_array_equal(res.estimates, whole.estimates)
    np.testing.assert_array_equal(res.window_counts, whole.window_counts)


def test_old_dynamic_dict_restores_with_its_op_lane():
    """A v2 dict (the first with the op lane) of a stream with deletes."""
    tau, ei, ej, op = dynamic_sgr_stream(1200, 30, delete_frac=0.1,
                                         dup_frac=0.2, n_i=40, n_j=40,
                                         seed=5)
    cut = 611
    j = jst.StreamingSGrapp(30, 0.95, config=JConfig(flush_every=2))
    j.push(tau[:cut], ei[:cut], ej[:cut], op=op[:cut])
    sd = j.state_dict()
    j.push(tau[cut:], ei[cut:], ej[cut:], op=op[cut:])
    want = j.finalize()
    assert sd["buf_op"].min() < 0           # the open window holds deletes
    mine = StreamingSGrapp(30, 0.95, config=EngineConfig(
        tier="pallas", flush_every=2, device=CPU)).restore(old_dict(sd, 2))
    mine.push(tau[cut:], ei[cut:], ej[cut:], op=op[cut:])
    res = mine.finalize()
    np.testing.assert_array_equal(res.window_counts, want.window_counts)
    np.testing.assert_allclose(res.estimates, want.estimates, rtol=RTOL)


@pytest.mark.parametrize("fleet", (False, True))
def test_migrations_equal_the_reference_leaf_for_leaf(fleet):
    if fleet:
        j = jst.MultiStreamSGrapp(2, NT_W, 0.95)
        for sid in range(2):
            j.push(sid, [0.0, 1.0, 2.0], [0, 1, 2], [0, 1, 2])
    else:
        j = jst.StreamingSGrapp(NT_W, 0.95)
        j.push([0.0, 1.0, 2.0], [0, 1, 2], [0, 1, 2])
    for version in (1, 2, 3):
        src = old_dict(j.state_dict(), version)
        got = teng.migrate_state_dict_to_latest(src, version)
        want = jeng.migrate_state_dict_to_latest(src, version)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]))
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        assert int(src["version"]) == version      # the input is untouched


@pytest.mark.parametrize("version", (1, 2, 3))
def test_each_migration_step_is_the_references(version):
    j = jst.StreamingSGrapp(NT_W, 0.95)
    j.push([0.0, 1.0, 2.0], [0, 1, 2], [0, 1, 2])
    src = old_dict(j.state_dict(), version)
    name = f"migrate_state_dict_v{version}"
    got, want = getattr(teng, name)(src), getattr(jeng, name)(src)
    assert int(got["version"]) == version + 1 == int(want["version"])
    assert set(got) == set(want)


def test_migrated_engine_behaves_as_seed0():
    """v2 engines predate the reservoir seed and behaved as seed 0."""
    j = jst.StreamingSGrapp(NT_W, 0.95)
    j.push([0.0, 1.0], [0, 1], [0, 1])
    mine = StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
        seed=5, device=CPU)).restore(old_dict(j.state_dict(), 2))
    assert int(mine._state.res_seed[0]) == 0
    mine = StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
        seed=5, device=CPU)).restore(j.state_dict())
    assert int(mine._state.res_seed[0]) == 0


def test_migration_preserves_strictness():
    eng = StreamingSGrapp(NT_W, 0.95, config=EngineConfig(device=CPU))
    eng.push([0.0], [1], [1])
    sd = eng.state_dict()
    v1_extra = dict(sd)
    v1_extra["version"] = np.int64(1)
    with pytest.raises(
            ValueError,
            match="unknown=\\['alpha0', 'buf_op', 'config', 'res_seed'\\]"):
        StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
            device=CPU)).restore(v1_extra)
    v4_cut = {k: v for k, v in sd.items() if k != "buf_op"}
    with pytest.raises(ValueError, match="missing=\\['buf_op'\\]"):
        StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
            device=CPU)).restore(v4_cut)
    no_version = {k: v for k, v in sd.items() if k != "version"}
    with pytest.raises(ValueError, match="missing=\\['version'\\]"):
        StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
            device=CPU)).restore(no_version)
    future = dict(sd)
    future["version"] = np.int64(5)
    with pytest.raises(ValueError, match="version 5"):
        StreamingSGrapp(NT_W, 0.95, config=EngineConfig(
            device=CPU)).restore(future)


def test_from_state_dict_of_a_migrated_dict_needs_a_config():
    j = jst.StreamingSGrapp(NT_W, 1.1)
    j.push([0.0, 1.0], [0, 1], [0, 1])
    v3 = old_dict(j.state_dict(), 3)
    with pytest.raises(ValueError, match="no EngineConfig"):
        StreamingSGrapp.from_state_dict(v3, device=CPU)
    eng = StreamingSGrapp.from_state_dict(
        v3, config=EngineConfig(tier="pallas", device=CPU))
    assert eng.tier == "pallas" and eng.alpha0 == np.float32(1.1)
