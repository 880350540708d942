"""The port's serving front end (``repro_torch.streams.server``) on the CPU.

Three tenants push over TCP into an in-process ``StreamServer`` on
``device="cpu"`` (the ``pallas`` tier, whose K1 runs its plain torch
version here).  Each tenant's estimates must equal a dedicated port
``MultiStreamSGrapp`` fed the same records bit for bit; against the
reference's ``StreamServer`` fed the same records the counts are equal and
the estimates within rtol 1e-6 (float32 ``pow`` may differ in the last ulp
between torch and XLA).  ``/metrics`` and ``/healthz`` carry the
reference's keys; a latency budget fuses windows closed by several tenants
into fewer dispatches; and a server of either package restores the other's
checkpoint directory and WAL.
"""
import asyncio
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.streams.config import EngineConfig as JConfig  # noqa: E402
from repro.streams.server import StreamServer as JServer  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    MultiStreamSGrapp,
    bipartite_pa_stream,
)
from repro_torch.streams.config import ServingConfig  # noqa: E402
from repro_torch.streams.faults import DurableClient  # noqa: E402
from repro_torch.streams.server import StreamServer, TenantPolicy  # noqa: E402
from repro_torch.streams.wire import (  # noqa: E402
    normalize_records,
    records_to_json,
)

NT_W = 40
ALPHA0 = 0.95
RTOL = 1e-6
N = 1200
CFG = EngineConfig(tier="pallas", device="cpu")
JCFG = JConfig(tier="numpy")
BATCHES = (37, 128, 251)


def tenant_streams(n: int = 3):
    return [bipartite_pa_stream(N, temporal="uniform", n_unique=N // 4,
                                seed=100 + s) for s in range(n)]


def records(stream, lo, hi) -> dict:
    return records_to_json(normalize_records(
        stream.tau[lo:hi], stream.edge_i[lo:hi], stream.edge_j[lo:hi]))


class Client:
    """Minimal NDJSON client of one tenant; the estimate feed is collected
    on the side."""

    @classmethod
    async def connect(cls, server, token: str) -> "Client":
        c = cls()
        c.reader, c.writer = await asyncio.open_connection(server.host,
                                                           server.port)
        c.estimates = []
        c.hello = await c.call({"type": "hello", "token": token})
        assert c.hello["type"] == "hello_ok", c.hello
        return c

    async def call(self, msg: dict) -> dict:
        self.writer.write((json.dumps(msg) + "\n").encode())
        await self.writer.drain()
        while True:
            line = await self.reader.readline()
            assert line, "server closed the connection"
            reply = json.loads(line)
            if reply.get("type") != "estimate":
                return reply
            self.estimates.append(reply)

    async def push_all(self, stream, batch: int, lo: int = 0, hi: int = N):
        for k in range(lo, hi, batch):
            reply = await self.call({"type": "push", "records":
                                     records(stream, k, min(k + batch, hi))})
            assert reply["type"] == "ack", reply

    def close(self) -> None:
        self.writer.close()


async def http_get(server, path: str) -> tuple[int, dict]:
    r, w = await asyncio.open_connection(server.host, server.http_port)
    w.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    data = await r.read()
    w.close()
    head, body = data.split(b"\r\n\r\n", 1)
    return int(head.split()[1]), json.loads(body)


def dedicated_fleet(streams, cfg=CFG):
    fleet = MultiStreamSGrapp(len(streams), NT_W, ALPHA0, config=cfg)
    for sid, s in enumerate(streams):
        fleet.push(sid, s.tau, s.edge_i, s.edge_j)
    return fleet.finalize()


async def serve_three(server_cls, cfg, streams, **kw):
    """Three tenants pushing concurrently at different batch sizes, then
    finalizing; returns the finalized messages, the clients' estimate
    feeds, and the /metrics and /healthz bodies."""
    server = await server_cls(
        nt_w=NT_W, alpha0=ALPHA0, tenants={f"t{s}": s for s in range(3)},
        config=cfg, flush_ms=1.0, **kw).start()
    clients = [await Client.connect(server, f"t{s}") for s in range(3)]
    for c in clients:
        assert (await c.call({"type": "subscribe"}))["type"] == "subscribed"
    await asyncio.gather(*[c.push_all(st, b) for c, st, b in
                           zip(clients, streams, BATCHES)])
    finals = [await c.call({"type": "finalize"}) for c in clients]
    await asyncio.sleep(0.05)
    status_m, metrics = await http_get(server, "/metrics")
    status_h, health = await http_get(server, "/healthz")
    assert status_m == status_h == 200
    assert (await http_get(server, "/nope"))[0] == 404
    for c in clients:
        c.close()
    await server.stop(checkpoint=False)
    return finals, [c.estimates for c in clients], metrics, health


def test_three_tenants_bit_identical_and_equal_to_the_reference():
    streams = tenant_streams()
    finals, feeds, _, _ = asyncio.run(serve_three(StreamServer, CFG,
                                                  streams))
    jfinals, _, _, _ = asyncio.run(serve_three(JServer, JCFG, streams))
    for msg, feed, ref, jmsg in zip(finals, feeds, dedicated_fleet(streams),
                                    jfinals):
        assert msg["type"] == "finalized"
        est = np.asarray(msg["estimates"], dtype=np.float32)
        np.testing.assert_array_equal(est, ref.estimates)
        np.testing.assert_array_equal(msg["counts"], ref.window_counts)
        np.testing.assert_array_equal(msg["cum_sgrs"], ref.cum_edges)
        assert np.float32(msg["alpha_final"]) == np.float32(ref.alpha_final)
        # the reference's server on the same records
        np.testing.assert_array_equal(msg["counts"], jmsg["counts"])
        np.testing.assert_array_equal(msg["cum_sgrs"], jmsg["cum_sgrs"])
        np.testing.assert_allclose(est, np.asarray(jmsg["estimates"],
                                                   dtype=np.float32),
                                   rtol=RTOL)
        # the subscribe feed saw the counted windows in order
        assert [e["window"] for e in feed] == list(range(len(feed)))
        np.testing.assert_array_equal(
            np.asarray([e["estimate"] for e in feed], np.float32),
            est[:len(feed)])


def key_tree(obj):
    """The nested key structure of a JSON body, with each value's type."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return type(obj).__name__ if obj is not None else "null"


def test_metrics_and_healthz_carry_the_reference_keys():
    streams = tenant_streams()
    _, _, metrics, health = asyncio.run(serve_three(StreamServer, CFG,
                                                    streams))
    _, _, jmetrics, jhealth = asyncio.run(serve_three(JServer, JCFG,
                                                      streams))
    assert key_tree(metrics).keys() == key_tree(jmetrics).keys()
    for k in ("aggregate", "tenants", "supervision", "wal"):
        assert key_tree(metrics[k]) == key_tree(jmetrics[k]), k
    assert health.keys() == jhealth.keys()
    assert health["status"] == "ok" and health["n_streams"] == 3
    agg = metrics["aggregate"]
    assert agg["edges_accepted"] == 3 * N
    assert agg["windows_closed"] == jmetrics["aggregate"]["windows_closed"]
    assert agg["push_latency_ms"]["p99"] >= agg["push_latency_ms"]["p50"]
    assert metrics["windows_counted"] == jmetrics["windows_counted"]


def test_latency_budget_fuses_windows_into_fewer_dispatches():
    """With a latency budget the server owns dispatch (``defer_dispatch``):
    windows closed by several tenants within the deadline fuse into one
    dispatch, the deadline timer fires it without new traffic, and every
    tenant still equals its dedicated engine bit for bit."""
    streams = tenant_streams()

    async def scenario():
        server = StreamServer(
            nt_w=NT_W, alpha0=ALPHA0, tenants={f"t{s}": s for s in range(3)},
            config=CFG.replace(flush_every=1), flush_ms=1.0,
            latency_budget_ms=40.0)
        assert server.engine.defer_dispatch is True
        await server.start()
        clients = [await Client.connect(server, f"t{s}") for s in range(3)]
        await asyncio.gather(*[c.push_all(st, b) for c, st, b in
                               zip(clients, streams, BATCHES)])
        await asyncio.sleep(0.3)    # past the budget, no new traffic
        _, m = await http_get(server, "/metrics")
        agg = m["aggregate"]
        finals = [await c.call({"type": "finalize"}) for c in clients]
        for c in clients:
            c.close()
        await server.stop(checkpoint=False)
        return agg, finals

    agg, finals = asyncio.run(scenario())
    assert agg["windows_closed"] > 0
    assert agg["windows_dispatched"] == agg["windows_closed"]
    assert 1 <= agg["dispatch_count"] < agg["windows_closed"]
    assert agg["coalesced_windows_per_dispatch"] > 1.0
    for msg, ref in zip(finals, dedicated_fleet(streams)):
        np.testing.assert_array_equal(
            np.asarray(msg["estimates"], np.float32), ref.estimates)


def test_without_a_budget_the_engine_dispatches_itself():
    server = StreamServer(nt_w=NT_W, alpha0=ALPHA0, tenants={"a": 0},
                          config=CFG)
    assert server.engine.defer_dispatch is False
    assert server.engine.device.type == "cpu"


@pytest.mark.parametrize("first,second", [("port", "reference"),
                                          ("reference", "port")])
def test_checkpoint_and_wal_restore_across_packages(tmp_path, first,
                                                    second):
    """One package's server checkpoints a third of each stream, restarts
    and takes another third into its WAL only (no checkpoint at stop); the
    other package's server recovers checkpoint + WAL, takes the rest, and
    every tenant equals a dedicated fleet."""
    streams = tenant_streams()
    make = {"port": lambda: StreamServer(**kw, config=CFG,
                                         serving=ServingConfig(
                                             wal_fsync=False)),
            "reference": lambda: JServer(**kw, config=JCFG)}
    kw = dict(nt_w=NT_W, alpha0=ALPHA0,
              tenants={f"t{s}": s for s in range(3)}, flush_ms=1.0,
              checkpoint_dir=str(tmp_path / "ckpt"))
    cuts = (0, N // 3, 2 * N // 3, N)

    async def leg(which, part, *, checkpoint, finalize=False):
        server = await make[which]().start()
        if part > 0:
            assert server._recovered
        if part == 2:   # the third leg replays the second leg's WAL
            assert server._wal.stats()["replayed"] == 3 * len(
                range(cuts[1], cuts[2], 100))
        clients = [DurableClient(server.host, server.port, f"t{s}")
                   for s in range(3)]
        for c, st in zip(clients, streams):
            await c.connect()
            for k in range(cuts[part], cuts[part + 1], 100):
                ack = await c.push(records(st, k, min(k + 100,
                                                      cuts[part + 1])))
                assert ack["type"] == "ack" and "duplicate" not in ack
        out = ([await c.call({"type": "finalize"}) for c in clients]
               if finalize else None)
        for c in clients:
            c.close()
        await server.stop(checkpoint=checkpoint)
        return out

    asyncio.run(leg(first, 0, checkpoint=True))
    asyncio.run(leg(first, 1, checkpoint=False))
    finals = asyncio.run(leg(second, 2, checkpoint=False, finalize=True))
    for msg, ref in zip(finals, dedicated_fleet(streams)):
        np.testing.assert_array_equal(msg["counts"], ref.window_counts)
        np.testing.assert_array_equal(msg["cum_sgrs"], ref.cum_edges)
        np.testing.assert_allclose(np.asarray(msg["estimates"], np.float32),
                                   ref.estimates, rtol=RTOL)


def test_constructor_validation():
    with pytest.raises(ValueError, match="at least one token"):
        StreamServer(nt_w=NT_W, alpha0=1.0, tenants={}, config=CFG)
    with pytest.raises(ValueError, match="exactly 0..N-1"):
        StreamServer(nt_w=NT_W, alpha0=1.0, tenants={"a": 0, "b": 2},
                     config=CFG)
    with pytest.raises(TypeError, match="EngineConfig"):
        StreamServer(nt_w=NT_W, alpha0=1.0, tenants={"a": 0},
                     config={"tier": "numpy"})
    with pytest.raises(TypeError, match="ServingConfig"):
        StreamServer(nt_w=NT_W, alpha0=1.0, tenants={"a": 0}, config=CFG,
                     serving={"wal": False})
    with pytest.raises(ValueError, match="queue_limit"):
        StreamServer(nt_w=NT_W, alpha0=1.0, tenants={"a": 0}, config=CFG,
                     queue_limit=0)
    srv = StreamServer(nt_w=NT_W, alpha0=1.0, config=CFG, tenants={
        "a": TenantPolicy(stream_id=0, max_records_per_s=10.0)})
    assert srv._buckets["a"].burst == 20.0
