"""Exactly-once recovery of the port's serving stack, on the CPU.

Two subprocess legs run the port's launcher (``python -m
repro_torch.launch.serve_streams --device cpu``) through its
``ServerProcess``, SIGKILL it at a planned fault point (after the WAL fsync
and engine apply but before the ack; between a checkpoint's tmp write and
its rename), restart it on the same state directory while the seq-retrying
``DurableClient`` pushes through the outage, and require every tenant's
estimates to equal a dedicated port ``MultiStreamSGrapp`` fed the same
records bit for bit.  The in-process legs pin the degraded modes: an
injected ``disk_full`` on the WAL rejects, degrades and recovers, and so
does a periodic checkpoint; an ``engine_apply_raise`` rejects only its item.
"""
import asyncio
import json
import socket

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    MultiStreamSGrapp,
    bipartite_pa_stream,
)
from repro_torch.streams.config import ServingConfig  # noqa: E402
from repro_torch.streams.faults import (  # noqa: E402
    DurableClient,
    FaultPlan,
    ServerProcess,
    clear_plan,
    install_plan,
)
from repro_torch.streams.server import StreamServer  # noqa: E402
from repro_torch.streams.wire import (  # noqa: E402
    normalize_records,
    records_to_json,
)
from repro_torch.train.checkpoint import latest_step  # noqa: E402
from repro_torch.train.fault import BackoffPolicy  # noqa: E402

NT_W = 30
ALPHA0 = 0.95
CFG = EngineConfig(tier="numpy", device="cpu")
FAST = ServingConfig(restart_backoff=BackoffPolicy(0.01, 0.05),
                     checkpoint_retry=BackoffPolicy(0.01, 0.05),
                     drain_timeout_s=1.0)


@pytest.fixture(autouse=True)
def _clean_plan():
    yield
    clear_plan()


def make_streams(n_tenants: int, n_edges: int, seed: int = 11):
    return [bipartite_pa_stream(n_edges, temporal="uniform",
                                n_unique=n_edges // 4, seed=seed + s)
            for s in range(n_tenants)]


def batches_of(stream, batch: int) -> list[dict]:
    return [records_to_json(normalize_records(
                stream.tau[k:k + batch], stream.edge_i[k:k + batch],
                stream.edge_j[k:k + batch]))
            for k in range(0, len(stream.tau), batch)]


def assert_equals_dedicated(finals, streams, cfg=CFG):
    fleet = MultiStreamSGrapp(len(streams), NT_W, ALPHA0, config=cfg)
    for sid, s in enumerate(streams):
        fleet.push(sid, s.tau, s.edge_i, s.edge_j)
    for msg, ref in zip(finals, fleet.finalize()):
        assert msg["type"] == "finalized", msg
        np.testing.assert_array_equal(
            np.asarray(msg["estimates"], np.float32), ref.estimates)
        np.testing.assert_array_equal(msg["counts"], ref.window_counts)
        np.testing.assert_array_equal(msg["cum_sgrs"], ref.cum_edges)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("plan,n_batches,sleep,every", [
    ({"pre_ack": {"action": "kill", "at": 5}}, 12, 0.0, None),
    ({"pre_checkpoint_rename": {"action": "kill", "at": 1}}, 20, 0.03, 0.4),
], ids=["pre_ack", "pre_checkpoint_rename"])
def test_sigkill_recovers_bit_identical(tmp_path, plan, n_batches, sleep,
                                        every):
    streams = make_streams(2, n_batches * 50)
    port, http_port = _free_port(), _free_port()
    kw = dict(nt_w=NT_W, alpha0=ALPHA0, tenants={"t0": 0, "t1": 1},
              checkpoint_dir=str(tmp_path / "ckpt"), tier="numpy",
              device="cpu", flush_ms=1.0,
              extra_args=["--port", str(port), "--http-port", str(http_port),
                          "--latency-budget-ms", "5"],
              log_path=str(tmp_path / "server.log"))

    async def scenario():
        clients = [DurableClient("127.0.0.1", port, f"t{s}")
                   for s in range(2)]

        async def push_all(c, stream):
            out = []
            for rec in batches_of(stream, 50):
                out.append(await c.push(rec))
                await asyncio.sleep(sleep)
            return out

        with ServerProcess(plan=FaultPlan(plan), checkpoint_every_s=every,
                           **kw) as first:
            first.wait_ready()
            assert first.device.startswith("cpu")
            for c in clients:
                await c.connect()
            pushers = [asyncio.create_task(push_all(c, s))
                       for c, s in zip(clients, streams)]
            assert await asyncio.to_thread(first.wait_dead, 120) == -9
            with ServerProcess(plan=None, **kw) as second:
                second.wait_ready()
                replies = await asyncio.wait_for(asyncio.gather(*pushers),
                                                 timeout=120)
                assert all(r["type"] == "ack" for rs in replies for r in rs)
                if "pre_ack" in plan:
                    # the last acked seq again: served from the rebuilt
                    # duplicate cache, not applied twice
                    dup = await clients[0].call(
                        {"type": "push", "seq": clients[0].seq,
                         "records": batches_of(streams[0], 50)[-1]})
                    assert dup["type"] == "ack" and dup["duplicate"], dup
                finals = [await c.call({"type": "finalize"})
                          for c in clients]
                for c in clients:
                    c.close()
        return finals

    finals = asyncio.run(scenario())
    assert_equals_dedicated(finals, streams)
    log = (tmp_path / "server.log").read_text()
    assert "SIGKILL at " + next(iter(plan)) in log


class Client:
    """A client that shows raw rejects (no retry)."""

    @classmethod
    async def connect(cls, server, token):
        c = cls()
        c.reader, c.writer = await asyncio.open_connection(server.host,
                                                           server.port)
        assert (await c.call({"type": "hello", "token": token}))["type"] \
            == "hello_ok"
        return c

    async def call(self, msg):
        self.writer.write((json.dumps(msg) + "\n").encode())
        await self.writer.drain()
        return json.loads(await self.reader.readline())

    async def push(self, records, seq):
        return await self.call({"type": "push", "records": records,
                                "seq": seq})


async def healthz(server) -> dict:
    r, w = await asyncio.open_connection(server.host, server.http_port)
    w.write(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
    data = await r.read()
    w.close()
    return json.loads(data.split(b"\r\n\r\n", 1)[1])


def test_engine_apply_raise_rejects_one_item_and_retry_converges(tmp_path):
    streams = make_streams(1, 900)
    batches = batches_of(streams[0], 300)

    async def scenario():
        install_plan(FaultPlan(
            {"engine_apply_raise": {"action": "raise", "at": 2}}))
        server = await StreamServer(
            nt_w=NT_W, alpha0=ALPHA0, tenants={"t0": 0}, config=CFG,
            flush_ms=1.0, serving=FAST,
            wal_dir=str(tmp_path / "wal")).start()
        c = await Client.connect(server, "t0")
        assert (await c.push(batches[0], 1))["type"] == "ack"
        reply = await c.push(batches[1], 2)
        assert reply["type"] == "reject" and reply["reason"] == "internal"
        assert server.metrics.engine_errors == 1
        reply = await c.push(batches[1], 2)      # the same seq applies now
        assert reply["type"] == "ack" and "duplicate" not in reply
        assert (await c.push(batches[2], 3))["type"] == "ack"
        final = await c.call({"type": "finalize"})
        c.writer.close()
        await server.stop(checkpoint=False)
        return final

    assert_equals_dedicated([asyncio.run(scenario())], streams)


@pytest.mark.parametrize("where", ["wal", "checkpoint"])
def test_disk_full_degrades_then_recovers(tmp_path, where):
    """``disk_full`` on the WAL rejects the push (``wal_error``) and
    degrades health until a same-seq retry lands; on a periodic checkpoint
    it counts a failure, and the retry writes the step and clears it."""
    streams = make_streams(1, 300)
    batches = batches_of(streams[0], 150)
    ckpt = str(tmp_path / "ckpt")
    wal = where == "wal"

    async def scenario():
        install_plan(FaultPlan(
            {"disk_full": {"action": "disk_full", "at": 1, "count": 1}}))
        server = await StreamServer(
            nt_w=NT_W, alpha0=ALPHA0, tenants={"t0": 0}, config=CFG,
            flush_ms=1.0, checkpoint_dir=None if wal else ckpt,
            checkpoint_every_s=None if wal else 0.05,
            wal_dir=str(tmp_path / "wal") if wal else None,
            serving=FAST.replace(wal=wal)).start()
        c = await Client.connect(server, "t0")
        if wal:
            reply = await c.push(batches[0], 1)
            assert reply["type"] == "reject" and reply["reason"] == "wal_error"
            assert server.metrics.wal_errors == 1
            health = await healthz(server)
            assert health["status"] == "degraded" and "wal" in \
                health["degraded"]
        assert (await c.push(batches[0], 1))["type"] == "ack"
        assert (await c.push(batches[1], 2))["type"] == "ack"
        if not wal:
            for _ in range(400):
                if (latest_step(ckpt) is not None
                        and "checkpoint" not in server._degraded):
                    break
                await asyncio.sleep(0.01)
            assert server.metrics.checkpoint_failures >= 1
            assert latest_step(ckpt) is not None
        health = await healthz(server)
        assert health["status"] == "ok" and health["degraded"] == []
        final = await c.call({"type": "finalize"})
        c.writer.close()
        await server.stop(checkpoint=False)
        return final

    assert_equals_dedicated([asyncio.run(scenario())], streams)
