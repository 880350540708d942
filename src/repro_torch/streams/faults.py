"""Deterministic fault-injection harness for the durable serving stack.

The port's copy of ``repro.streams.faults``.  It extends the control-plane
policy skeleton in :mod:`repro_torch.train.fault` (which owns the
:func:`fault_point` seam and :class:`BackoffPolicy`) with the *data-plane*
half: a :class:`FaultPlan` of named injection points that the
crash-recovery tests and ``chip_smoke.py``'s serving phase drive.
Production code marks its crash sites with ``fault_point(name)``; a plan
decides, purely by traversal count, when a site fires and what it does:

========================== =================================================
point                      where it sits (see repro_torch.streams.server /
                           wal / repro_torch.train.checkpoint)
========================== =================================================
``pre_ack``                after a coalesce cycle's WAL fsync + engine
                           apply, before the acks reach the sockets — a
                           kill here loses *sent* nothing: clients retry
                           and hit the duplicate-seq idempotent-ack path
``post_ack_pre_wal``       after the cycle's ack outcomes are computed,
                           before the WAL batch is fsynced — a kill here
                           may tear the WAL tail; nothing was acked, so
                           client retry replays the lost records
``pre_checkpoint_rename``  inside ``save_checkpoint`` between writing
                           ``.tmp_step_N`` and the atomic rename — a kill
                           here leaves a stale tmp dir (GC'd at startup)
                           and recovery falls back to the previous step
``engine_apply_raise``     inside the per-item engine apply — fires an
                           *exception* (not a kill) to exercise the
                           supervision/isolation path
``disk_full``              WAL append/sync and checkpoint writes — raises
                           ``OSError(ENOSPC)`` to exercise degraded mode
                           and checkpoint retry
========================== =================================================

Determinism: a :class:`FaultSpec` fires on the ``at``-th traversal of its
point (1-based) and, for recurring faults like ``disk_full``, keeps firing
for ``count`` traversals.  Plans serialize to JSON and ride the
``SGRAPP_FAULT_PLAN`` environment variable into server subprocesses
(:func:`install_from_env` — the launcher calls it), so a SIGKILL leg is one
env var away from any production entrypoint.

The module also ships the two pieces every chaos harness needs:
:class:`DurableClient`, a seq-tracking push client that retries across
connection drops with the documented exactly-once contract, and
:class:`ServerProcess`, a subprocess wrapper around
``repro_torch.launch.serve_streams`` whose ports (and device) are parsed
from its stdout.
"""
from __future__ import annotations

import asyncio
import errno
import json
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass

from ..train.fault import BackoffPolicy, fault_point, set_fault_hook

__all__ = [
    "FAULT_POINTS",
    "FAULT_PLAN_ENV",
    "FaultError",
    "FaultSpec",
    "FaultPlan",
    "install_plan",
    "clear_plan",
    "active_plan",
    "install_from_env",
    "fault_point",
    "BackoffPolicy",
    "DurableClient",
    "ServerProcess",
]

FAULT_PLAN_ENV = "SGRAPP_FAULT_PLAN"

FAULT_POINTS = (
    "pre_ack",
    "post_ack_pre_wal",
    "pre_checkpoint_rename",
    "engine_apply_raise",
    "disk_full",
)

_ACTIONS = ("kill", "raise", "disk_full")


class FaultError(Exception):
    """The exception a ``raise``-action fault fires.  Deliberately NOT a
    ``RuntimeError``: the engine contract clause catches
    ``(ValueError, RuntimeError, NotImplementedError)``, and an injected
    fault must land in the *unexpected*-exception isolation path."""


@dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire on the ``at``-th traversal (1-based) of a
    point, for ``count`` consecutive traversals.

    action : ``"kill"`` (SIGKILL the process — the crash legs),
        ``"raise"`` (raise :class:`FaultError`), or ``"disk_full"``
        (raise ``OSError(ENOSPC)``).
    """

    action: str = "kill"
    at: int = 1
    count: int = 1

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(
                f"action must be one of {_ACTIONS}, got {self.action!r}")
        if int(self.at) < 1:
            raise ValueError("at must be >= 1 (1-based traversal index)")
        if int(self.count) < 1:
            raise ValueError("count must be >= 1")


class FaultPlan:
    """A set of named injection points -> :class:`FaultSpec`, with
    per-point traversal counters.  ``hits`` survives fired faults, so a
    test can assert exactly how far the plan got."""

    def __init__(self, specs: dict):
        self.specs: dict[str, FaultSpec] = {}
        for name, spec in specs.items():
            if name not in FAULT_POINTS:
                raise ValueError(
                    f"unknown fault point {name!r}; valid: {FAULT_POINTS}")
            if isinstance(spec, dict):
                spec = FaultSpec(**spec)
            if not isinstance(spec, FaultSpec):
                raise TypeError(f"spec for {name!r} must be a FaultSpec or "
                                f"dict, got {type(spec).__name__}")
            self.specs[name] = spec
        self.hits: dict[str, int] = {name: 0 for name in self.specs}

    def hit(self, name: str) -> None:
        """The fault hook: count the traversal; fire if planned."""
        spec = self.specs.get(name)
        if spec is None:
            return
        self.hits[name] += 1
        n = self.hits[name]
        if not (spec.at <= n < spec.at + spec.count):
            return
        if spec.action == "kill":
            # SIGKILL self: no atexit, no flush — the crash the WAL exists
            # for.  sys.stderr survives long enough for the test log.
            print(f"[faults] SIGKILL at {name} (traversal {n})",
                  file=sys.stderr, flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        elif spec.action == "disk_full":
            raise OSError(errno.ENOSPC, f"injected disk full at {name} "
                                        f"(traversal {n})")
        else:
            raise FaultError(f"injected fault at {name} (traversal {n})")

    # -- serialization (rides SGRAPP_FAULT_PLAN into subprocesses) -----------

    def to_json(self) -> str:
        return json.dumps({
            name: {"action": s.action, "at": s.at, "count": s.count}
            for name, s in sorted(self.specs.items())}, sort_keys=True)

    @classmethod
    def from_json(cls, payload: str) -> "FaultPlan":
        obj = json.loads(payload)
        if not isinstance(obj, dict):
            raise ValueError("fault plan JSON must be an object")
        return cls(obj)


_PLAN: FaultPlan | None = None


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-global fault plan (hooks
    :func:`repro_torch.train.fault.fault_point`).  Returns it for chaining."""
    global _PLAN
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"plan must be a FaultPlan, got "
                        f"{type(plan).__name__}")
    _PLAN = plan
    set_fault_hook(plan.hit)
    return plan


def clear_plan() -> None:
    global _PLAN
    _PLAN = None
    set_fault_hook(None)


def active_plan() -> FaultPlan | None:
    return _PLAN


def install_from_env() -> FaultPlan | None:
    """Install the plan serialized in ``$SGRAPP_FAULT_PLAN`` (if any) —
    called by the server launcher so subprocess crash legs need no code."""
    payload = os.environ.get(FAULT_PLAN_ENV)
    if not payload:
        return None
    return install_plan(FaultPlan.from_json(payload))


# ---------------------------------------------------------------------------
# chaos harness: a retrying seq client + a subprocess server
# ---------------------------------------------------------------------------


class DurableClient:
    """Asyncio push client implementing the documented exactly-once retry
    contract (docs/serving.md): every push carries a monotonic ``seq``;
    an unacked batch (connection died mid-push) is retried *with the same
    seq* after reconnect, and a ``duplicate`` ack means the server already
    applied it.  ``backpressure``/``quota`` rejects back off and retry.

    Used by the crash-recovery tests and ``chip_smoke.py``'s serving
    phase.
    """

    def __init__(self, host: str, port: int, token: str, *,
                 backoff: BackoffPolicy | None = None,
                 connect_retries: int = 80):
        self.host = host
        self.port = port
        self.token = token
        self.backoff = backoff or BackoffPolicy(initial_s=0.05, max_s=1.0)
        self.connect_retries = connect_retries
        self.seq = 0                  # last seq this client sent
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self.hello: dict | None = None

    async def connect(self) -> dict:
        """(Re)connect + authenticate; retries while the server restarts.
        Returns the ``hello_ok`` message (``next_seq`` tells the client
        where the server's durable watermark stands)."""
        last_err: Exception | None = None
        for attempt in range(self.connect_retries):
            try:
                self.reader, self.writer = await asyncio.open_connection(
                    self.host, self.port)
                await self._send({"type": "hello", "token": self.token})
                self.hello = await self._recv()
                if self.hello.get("type") != "hello_ok":
                    raise ConnectionError(f"auth failed: {self.hello}")
                if self.seq == 0:
                    # fresh client: adopt the server's watermark so a
                    # restarted client process keeps seqs monotonic
                    self.seq = int(self.hello.get("next_seq", 1)) - 1
                return self.hello
            except (ConnectionError, OSError) as e:
                last_err = e
                await asyncio.sleep(self.backoff.delay(min(attempt, 6)))
        raise ConnectionError(
            f"could not connect to {self.host}:{self.port}: {last_err}")

    async def _send(self, msg: dict) -> None:
        self.writer.write((json.dumps(msg, separators=(",", ":")) + "\n")
                          .encode())
        await self.writer.drain()

    async def _recv(self) -> dict:
        line = await self.reader.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    async def call(self, msg: dict) -> dict:
        """One non-push RPC with reconnect-on-drop (estimate feed messages
        are skipped — this client does not subscribe)."""
        for attempt in range(self.connect_retries):
            if self.writer is None:
                await self.connect()
            try:
                await self._send(msg)
                while True:
                    reply = await self._recv()
                    if reply.get("type") != "estimate":
                        return reply
            except (ConnectionError, OSError):
                self.close()
                await asyncio.sleep(self.backoff.delay(min(attempt, 6)))
        raise ConnectionError(f"rpc {msg.get('type')} never answered")

    async def push(self, records: dict) -> dict:
        """Push one batch exactly-once: assign the next seq, retry with the
        *same* seq across connection drops and transient rejects until the
        server acks (possibly as a duplicate).  Returns the final ack."""
        self.seq += 1
        seq = self.seq
        for attempt in range(self.connect_retries):
            if self.writer is None:
                await self.connect()
            try:
                await self._send({"type": "push", "records": records,
                                  "seq": seq})
                reply = await self._recv()
            except (ConnectionError, OSError):
                # crashed mid-push: the ack (if any) is lost — reconnect
                # and resend the same seq; the server dedupes
                self.close()
                await asyncio.sleep(self.backoff.delay(min(attempt, 6)))
                continue
            if reply.get("type") == "ack":
                return reply
            reason = reply.get("reason")
            if reason in ("backpressure", "quota", "draining", "wal_error",
                          "internal"):
                await asyncio.sleep(self.backoff.delay(min(attempt, 6)))
                continue
            raise AssertionError(f"push seq={seq} rejected: {reply}")
        raise ConnectionError(f"push seq={seq} never acked")

    def close(self) -> None:
        if self.writer is not None:
            try:
                self.writer.close()
            except Exception:
                pass
        self.reader = self.writer = None


class ServerProcess:
    """``repro_torch.launch.serve_streams`` in a subprocess on ``device``
    (default ``cuda``), with the ephemeral data/http ports and the device
    the server reports parsed from its stdout, and a fault plan shipped via
    ``$SGRAPP_FAULT_PLAN``.  The server's stderr goes to ``log_path`` (or
    nowhere).  SIGKILL-able by plan or by hand (:meth:`kill`);
    context-manager cleanup never leaves orphans."""

    def __init__(self, *, nt_w: int, alpha0: float, tenants: dict,
                 checkpoint_dir: str, tier: str = "numpy",
                 device: str = "cuda",
                 checkpoint_every_s: float | None = None,
                 flush_ms: float = 1.0, plan: FaultPlan | None = None,
                 extra_args: list | None = None,
                 env: dict | None = None, log_path: str | None = None):
        cmd = [sys.executable, "-m", "repro_torch.launch.serve_streams",
               "--nt-w", str(nt_w), "--alpha0", str(alpha0),
               "--tier", tier, "--device", str(device),
               "--flush-ms", str(flush_ms),
               "--port", "0", "--http-port", "0",
               "--checkpoint-dir", checkpoint_dir]
        for token, sid in tenants.items():
            cmd += ["--tenant", f"{token}:{sid}"]
        if checkpoint_every_s is not None:
            cmd += ["--checkpoint-every-s", str(checkpoint_every_s)]
        cmd += list(extra_args or [])
        penv = dict(os.environ)
        # .../src/repro_torch/streams/faults.py -> .../src
        src = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        penv["PYTHONPATH"] = src + os.pathsep + penv.get("PYTHONPATH", "")
        if plan is not None:
            penv[FAULT_PLAN_ENV] = plan.to_json()
        else:
            penv.pop(FAULT_PLAN_ENV, None)
        penv.update(env or {})
        self._log = (open(log_path, "a") if log_path is not None
                     else subprocess.DEVNULL)
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=self._log,
            env=penv, text=True)
        self.port: int | None = None
        self.http_port: int | None = None
        self.device: str | None = None

    def wait_ready(self, timeout_s: float = 60.0) -> "ServerProcess":
        """Block until the device and both port lines appeared on stdout
        (the launcher prints them after ``start()``, i.e. after recovery
        finished)."""
        deadline = time.monotonic() + timeout_s
        while self.port is None or self.http_port is None:
            if time.monotonic() > deadline:
                self.kill()
                raise TimeoutError("server subprocess never became ready")
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"server subprocess exited during startup "
                    f"(code {self.proc.poll()})")
            if "device  " in line:
                self.device = line.split("device  ", 1)[1].strip()
            elif "data  tcp://" in line:
                self.port = int(line.rsplit(":", 1)[1])
            elif "http  http://" in line:
                self.http_port = int(line.rsplit(":", 1)[1].split()[0])
        return self

    def wait_dead(self, timeout_s: float = 60.0) -> int:
        """Wait for the process to exit (e.g. a planned SIGKILL fired)."""
        return self.proc.wait(timeout=timeout_s)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def terminate(self, timeout_s: float = 30.0) -> int:
        """SIGTERM -> graceful drain + checkpoint (the launcher's handler)."""
        if self.proc.poll() is None:
            self.proc.terminate()
        return self.proc.wait(timeout=timeout_s)

    def __enter__(self) -> "ServerProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.kill()
        if self.proc.stdout is not None:
            self.proc.stdout.close()
        if self._log is not subprocess.DEVNULL:
            self._log.close()
