"""Launcher for the multi-tenant streaming butterfly server, on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve_streams \
        --nt-w 50 --alpha0 1.2 --tier pallas \
        --tenant alice:0 --tenant bob:1 --tenant carol:2 \
        --port 7315 --http-port 7316 \
        --checkpoint-dir /tmp/sgrapp-ckpt --checkpoint-every-s 30

Each ``--tenant`` is ``token:stream_id[:max_records_per_s[:burst]]``; the
stream ids must be exactly 0..N-1.  SIGINT/SIGTERM trigger a graceful drain
(flush + checkpoint) before exit; pass ``--finalize-on-stop`` to also end
every stream (a finalized checkpoint cannot be resumed into — end-of-stream
only).  It prints the device the fleet counts on, then the data and http
addresses once recovery has finished.  Protocol and ops contract:
docs/serving.md.
"""
from __future__ import annotations

import argparse
import asyncio
import logging
import signal

import torch

from ..streams.config import EngineConfig, ServingConfig
from ..streams.faults import install_from_env
from ..streams.server import StreamServer, TenantPolicy

__all__ = ["parse_tenant", "build_server", "run", "main"]


def parse_tenant(spec: str) -> tuple[str, TenantPolicy]:
    parts = spec.split(":")
    if not 2 <= len(parts) <= 4 or not parts[0]:
        raise argparse.ArgumentTypeError(
            f"tenant spec must be token:stream_id[:max_records_per_s[:burst]]"
            f", got {spec!r}")
    token = parts[0]
    try:
        sid = int(parts[1])
        rate = float(parts[2]) if len(parts) >= 3 else None
        burst = int(parts[3]) if len(parts) >= 4 else None
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"bad tenant spec {spec!r}: {e}")
    return token, TenantPolicy(stream_id=sid, max_records_per_s=rate,
                               burst=burst)


def build_server(args: argparse.Namespace) -> StreamServer:
    tenants = dict(parse_tenant(t) for t in args.tenant)
    if len(tenants) != len(args.tenant):
        raise SystemExit("duplicate tenant tokens")
    config = EngineConfig(tier=args.tier, flush_every=args.flush_every,
                          seed=args.seed, device=args.device)
    serving = ServingConfig(wal=not args.no_wal,
                            wal_fsync=not args.no_wal_fsync)
    return StreamServer(
        nt_w=args.nt_w, alpha0=args.alpha0, tenants=tenants, config=config,
        host=args.host, port=args.port, http_port=args.http_port,
        queue_limit=args.queue_limit, flush_ms=args.flush_ms,
        latency_budget_ms=args.latency_budget_ms,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every_s=args.checkpoint_every_s,
        serving=serving,
    )


async def run(args: argparse.Namespace) -> None:
    server = await build_server(args).start()
    dev = server.engine.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "host")
    print(f"[serve-streams] device  {dev.type} ({name}), tier "
          f"{server.engine.tier}", flush=True)
    print(f"[serve-streams] data  tcp://{server.host}:{server.port}")
    print(f"[serve-streams] http  http://{server.host}:{server.http_port}"
          f"  (/healthz /metrics)", flush=True)
    loop = asyncio.get_running_loop()
    stopping = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stopping.set)
    serve = asyncio.create_task(server.serve_forever())
    await stopping.wait()
    print("[serve-streams] draining...")
    serve.cancel()
    await server.stop(finalize=args.finalize_on_stop)
    print("[serve-streams] stopped")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="multi-tenant streaming butterfly-estimate server")
    ap.add_argument("--nt-w", type=int, required=True,
                    help="unique timestamps per adaptive window (paper Alg.3)")
    ap.add_argument("--alpha0", type=float, default=1.0)
    ap.add_argument("--tenant", action="append", required=True,
                    help="token:stream_id[:max_records_per_s[:burst]] "
                         "(repeat per tenant; stream ids must be 0..N-1)")
    ap.add_argument("--tier", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet counts: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--flush-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--http-port", type=int, default=0)
    ap.add_argument("--queue-limit", type=int, default=64)
    ap.add_argument("--flush-ms", type=float, default=2.0)
    ap.add_argument("--latency-budget-ms", type=float, default=0.0,
                    help="defer window-count dispatch up to this deadline so "
                         "windows closed across tenants fuse into one "
                         "bucketed dispatch (0 = submit every cycle; acks "
                         "are never delayed — docs/serving.md)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every-s", type=float, default=None)
    ap.add_argument("--no-wal", action="store_true",
                    help="disable the write-ahead log (acked records are "
                         "then durable only up to the last checkpoint)")
    ap.add_argument("--no-wal-fsync", action="store_true",
                    help="keep the WAL but skip fsync (benchmarking only)")
    ap.add_argument("--finalize-on-stop", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="structured JSON request logs on stderr")
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(message)s")
    # crash legs ship their fault plan via $SGRAPP_FAULT_PLAN; a no-op
    # otherwise (repro_torch.streams.faults)
    install_from_env()
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
