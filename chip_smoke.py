#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of sGrapp on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernel K1
(``src/repro_torch/kernels/butterfly/csrc/``) with ``nvcc`` for ``sm_90a``,
holds it against its plain torch version, replays a 2M-sgr stream through
``run_sgrapp`` / ``run_sgrapp_x`` on the ``pallas`` tier (K1) and the
``dense`` tier, and pushes the same stream through the online engine
``StreamingSGrapp`` across a ``state_dict`` / ``restore``.  Every check
raises on failure, so the exit code is non-zero unless all phases pass.

Phases:

0. setup: the card's name and power limit, torch and CUDA versions, K1's
   build (time and ``-Xptxas -v``), and the smoke stream;
1. kernel: K1 against its plain version on adversarial shapes (exact), a
   dense random stack whose sums pass 2**24 (rtol 1e-5 against float64) and
   the replay's own bucket stacks (exact); then K1's time at the replay's
   largest bucket beside the plain version, a ``torch.bmm`` Gram (a
   yardstick the port never calls) and the least time the card could take;
2. replay: ``pallas`` equals ``dense`` on every window and the numpy oracle
   on every 10th, K1 ran once per bucket chunk, and sGrapp-x runs with
   truths on the first windows;
3. stream: micro-batches of 256 through the engine equal the replay bit for
   bit, across a ``state_dict`` / ``restore`` at the midpoint;
4. profile: ``torch.profiler`` over the replay (pallas and dense tiers) and
   the stream: the device's busy and idle share of the wall time and the
   kernels that take the most device time.

Its last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA device,
or outside a checkout that holds ``src/repro_torch``, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): the int8 tensor-core rate is
# the bound K1's 0/1 operands could reach exactly; fp32 SIMT is the rate
# this first kernel runs at
PEAK_INT8_OPS = 1979e12
PEAK_FP32_SIMT = 67e12
PEAK_BYTES = 3.35e12

# the adversarial window corpus of tests/test_tier_differential.py


def _rand_edges(n_i, n_j, m, seed):
    rng = np.random.default_rng(seed)
    return list(zip(rng.integers(0, n_i, m).tolist(),
                    rng.integers(0, n_j, m).tolist()))


ADVERSARIAL = {
    "i_hub_star": [(0, j) for j in range(37)],
    "j_hub_star": [(i, 0) for i in range(41)],
    "hub_plus_column": [(i, 0) for i in range(40)]
                       + [(i, 1) for i in range(0, 40, 2)],
    "all_duplicates": [(3, 5)] * 25,
    "complete_k9_7": [(i, j) for i in range(9) for j in range(7)],
    "orientation_flip": _rand_edges(150, 40, 400, seed=1),
    "non_tile_multiple": _rand_edges(13, 300, 350, seed=2),
    "dense_random": _rand_edges(30, 30, 500, seed=3),
    "duplicate_heavy": _rand_edges(12, 10, 600, seed=4),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call: CUDA events around ``reps`` calls after
    ``warmup`` calls, or the host clock on the CPU."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def adjacency_stacks(batch, ex, device):
    """The ``[c, n_g, n_k]`` stacks K1 sees on the replay: every bucket of
    ``ex``'s plan, chunked as the executor chunks and oriented as the
    pallas tier orients."""
    import torch

    from repro_torch.kernels.butterfly.ops import oriented_biadjacency

    for b in ex.plan(batch):
        for s in range(0, b.n_windows, ex.chunk):
            win = b.windows[s:s + ex.chunk]
            ei = torch.as_tensor(batch.edge_i[win, :b.cap_e], device=device)
            ej = torch.as_tensor(batch.edge_j[win, :b.cap_e], device=device)
            v = torch.as_tensor(batch.valid[win, :b.cap_e], device=device)
            yield b, oriented_biadjacency(ei, ej, v, b.cap_i, b.cap_j)


def edge_stack(edge_lists, device):
    """One zero-padded 0/1 biadjacency per edge list, as one stack."""
    import torch

    n_i = max(max(i for i, _ in e) for e in edge_lists) + 1
    n_j = max(max(j for _, j in e) for e in edge_lists) + 1
    a = torch.zeros((len(edge_lists), n_i, n_j), dtype=torch.float32)
    for w, e in enumerate(edge_lists):
        ii, jj = zip(*e)
        a[w, list(ii), list(jj)] = 1.0
    return a.to(device)


def phase_kernel(wb, device, ex) -> dict:
    """Phase 1: K1 against its plain version, then its timing."""
    import torch

    from repro_torch.kernels.butterfly import butterfly_kernel as k1
    from repro_torch.kernels.butterfly.ops import clamp_block_i

    max_err = 0.0

    def exact(a, block_i, what):
        nonlocal max_err
        got = k1.butterfly_pairs_windows_kernel_call(a, block_i=block_i)
        want = k1.butterfly_pairs_windows_plain(a, block_i=block_i)
        sync(device)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"K1 != plain on {what} (block_i={block_i}, max abs err {err})")

    # (a) adversarial shapes: the corpus, all-zero windows, n_i > n_j,
    # non-tile-multiples and a hub whose row sits on a tile boundary
    corpus = edge_stack(list(ADVERSARIAL.values()), device)
    hub = torch.zeros((2, 600, 700), dtype=torch.float32)
    hub[0, 256, :] = 1.0                      # hub on the first row of tile 1
    hub[0, 255, ::2] = 1.0                    # and its neighbour across the edge
    hub[0, ::3, 5] = 1.0
    gen = torch.Generator().manual_seed(11)
    hub[1] = (torch.rand((600, 700), generator=gen) < 0.05).float()
    cases = {
        "adversarial corpus": corpus,
        "corpus oriented": corpus.transpose(1, 2).contiguous(),
        "all-zero windows": torch.zeros((3, 70, 90), device=device),
        "n_i > n_j": (torch.rand((2, 300, 40), generator=gen) < 0.2
                      ).float().to(device),
        "non-tile-multiple": (torch.rand((3, 129, 515), generator=gen) < 0.1
                              ).float().to(device),
        "hub on a tile boundary": hub.to(device),
    }
    for what, a in cases.items():
        for block_i in (8, 64, 256):
            exact(a, clamp_block_i(block_i, a.shape[1]), what)
    log(f"[kernel] (a) adversarial shapes: K1 == plain exactly "
        f"({len(cases)} stacks x 3 tile sizes)")

    # (b) a dense random stack whose sums pass 2**24
    a = (torch.rand((8, 1024, 2048), generator=gen) < 0.3).float().to(device)
    got = k1.butterfly_pairs_windows_kernel_call(a, block_i=256).double()
    want = k1.butterfly_pairs_windows_plain(a, block_i=256,
                                            dtype=torch.float64)
    sync(device)
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    check(float(want.max()) > 2**24, "dense stack does not pass 2**24")
    check(rel <= 1e-5, f"K1 vs float64 plain: max rel err {rel} > 1e-5")
    log(f"[kernel] (b) dense [8, 1024, 2048] at 0.3: partials up to "
        f"{float(want.max()):.4g} > 2**24, where float32 sums round in any "
        f"order, so K1 is held to a float64 plain version: max rel err "
        f"{rel:.3g} <= 1e-5")
    del a, got, want

    # (c) the replay's own bucket stacks
    n_stacks, largest = 0, None
    for b, adjs in adjacency_stacks(wb, ex, device):
        block_i = clamp_block_i(ex.block_i, adjs.shape[1])
        exact(adjs, block_i, f"bucket {b.cap_e}x{b.cap_i}x{b.cap_j}")
        n_stacks += 1
        work = adjs.shape[0] * adjs.shape[1] ** 2 * adjs.shape[2]
        if largest is None or work > largest[0]:
            largest = (work, b)
        del adjs
    log(f"[kernel] (c) replay bucket stacks: K1 == plain exactly on "
        f"{n_stacks} stacks")

    # timing at the largest bucket of the replay
    b = largest[1]
    adjs = next(a for bb, a in adjacency_stacks(wb, ex, device) if bb is b)
    bsz, n_g, n_k = adjs.shape
    block_i = clamp_block_i(ex.block_i, n_g)
    k1.reset_launch_count()
    ms = time_ms(lambda: k1.butterfly_pairs_windows_kernel_call(
        adjs, block_i=block_i), device)
    plain_ms = time_ms(lambda: k1.butterfly_pairs_windows_plain(
        adjs, block_i=block_i), device)

    def library():
        w = torch.bmm(adjs, adjs.transpose(1, 2))
        pairs = w * (w - 1.0) * 0.5
        return (pairs.sum(dim=(1, 2))
                - torch.diagonal(pairs, dim1=1, dim2=2).sum(dim=1)) * 0.5

    library_ms = time_ms(library, device)
    check(torch.allclose(library(), k1.butterfly_pairs_windows_kernel_call(
        adjs, block_i=block_i).sum(dim=1), rtol=1e-6, atol=0),
        "the bmm yardstick computes another function than K1")
    t = k1.n_tile_pairs(n_g, block_i)
    macs = bsz * n_g * (n_g - 1) / 2 * n_k     # the strict upper triangle
    ops_ms = 2 * macs / PEAK_INT8_OPS * 1e3
    bytes_ms = (adjs.numel() * 4 + bsz * t * 4) / PEAK_BYTES * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    simt_ms = 2 * macs / PEAK_FP32_SIMT * 1e3
    log(f"[kernel] timing at the largest replay bucket (cap_e={b.cap_e}, "
        f"stack [{bsz}, {n_g}, {n_k}], block_i={block_i}, T={t}): "
        f"K1 {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.bmm Gram + "
        f"epilogue {library_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"(operations: {2 * macs:.4g} at the int8 tensor-core peak; bytes "
        f"{bytes_ms:.4f} ms; at the fp32 SIMT peak {simt_ms:.4f} ms); "
        f"K1 at {bound_ms / ms:.4%} of the bound, {simt_ms / ms:.2%} of fp32 "
        f"SIMT peak")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "simt_bound_ms": simt_ms}


def phase_replay(stream, wb, nt_w, alpha0, device, ex, n_truth):
    """Phase 2: replay through K1, held against dense and the oracle."""
    import torch

    from repro_torch.core import count_butterflies_np, run_sgrapp, run_sgrapp_x
    from repro_torch.core.sgrapp import sgrapp_estimate
    from repro_torch.core.windows import window_bounds
    from repro_torch.kernels.butterfly import butterfly_kernel as k1

    n_sgrs = int(wb.n_sgrs.sum())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    k1.reset_launch_count()
    ex.chunks_dispatched = 0
    t0 = time.perf_counter()
    res = run_sgrapp(wb, alpha0, executor=ex)
    sync(device)
    sec = time.perf_counter() - t0
    launches = k1.launch_count()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda" else 0)
    # K1 launches only for CUDA tensors (a CPU rehearsal runs its plain twin)
    check(launches > 0 or device.type != "cuda",
          "the pallas replay never launched K1")
    check(launches == ex.chunks_dispatched or device.type != "cuda",
          f"K1 launches {launches} != bucket chunks {ex.chunks_dispatched}")
    log(f"[replay] pallas: {wb.n_windows} windows in {sec:.4f} s = "
        f"{wb.n_windows / sec:.4f} windows/s, {n_sgrs / sec:.4f} sgrs/s; "
        f"K1 launches {launches} = bucket chunks; {len(ex.plan(wb))} buckets; "
        f"peak device memory {peak / 2**20:.4f} MiB")

    t0 = time.perf_counter()
    dense = run_sgrapp(wb, alpha0, tier="dense", device=device)
    sync(device)
    dsec = time.perf_counter() - t0
    bad = np.flatnonzero(dense.window_counts != res.window_counts)
    check(bad.size == 0, f"pallas != dense on windows {bad[:10]}")
    check(np.array_equal(dense.estimates, res.estimates),
          "pallas and dense estimates differ")
    log(f"[replay] dense: {dsec:.4f} s; counts equal pallas on all "
        f"{wb.n_windows} windows")

    for k in range(0, wb.n_windows, 10):
        v = wb.valid[k]
        want = count_butterflies_np(np.stack([wb.edge_i[k][v],
                                              wb.edge_j[k][v]], 1))
        check(res.window_counts[k] == want,
              f"window {k}: pallas {res.window_counts[k]} != oracle {want}")
    log(f"[replay] numpy oracle equals pallas on every 10th window "
        f"({len(range(0, wb.n_windows, 10))} windows); counts "
        f"{int(res.window_counts.min())}..{int(res.window_counts.max())} "
        f"per window, all below 2**24")
    check(np.isfinite(res.estimates).all() and res.estimates.shape
          == (wb.n_windows,), "estimates not finite / wrong shape")
    host_est = sgrapp_estimate(res.window_counts, wb.cum_sgrs, alpha0,
                               device="cpu").numpy()
    rel = float(np.max(np.abs(host_est - res.estimates)
                       / np.maximum(np.abs(host_est), 1.0)))
    check(rel <= 1e-6, f"device vs CPU estimator: rel err {rel} > 1e-6")
    log(f"[replay] sGrapp estimate at stream end {res.estimates[-1]:.6g}; "
        f"the same recurrence on the CPU agrees within {rel:.3g} (rtol "
        f"1e-6: float32 pow may differ in the last ulp between devices)")

    bounds = window_bounds(stream.tau, nt_w)
    edges = stream.edges()
    t0 = time.perf_counter()
    truths = np.array([count_butterflies_np(edges[:e])
                       for _, e in bounds[:n_truth]], dtype=np.float64)
    tsec = time.perf_counter() - t0
    res_x = run_sgrapp_x(wb, alpha0, truths, executor=ex)
    check(np.isfinite(res_x.estimates).all(), "sGrapp-x estimates not finite")
    check(np.array_equal(res_x.window_counts, res.window_counts),
          "sGrapp-x counts differ from sGrapp's")
    log(f"[replay] sGrapp-x with truths on the first {n_truth} windows "
        f"(oracle {tsec:.4f} s): MAPE on them {res_x.mape():.6f}, alpha "
        f"{alpha0} -> {res_x.alpha_final:.6f}")
    return res, launches, sec


def phase_stream(stream, nt_w, alpha0, device, replay, mb: int = 256) -> int:
    """Phase 3: the online engine equals the replay bit for bit across a
    state_dict / restore at the midpoint."""
    from repro_torch.kernels.butterfly import butterfly_kernel as k1
    from repro_torch.streams import EngineConfig, StreamingSGrapp

    cfg = EngineConfig(tier="pallas", flush_every=32, device=device)
    n = len(stream)
    half = (n // 2 // mb) * mb
    k1.reset_launch_count()
    t0 = time.perf_counter()
    eng = StreamingSGrapp(nt_w, alpha0, config=cfg)
    for a in range(0, half, mb):
        eng.push(stream.tau[a:a + mb], stream.edge_i[a:a + mb],
                 stream.edge_j[a:a + mb])
    sd = eng.state_dict()
    eng = StreamingSGrapp(nt_w, alpha0, config=cfg).restore(sd)
    for a in range(half, n, mb):
        eng.push(stream.tau[a:a + mb], stream.edge_i[a:a + mb],
                 stream.edge_j[a:a + mb])
    res = eng.finalize()
    sync(device)
    sec = time.perf_counter() - t0
    launches = k1.launch_count()
    check(launches > 0 or device.type != "cuda", "the engine never launched K1")
    check(np.array_equal(res.window_counts, replay.window_counts),
          "streamed counts differ from the replay")
    check(np.array_equal(res.estimates, replay.estimates),
          "streamed estimates differ from the replay (not bit-identical)")
    log(f"[stream] mb={mb}, flush_every=32, state_dict/restore after "
        f"{half} sgrs ({sd['counts'].shape[0]} windows): {len(res.estimates)} "
        f"windows bit-identical to the replay; {n} sgrs in {sec:.4f} s = "
        f"{n / sec:.4f} sgrs/s; K1 launches {launches}")
    return launches


def phase_profile(stream, wb, nt_w, alpha0, device, ex) -> None:
    """Phase 4: where the time goes in the replay (both tiers) and in the
    stream, after the checks above have passed."""
    from repro_torch.core import run_sgrapp
    from repro_torch.streams import EngineConfig, StreamingSGrapp

    profile("replay, pallas tier",
            lambda: run_sgrapp(wb, alpha0, executor=ex), device)
    profile("replay, dense tier", lambda: run_sgrapp(
        wb, alpha0, tier="dense", device=device), device)

    def push_all(mb=256):
        eng = StreamingSGrapp(nt_w, alpha0, config=EngineConfig(
            tier="pallas", flush_every=32, device=device))
        for a in range(0, len(stream), mb):
            eng.push(stream.tau[a:a + mb], stream.edge_i[a:a + mb],
                     stream.edge_j[a:a + mb])
        eng.finalize()

    profile("stream, pallas tier, mb=256", push_all, device)


def profile(label: str, fn, device) -> None:
    """Where the device time of ``fn`` goes: ``torch.profiler`` over one
    call, the device's busy share of the host wall time (one stream, so
    kernels never overlap) and the kernels that took the most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    log(f"[profile] {label}: wall {wall_ms:.4f} ms under the profiler, "
        f"device busy {busy_ms:.4f} ms ({busy_ms / wall_ms:.4%}), idle "
        f"{1 - busy_ms / wall_ms:.4%}")
    for e in sorted(dev, key=lambda e: e.self_device_time_total,
                    reverse=True)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:12.4f} ms "
            f"{e.count:6d} x  {e.key[:90]}")


def run(device, *, n_sgrs: int, n_unique: int, nt_w: int, seed: int,
        n_truth: int, alpha0: float = 1.02) -> dict:
    """Phases 0-4 on ``device``; returns the kernels record."""
    from repro_torch.core import WindowExecutor, windowize
    from repro_torch.kernels.butterfly.build import load_library
    from repro_torch.streams import bipartite_pa_stream

    if device.type == "cuda":
        info = load_library()
        log(f"[setup] K1 library {info.path.name}: nvcc "
            + (f"{info.seconds:.4f} s" if info.seconds else
               "skipped (built earlier from the same sources)"))
        if info.log:
            log(info.log.rstrip())
    t0 = time.perf_counter()
    stream = bipartite_pa_stream(n_sgrs, temporal="uniform",
                                 n_unique=n_unique, seed=seed)
    gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    wb = windowize(stream.tau, stream.edge_i, stream.edge_j, nt_w)
    win = time.perf_counter() - t0
    log(f"[setup] stream {len(stream)} sgrs (generated in {gen:.4f} s), "
        f"{wb.n_windows} windows (windowized in {win:.4f} s): up to "
        f"{int(wb.n_edges.max())} edges, id spaces up to "
        f"{int(wb.n_i_per_window.max())} x {int(wb.n_j_per_window.max())}")

    ex = WindowExecutor("pallas", device=device)
    kern = phase_kernel(wb, device, ex)
    replay, launches, _ = phase_replay(stream, wb, nt_w, alpha0, device, ex,
                                       n_truth)
    phase_stream(stream, nt_w, alpha0, device, replay)
    phase_profile(stream, wb, nt_w, alpha0, device, ex)
    return {"name": "butterfly_windows (K1)", "route": "cuda",
            "source": "src/repro_torch/kernels/butterfly/csrc/"
                      "butterfly_windows.cu",
            "replaces": "src/repro/kernels/butterfly/butterfly_kernel.py:112",
            "launches": launches, "max_abs_err": kern["max_abs_err"],
            "ms": kern["ms"], "plain_ms": kern["plain_ms"],
            "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
            "library_ms": kern["library_ms"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sgrs", type=int, default=2_000_000)
    p.add_argument("--n-unique", type=int, default=400_000)
    p.add_argument("--nt-w", type=int, default=1600)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--truth-windows", type=int, default=8)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    smi = nvidia_smi_line()
    log(f"[setup] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernel = run(torch.device("cuda"), n_sgrs=args.sgrs,
                 n_unique=args.n_unique, nt_w=args.nt_w, seed=args.seed,
                 n_truth=args.truth_windows)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.4f} s")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
