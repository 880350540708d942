#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of sGrapp on one CUDA card, end to end.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels K1
(which K3 launches at B = 1) and K2
(``src/repro_torch/kernels/butterfly/csrc/``) and K4
(``src/repro_torch/kernels/flash_attention/csrc/``) for ``sm_90a``, one
``nvcc`` per source, all started together, holds each kernel against its
plain torch version, replays a 2M-sgr stream through ``run_sgrapp`` /
``run_sgrapp_x`` on the ``pallas`` tier (K1) and the ``dense`` tier, pushes
the same stream through the online engine ``StreamingSGrapp`` under the
``distinct`` and ``multiset`` duplicate policies (K1 and K2) across a
``state_dict`` / ``restore``, runs a dynamic stream with deletes, sweeps the
``tiled`` / ``sparse`` / ``auto`` tiers, counts single matrices through
K3, drives the executor's entries (``run`` in sliding mode,
``count_edges``, ``decrement_window_counts``), eight tenants through
``MultiStreamSGrapp`` and the ``sampled`` tier and reservoir, serves those
tenants over TCP through the port's ``StreamServer`` (a server subprocess
SIGKILLed and recovered, WAL and checkpoints), runs the paper's SS3
analysis, shards the executor's windows and the ring counter's Gram over
several devices, serves phi4-mini-3.8b, minicpm3-4b (MLA),
phi3.5-moe-42b and dbrx-132b (MoE) at full width (prefill attention
through K4), trains phi4-mini-3.8b, the GNNs and xDeepFM at full width and
checks the halo-exchange losses.  Every check
raises on failure, so the exit code is non-zero unless all phases pass.

Phases (each path's launch counts are set to 0 just before it runs and read
just after):

0. setup: the card's name and power limit, torch and CUDA versions, the
   kernels' build (time and ``-Xptxas -v``; for K1's wgmma kernel and
   each K4 variant its registers, spills and dynamic shared memory, and
   any ptxas warning that it serialized K1's wgmma), and the smoke stream;
1. kernel: K1 against its plain version, ``torch.equal`` at every size
   (both sum the reference's float32 per-entry values exactly and round
   once): on adversarial shapes as float32 (through the padded uint8 copy)
   and as uint8 (as it lies where its rows allow), on a dense uint8 stack
   whose sums pass 2**24 (also within rtol 1e-5 of float64) and on the
   replay's own uint8 bucket stacks; K2 against its plain version with
   ``torch.equal`` (both compute the Grams exactly, apply the reference's
   float32 epilogue per entry and sum exactly) on adversarial shapes with
   multiplicities <= 8 (also equal to the float64 plain version) and on
   the largest uint8 limb stack the multiset engine handed K2 in phase 4
   (also within ``RTOL_K2`` of float64; this check runs after phase 4),
   with the limbs that stack's windows need and its overflow margin; each
   kernel's time beside its plain version, its library yardsticks (never
   called by the port: for K1 a float32 and a bf16 ``torch.bmm`` Gram with
   float32 output, each checked to compute the same function; for K2 two
   float32 ``torch.bmm`` Grams) and the least time the card could take (for
   K2 from the limb products each pair of 64-row blocks needs);
2. replay: ``pallas`` equals ``dense`` on every window and the numpy oracle
   on every 10th, K1 ran once per bucket chunk, each time on the uint8
   stack as it lies (no padded copy), the peak device memory, and sGrapp-x
   runs with truths on the first windows;
3. stream: micro-batches of 256 through the engine equal the replay bit for
   bit, across a ``state_dict`` / ``restore`` at the midpoint; every K1
   launch read its stack as it lies;
4. multiset: the smoke stream through ``StreamingSGrapp(dup_policy=
   "multiset")`` on ``pallas`` (K2, every launch on the scatter's limb
   stack as it lies) at mb=256 across a restore equals
   ``pallas`` at mb = the whole stream bit for bit; ``dense`` and ``pallas``
   agree within ``RTOL_MULTISET``, and so does each with the int64 oracle
   on every 10th window of ``replay_dynamic``'s replay of the stream;
   windows whose ``W^2``, ``S`` and pair sums all stay below 2**24 are
   exact;
5. dynamic: a stream with deletes and duplicates through the engine under
   both policies on ``pallas``: its windows equal ``replay_dynamic``'s and
   its counts ``oracle_window_counts``';
6. tiers: one distinct replay on ``tiled``, ``sparse`` and ``auto`` equals
   ``dense`` on every window; their wall times, their device times on
   every fourth window, the buckets ``auto`` sent to ``sparse``, and the
   card's ``route_tier`` crossover on every third bucket;
7. K3: every 25th replay window through ``butterfly_count_pallas`` and
   ``butterfly_count_tiles`` equals the replay, K3 against its plain version
   on the largest window, its route (a float32 matrix: the padded copy),
   its time with the copy, its float32 and bf16 ``torch.mm`` yardsticks and
   its bound;
8. profile: ``torch.profiler`` over the replay (pallas and dense tiers) and
   the distinct and multiset streams: the device's busy and idle share of
   the wall time, the kernels that take the most device time, and
   (``cProfile``) the host functions with the most own time in the pallas
   replay and the distinct stream;
9. K4: at the serve path's shapes (q [4, 4096, 24, 128], k and v
   [4, 4096, 8, 128], bf16, causal) against its plain version, again in
   float32 and at a ragged later prompt chunk with ``q_offset > 0``
   (``K4_TOL``); bf16 runs the wgmma variant, float32 the SIMT variant;
   K4's (both variants), the plain version's and
   ``scaled_dot_product_attention``'s times (the last never called by the
   port), the least time the card could take, K4's share of it and its
   factor against SDPA; then at MLA's prefill shape (minicpm3-4b: q and k
   [4, 4096, 40, 96], v [4, 4096, 40, 64]) at the model's scale, bf16 on
   route ``wgmma`` and float32 on ``simt``, with its time, bound and the
   SDPA backends that take a value head dim other than the query's;
10. serve: phi4-mini-3.8b at full width with seeded random weights, 4
   prompts x 4,096 tokens and 64 greedy tokens through
   ``repro_torch.launch.serve``: K4 held against its plain version on every
   layer's q, k, v in one prefill; a counted, timed run (K4 once per layer,
   every launch the bf16 wgmma variant on the tensors as they lie, through
   TMA with no padded copy; finite logits, prefill ms, decode tok/s, peak
   memory); the profile of a
   prefill (K4's share) and of decode steps; the smoke config in float32 on
   the card against the CPU path; the sGrapp monitor's butterfly count of
   the (request, token) graph against the numpy oracle;
16-18. serve, MLA and MoE (after phase 10): phase 10's checks for
   minicpm3-4b (all 62 layers, 4 x 4,096 prompts, 64 tokens; K4 held on
   every layer, MLA's prefill included), phi3.5-moe-42b (8 of its 32
   layers, the same prompts) and dbrx-132b (2 of its 40 layers, 2 x 1,024
   prompts, 8 tokens), each depth cut logged as ``reduced``; for an MoE
   also the dropped share of (token, choice) pairs per layer in prefill
   and in decode, and the smoke config's routing (every dispatch's gate
   indices and kept choices) equal on the card and the CPU;
11. entries (K1): on a fresh pallas executor, ``run(mode="tumbling")``
   equals phase 2, ``run(mode="sliding", span=s)`` for s in {1, 4, 32}
   equals the prefix difference of those counts and, at 32, ``dense``'s
   sliding run; a two-tenant batch in sliding mode raises before any
   dispatch; ``count_edges`` on the raw, duplicated sgrs of every 10th
   window equals the replay (K1 at B = 1, route ``wgmma``); and
   ``decrement_window_counts`` over phase 5's windows (each window's
   inserted edges less those fully retracted) at ``delta_frac`` 0 (all
   recount, K1) and 1 (all delta, host) equals ``oracle_window_counts``;
12. multi-tenant (K1, K2): eight ``bipartite_pa_stream(250_000,
   n_unique=50_000, seed=3+s)`` tenants pushed interleaved at mb=256
   through ``MultiStreamSGrapp`` on pallas under ``distinct`` and
   ``multiset``, across a ``state_dict`` / ``restore`` at the midpoint:
   every tenant bit-identical to a dedicated ``StreamingSGrapp``, the
   fleet's counts equal to a ``dense`` fleet's (``distinct``) or within
   ``RTOL_MULTISET`` of them (``multiset``), windows per tenant, launches,
   wall time and the device's busy and idle share (profiled on the first
   quarter of each tenant);
13. sampled (no TPU kernel: threefry coins and the dense counter on the
   survivors): ``WindowExecutor("sampled", capacity=2048)`` at seeds 0-3
   on the smoke windows, the card equal to the CPU port bit for bit on the
   first 20 windows (counts, and the seed-0 keep masks and rungs), the
   mean relative error against phase 2's exact counts below 0.6, equal to
   the exact counts at a capacity past every bucket's ``cap_e``;
   ``reservoir_run`` over the whole stream at capacity 8,192 with equal
   lanes, rung and estimate on the card and the CPU; and
   ``StreamingSGrapp(tier="sampled", seed=0)`` at mb=256 equal to the
   seed-0 sampled replay bit for bit; the profile of a sampled replay of
   25 windows and of the reservoir over 200,000 sgrs;
14. serving (K1, K2): phase 12's tenants pushed over TCP in batches of
   2,048 records through the port's ``StreamServer`` on pallas: (a) a
   server subprocess (``python -m repro_torch.launch.serve_streams
   --device cuda``, WAL on, checkpoints every 2 s, a 5 ms latency budget)
   SIGKILLed at ``pre_ack`` midway and restarted on its state directory
   while ``DurableClient``s retry, running on the card by its own account;
   (b) an in-process server, K1's launches all on route ``wgmma``, its
   edges/s with the WAL on and off, ``/metrics``'s p50/p99 push ms,
   ``dispatch_count`` and coalesced windows per dispatch, and the device's
   idle share under the profiler on a quarter of the pushes; (c) multiset
   tenants, stopped after a third (checkpoint) and after two thirds (WAL
   only) and restarted from checkpoint + WAL, K2's launches all on route
   ``wgmma_limbs``; (d) that restart's time to ready and its replayed WAL
   records.  Every served tenant equals phase 12's fleet bit for bit;
15. analysis and sharding (K1, K2): (a) the paper's SS3 analysis
   (``core.analysis``: growth curve, power-law and polynomial fits, hubs,
   degree/support correlation, young/old hubs, inter-arrival gaps, alpha =
   P(t)) on the first 5,000 sgrs, with the fitted eta and the run time;
   ``butterfly_support_dense`` on the card equal to
   ``butterfly_support_np`` on the largest window, and ``Snapshot.count()``
   to the oracle; (b) the executor's ``devices=`` under each layout (one
   shard per card where there are several, and ``[cuda:0] * 2``,
   ``[cuda:0] * 3``): the pallas replay and ``run_sgrapp`` equal phase 2
   bit for bit with every K1 launch on ``wgmma``, the multiset engine
   equal to phase 4 with every K2 launch on ``wgmma_limbs``, dense /
   tiled / sparse / auto / sampled (seed 0) on every 10th window equal to
   their unsharded counts, ``StreamingSGrapp(devices=)`` at mb=256 equal
   to phase 3's replay, and each layout's wall time with the number of
   distinct cards it used; (c) the Gram-sharded ring counter
   (``core.distributed``) on (2, 2) and (1, 3) grids over every 10th
   window under both schedules, and ``distributed_count_dense`` on the
   largest window, equal to phase 2.

19. the sgrapp cells (K1): ``list_cells("sgrapp")`` at its full shapes
   through each cell's ``make_step(Sharder(None))``: ``win_8k`` (32 x
   8,192 lanes, 4,096 x 8,192), ``estimator`` (512 windows, the same) and
   ``win_64k`` (32 x 65,536 lanes, 32,768 x 65,536; 2 GiB of uint8 stack
   a window, so 2 windows a K1 launch), on a uniform and a skewed (hub)
   draw each: counts equal to the int64 oracle below 2**24 and within
   rtol 1e-6 above (every window; every 8th of win_64k), the estimator's
   output equal to ``sgrapp_x_estimate`` of those counts on the CPU, K1's
   launches all on route ``wgmma``, wall time, windows/s and K1's share
   of the device time;
20. LM training (K4 in the forward under autograd, twice a step with
   per-block checkpointing): (a) the five LM smoke configs in float32
   through their ``train_4k`` cell (8 microbatches) on the card against
   the CPU port (loss, every gradient leaf, the parameters after 3 AdamW
   steps), and the launcher (``launch.train.main``) on phi4-mini-3.8b's
   smoke config, 3 steps with a checkpoint each, restarted from it; (d)
   the attention's autograd function (K4 forward, float32 torch backward)
   against torch autograd through K4's plain version at phi4-mini's shape
   and MLA's (hd 96, hd_v 64), with both times; (b) phi4-mini-3.8b at
   full width (32 layers, seeded random bf16 weights), one 1 x 4,096
   sequence, 3 steps at lr 3e-4 on that batch with one microbatch: the
   loss finite and falling, 64 K4 launches a step all on ``wgmma``, step
   ms, tokens/s, peak memory, a profile of a step, the attention
   backward's share and ``6 N tokens / (step s x peak)``; (c) the config
   cut to 8 layers, 2 x 4,096 tokens in 2 microbatches (float32
   accumulation) against one microbatch.  Both cuts are logged as
   ``reduced``;
21. GNN training (no TPU kernel: torch's gathers, ``index_add`` /
   ``scatter_reduce`` with atomics, cuBLAS fp32 GEMMs): (a) the smoke
   configs of graphsage-reddit, graphcast, dimenet and equiformer-v2
   through their ``molecule`` cell's train step on a seeded graph of 1,024
   nodes and 8,192 edges (skewed destinations) on the card against the
   CPU port: loss, every gradient leaf and the parameters after 3 AdamW
   steps (``hold_steps``); (b) ``GNN_CELLS`` at full width: each arch's
   full config on its cells' shapes (ogb_products' rounds as the registry
   budgets them; GraphSAGE's minibatch_lg through ``fanout_sample`` on a
   Reddit-sized CSR), 3 steps on one seeded batch with the loss falling,
   step ms, nodes/s, ``model_flops / (step s x 67 TFLOP/s)``, peak memory
   and a profile of the third step; a cell that does not fit the card is
   halved in nodes and edges until it does, and the cut logged as
   ``reduced``; (c) ``sage_loss_halo`` and ``eqv2_loss_halo`` over a 2 x 4
   mesh of ``[cuda:0] * 8`` (one shard per card round-robin where there
   are several) against the gather losses on a locality graph (GraphSAGE
   2**20 edges, EquiformerV2 2**18), within the reference's 2e-5 and 3e-5;
22. xDeepFM: (a) the smoke config's train step against the CPU port, and
   serving and candidate scores; (b) the full config (39 x 1M-row tables):
   train_batch (65,536 rows, 3 steps, the loss falling), serve_p99,
   serve_bulk and retrieval_cand through their cells: p50/p99 ms, rows/s,
   peak memory, ``model_flops / (s x 67 TFLOP/s)``, a profile of
   serve_bulk.  Phases 21-22 launch none of K1-K4: their counts, set to 0
   before phase 21, are checked to stay 0.

On a machine with several cards phase 15 also shards over the distinct
cards (up to 4); the script needs one card.

Phases 11-15 and 19 run after phase 8, before K4 and serving; phases
16-18 and 20-22 run after phase 10.  Each phase's wall
time is logged (``[time]``).  Every profile also logs the host's CUDA
runtime calls with the most host time (launches, copies, synchronizations).
Its last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {"platform": "gpu", ...}}``.  Without a CUDA device,
or outside a checkout that holds ``src/repro_torch``, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): the int8 tensor-core rate is
# the bound for K1's 0/1 operands and K2's uint8 limbs, exact there (both
# run on it); fp32 SIMT is the rate K4's float32 variant runs at
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_FP32_SIMT = 67e12
PEAK_BYTES = 3.35e12

# K2 against its float64 plain version on the largest stack the multiset
# engine hands it, per window count: the W^2 - S cancellation leaves the
# float32 rounding of both terms in the count.  Measured 1.07653e-06 at
# [11, 3776, 5056] on an H100 with the earlier fp32 SIMT K2 (PERF.md); the
# bound leaves a factor of about 9.
RTOL_K2 = 1e-5
# multiset counts of one window from two float32 tiers, or from a float32
# tier and the int64 oracle, on the smoke stream.  Measured on an H100: K2
# 2.1631e-06 and the dense tier 2.5888e-05 off the oracle, 4.0362e-05
# apart (PERF.md, PR 12).  The bound leaves a factor of about 12 for a
# float32 tier that sums in another order, as the reference's does.
RTOL_MULTISET = 5e-4

# K4 against its plain version, both computing in float32 in another order
# of summation: float32 outputs within rtol = atol = 2e-5 (the reference's own
# kernel test); bf16 outputs within one bf16 rounding step (rtol 8e-3 covers
# the largest relative ulp, 2**-7; atol 1e-3 the values near 0).  Measured on
# an H100 at q [4, 4096, 24, 128]: 4.8e-07 (float32), 0.0039 = one ulp at
# 0.5-1 (bf16) (PERF.md).
K4_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
          "bfloat16": dict(rtol=8e-3, atol=1e-3)}
# K4's bf16 output against the plain version's float32 output on the same
# inputs (widened exactly): the rounding to bf16 (at most half an ulp, 2**-8
# of the value) on top of the float32 tolerance.  K4_TOL["bfloat16"] cannot
# tell K4's fp32 P from a bf16 P, whose rounding errs by about 2**-9 of each
# term: where the output cancels, that is past half an ulp of the output.
# Phase 9 holds scaled_dot_product_attention, which keeps P in bf16, to this
# tolerance as a control that must fail.
K4_ROUNDED = dict(rtol=2.0**-8 + 2e-5, atol=2e-5)

# the LM that phase 10 serves at full width
LM_ARCH = "phi4-mini-3.8b"
# phases 16-18: the MLA and MoE LMs served at full width, each with the
# layers it keeps on one 80 GB card (None: all), its prompts and its tokens.
# minicpm3-4b is 8.5 GB in bf16; phi3.5-moe-42b is 2.60 GB a layer (84 GB
# in all) and dbrx-132b 6.52 GB a layer plus 2.47 GB of embedding and head
LM_CELLS = (("minicpm3-4b", None, 4, 4096, 64),
            ("phi3.5-moe-42b", 8, 4, 4096, 64),
            ("dbrx-132b", 2, 2, 1024, 8))

# phase 12: tenants of one fleet, each an eighth of the smoke stream; the
# records of each push (phases 12 and 13)
N_TENANTS = 8
MB = 256
# phase 13: the sampled tier's gamma and seeds, the windows the CPU port
# replays beside the card, and the reservoir's capacity (EngineConfig's
# default)
SAMPLED_GAMMA = 0.7
SAMPLED_SEEDS = 4
SAMPLED_CPU_WINDOWS = 20
RES_CAPACITY = 8192
# phase 14: records per push, the server's coalescing window and latency
# budget (ms), and its periodic checkpoint (s)
SERVE_BATCH = 2048
SERVE_FLUSH_MS = 1.0
SERVE_BUDGET_MS = 5.0
SERVE_CKPT_S = 2.0

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


def corpus_edges() -> list[np.ndarray]:
    """The adversarial corpus as unique ``[m, 2]`` edge arrays."""
    return [np.unique(np.asarray(e, np.int64), axis=0)
            for e in ADVERSARIAL.values()]


def weighted_stack(edge_lists, mults, device):
    """One zero-padded weighted biadjacency per (edges, mult) pair."""
    import torch

    n_i = max(int(e[:, 0].max()) for e in edge_lists) + 1
    n_j = max(int(e[:, 1].max()) for e in edge_lists) + 1
    a = torch.zeros((len(edge_lists), n_i, n_j), dtype=torch.float32)
    for w, (e, m) in enumerate(zip(edge_lists, mults)):
        a[w, torch.from_numpy(e[:, 0]), torch.from_numpy(e[:, 1])] = (
            torch.from_numpy(m.astype(np.float32)))
    return a.to(device)


def push_engine(cfg, nt_w, alpha0, tau, ei, ej, op=None, mb=256,
                restore_at=None):
    """Push a stream through a fresh ``StreamingSGrapp`` in micro-batches
    of ``mb`` (with a ``state_dict`` / ``restore`` into a new engine after
    ``restore_at`` records) and finalize.  Returns (engine, result, the
    records before the restore, windows in the state dict)."""
    from repro_torch.streams import StreamingSGrapp

    n = len(tau)
    half = n if restore_at is None else (restore_at // mb) * mb
    eng = StreamingSGrapp(nt_w, alpha0, config=cfg)

    def feed(a0, a1):
        for a in range(a0, a1, mb):
            b = min(a + mb, a1)
            eng.push(tau[a:b], ei[a:b], ej[a:b],
                     op=None if op is None else op[a:b])

    feed(0, half)
    n_sd = 0
    if restore_at is not None:
        sd = eng.state_dict()
        n_sd = sd["counts"].shape[0]
        eng = StreamingSGrapp(nt_w, alpha0, config=cfg).restore(sd)
    feed(half, n)
    return eng, eng.finalize(), half, n_sd


def gram_yardsticks(a):
    """The two library yardsticks for K1 on the stack ``a`` (``[B, n, k]``
    or one ``[n, k]`` matrix, 0/1): one float32 Gram (``torch.bmm`` /
    ``torch.mm``, full float32) and one bf16 Gram with float32 output
    (``out_dtype``; exact for 0/1 operands while every w stays below 2**24),
    each with the epilogue and each window's whole sum.  Each takes its own
    copy of ``a`` in its input type, made here, outside its timing.
    Returns ``{name: fn}``; ``fn()`` gives the ``[B]`` (or 0-d) window
    sums.  Never called by the port."""
    import torch

    from repro_torch.core.butterfly import full_fp32_matmul

    a3 = a if a.dim() == 3 else a[None]
    a32, a16 = a3.to(torch.float32), a3.to(torch.bfloat16)

    def epilogue(w):
        pairs = w * (w - 1.0) * 0.5
        out = (pairs.sum(dim=(1, 2))
               - torch.diagonal(pairs, dim1=1, dim2=2).sum(dim=1)) * 0.5
        return out if a.dim() == 3 else out[0]

    def fp32():
        with full_fp32_matmul():
            if a.dim() == 2:
                return epilogue(torch.mm(a32[0], a32[0].T)[None])
            return epilogue(torch.bmm(a32, a32.transpose(1, 2)))

    def bf16():
        if a16.device.type == "cpu":
            # out_dtype is CUDA's; a CPU rehearsal widens instead
            return epilogue(torch.bmm(a16.float(), a16.float().transpose(1, 2)))
        if a.dim() == 2:
            return epilogue(torch.mm(a16[0], a16[0].T,
                                     out_dtype=torch.float32)[None])
        return epilogue(torch.bmm(a16, a16.transpose(1, 2),
                                  out_dtype=torch.float32))

    return {"fp32": fp32, "bf16": bf16}


def k1_bounds(a, out) -> tuple[float, str, float]:
    """The least time an H100 could take for K1's work on the stack ``a``
    (``[B, n, k]``) with partials ``out``: (bound ms, "bytes" or
    "operations", operations).  Operations: the strict upper triangle of
    each window's Gram at the int8 tensor-core peak (0/1 operands are exact
    there).  Bytes: the stack read once at its own element size and the
    partials written once."""
    bsz, n_g, n_k = a.shape
    ops = 2 * bsz * n_g * (n_g - 1) / 2 * n_k
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    bytes_ms = (a.numel() * a.element_size()
                + out.numel() * out.element_size()) / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops)


def phase_kernel(wb, device, ex) -> dict:
    """Phase 1: K1 against its plain version on both routes, then its
    timing beside its two library yardsticks."""
    import torch

    from repro_torch.kernels.butterfly import butterfly_kernel as k1
    from repro_torch.kernels.butterfly.ops import clamp_block_i

    max_err = 0.0
    cuda = device.type == "cuda"

    def exact(a, block_i, what, route=None):
        nonlocal max_err
        k1.reset_launch_count()
        got = k1.butterfly_pairs_windows_kernel_call(a, block_i=block_i)
        want = k1.butterfly_pairs_windows_plain(a, block_i=block_i)
        sync(device)
        err = float((got - want).abs().max()) if got.numel() else 0.0
        max_err = max(max_err, err)
        check(torch.equal(got, want),
              f"K1 != plain on {what} (block_i={block_i}, max abs err {err})")
        if route is None:
            route = "wgmma" if k1.tma_ready(a) else "wgmma_padded"
        check(not cuda or got.numel() == 0
              or k1.launch_count("K1", route) == 1,
              f"K1 on {what} did not take the route {route}")

    # (a) adversarial shapes, each as float32 (through the padded copy) and
    # as uint8 (as it lies where its rows are a multiple of 16 bytes): the
    # corpus, all-zero windows, n_i > n_j, non-tile-multiples and a hub
    # whose row sits on a tile boundary
    corpus = weighted_stack(corpus_edges(),
                            [np.ones(len(e)) for e in corpus_edges()], device)
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
        "hub, 16-byte rows": torch.nn.functional.pad(hub, (0, 4)).to(device),
        "empty contraction": torch.zeros((4, 40, 0), device=device),
    }
    routes = {"wgmma": 0, "wgmma_padded": 0}
    for what, a in cases.items():
        for dtype in (torch.float32, torch.uint8):
            a = a.to(dtype)
            for block_i in (8, 64, 256):
                exact(a, clamp_block_i(block_i, a.shape[1]),
                      f"{what} ({str(dtype).split('.')[-1]})")
            routes["wgmma" if k1.tma_ready(a) else "wgmma_padded"] += 3
    log(f"[kernel] (a) adversarial shapes: K1 == plain exactly "
        f"({len(cases)} stacks x 2 dtypes x 3 tile sizes; {routes['wgmma']} "
        f"launches read the uint8 stack as it lies, "
        f"{routes['wgmma_padded']} through the padded copy)")

    # (b) a dense random stack whose sums pass 2**24
    a = (torch.rand((8, 1024, 2048), generator=gen) < 0.3).to(
        torch.uint8).to(device)
    exact(a, 256, "dense [8, 1024, 2048] past 2**24", route="wgmma")
    got = k1.butterfly_pairs_windows_kernel_call(a, block_i=256).double()
    want = k1.butterfly_pairs_windows_plain(a, block_i=256,
                                            dtype=torch.float64)
    sync(device)
    rel = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    check(float(want.max()) > 2**24, "dense stack does not pass 2**24")
    check(rel <= 1e-5, f"K1 vs float64 plain: max rel err {rel} > 1e-5")
    log(f"[kernel] (b) dense uint8 [8, 1024, 2048] at 0.3: partials up to "
        f"{float(want.max()):.4g} > 2**24; K1 == plain exactly (both the "
        f"exact sum of the float32 per-entry values, rounded once), and "
        f"within {rel:.3g} of the float64 plain version (bound 1e-5)")
    del a, got, want

    # (c) the replay's own bucket stacks, uint8 as the scatter builds them
    n_stacks, largest = 0, None
    for b, adjs in adjacency_stacks(wb, ex, device):
        block_i = clamp_block_i(ex.block_i, adjs.shape[1])
        exact(adjs, block_i, f"bucket {b.cap_e}x{b.cap_i}x{b.cap_j}",
              route="wgmma")
        n_stacks += 1
        work = adjs.shape[0] * adjs.shape[1] ** 2 * adjs.shape[2]
        if largest is None or work > largest[0]:
            largest = (work, b)
        del adjs
    log(f"[kernel] (c) replay bucket stacks: K1 == plain exactly on "
        f"{n_stacks} uint8 stacks, each read as it lies (route wgmma)")

    # timing at the largest bucket of the replay
    b = largest[1]
    adjs = next(a for bb, a in adjacency_stacks(wb, ex, device) if bb is b)
    bsz, n_g, n_k = adjs.shape
    block_i = clamp_block_i(ex.block_i, n_g)
    k1.reset_launch_count()
    ms = time_ms(lambda: k1.butterfly_pairs_windows_kernel_call(
        adjs, block_i=block_i), device, reps=20, warmup=2)
    plain_ms = time_ms(lambda: k1.butterfly_pairs_windows_plain(
        adjs, block_i=block_i), device)
    out = k1.butterfly_pairs_windows_kernel_call(adjs, block_i=block_i)
    sums = out.double().sum(dim=1)
    lib_ms = {}
    for name, fn in gram_yardsticks(adjs).items():
        check(torch.allclose(fn().double(), sums, rtol=1e-6, atol=0),
              f"the {name} yardstick computes another function than K1")
        lib_ms[name] = time_ms(fn, device)
    bound_ms, bound_by, ops = k1_bounds(adjs, out)
    log(f"[kernel] timing at the largest replay bucket (cap_e={b.cap_e}, "
        f"uint8 stack [{bsz}, {n_g}, {n_k}], block_i={block_i}, T="
        f"{out.shape[1]}): K1 {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"torch.bmm Gram + epilogue: float32 {lib_ms['fp32']:.4f} ms, bf16 "
        f"with float32 output {lib_ms['bf16']:.4f} ms (each on its own copy "
        f"of the stack); bound {bound_ms:.4f} ms ({bound_by}: {ops:.4g} at "
        f"the int8 tensor-core peak); K1 at {bound_ms / ms:.4%} of the "
        f"bound, {lib_ms['fp32'] / ms:.4f}x faster than the float32 "
        f"yardstick and {lib_ms['bf16'] / ms:.4f}x than the bf16 one")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms["bf16"], "fp32_library_ms": lib_ms["fp32"],
            "bound_ms": bound_ms, "bound_by": bound_by}


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
    check(k1.launch_count("K1", "wgmma") == launches,
          f"only {k1.launch_count('K1', 'wgmma')} of K1's {launches} replay "
          "launches read the uint8 stack as it lies (the rest a padded copy)")
    log(f"[replay] pallas: {wb.n_windows} windows in {sec:.4f} s = "
        f"{wb.n_windows / sec:.4f} windows/s, {n_sgrs / sec:.4f} sgrs/s; "
        f"K1 launches {launches} = bucket chunks, every one on the uint8 "
        f"stack as it lies (route wgmma, no padded copy); "
        f"{len(ex.plan(wb))} buckets; peak device memory "
        f"{peak / 2**20:.4f} MiB")
    routes = {r: k1.launch_count("K1", r) for r in k1.ROUTES}

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
    return res, launches, routes


def phase_stream(stream, nt_w, alpha0, device, replay, mb: int = 256) -> int:
    """Phase 3: the online engine equals the replay bit for bit across a
    state_dict / restore at the midpoint."""
    from repro_torch.kernels.butterfly import butterfly_kernel as k1
    from repro_torch.streams import EngineConfig

    cfg = EngineConfig(tier="pallas", flush_every=32, device=device)
    n = len(stream)
    k1.reset_launch_count()
    t0 = time.perf_counter()
    _, res, half, n_sd = push_engine(cfg, nt_w, alpha0, stream.tau,
                                     stream.edge_i, stream.edge_j, mb=mb,
                                     restore_at=n // 2)
    sync(device)
    sec = time.perf_counter() - t0
    launches = k1.launch_count()
    check(launches > 0 or device.type != "cuda", "the engine never launched K1")
    check(k1.launch_count("K1", "wgmma") == launches,
          f"only {k1.launch_count('K1', 'wgmma')} of K1's {launches} stream "
          "launches read the uint8 stack as it lies (the rest a padded copy)")
    check(np.array_equal(res.window_counts, replay.window_counts),
          "streamed counts differ from the replay")
    check(np.array_equal(res.estimates, replay.estimates),
          "streamed estimates differ from the replay (not bit-identical)")
    log(f"[stream] mb={mb}, flush_every=32, state_dict/restore after "
        f"{half} sgrs ({n_sd} windows): {len(res.estimates)} "
        f"windows bit-identical to the replay; {n} sgrs in {sec:.4f} s = "
        f"{n / sec:.4f} sgrs/s; K1 launches {launches}, every one on the "
        f"uint8 stack as it lies (route wgmma)")
    return launches


def k2_bounds(planes, masks, lw, out) -> tuple[float, str, float, float]:
    """The least time an H100 could take for K2's work on the limb planes
    ``planes`` (``[B, lw + ls, n_g, k]``) with block masks ``masks``
    (``[B, ceil(n_g / 64)]``) and partials ``out``: (bound ms, "bytes" or
    "operations", operations, the share of all limb products that the data
    needs).  Operations: for each window and each pair of 64-row blocks of
    its strict upper triangle, the limb products whose planes hold a
    nonzero byte in both blocks (u8 ``wgmma`` takes 8-bit limbs, each
    product exact in s32; a product of a zero block is no work), at the
    int8 tensor-core peak.  Bytes: the planes and masks read once, the
    partials written once."""
    import torch

    from repro_torch.core.butterfly import MASK_ROWS

    bsz, n_planes, n_g, n_k = planes.shape
    n_blocks = masks.shape[1]
    bits = (masks.cpu().long()[..., None] >> torch.arange(n_planes)) & 1
    nw = bits[..., :lw].sum(dim=-1).double()
    ns = bits[..., lw:].sum(dim=-1).double()
    rows = torch.full((n_blocks,), float(MASK_ROWS), dtype=torch.float64)
    rows[-1] = n_g - MASK_ROWS * (n_blocks - 1)
    pairs = (torch.outer(rows, rows).triu(1)
             + torch.diag(rows * (rows - 1) / 2))
    need = (nw[:, :, None] * nw[:, None, :]
            + ns[:, :, None] * ns[:, None, :])
    macs = float((need * pairs).sum()) * n_k
    every = float(pairs.sum()) * bsz * (lw ** 2 + (n_planes - lw) ** 2) * n_k
    ops = 2 * macs
    ops_ms = ops / PEAK_INT8_OPS * 1e3
    bytes_ms = (planes.numel() + masks.numel() * 4
                + out.numel() * out.element_size()) / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops,
            macs / every if every else 0.0)


@contextlib.contextmanager
def largest_k2_stack(seen: dict):
    """While open, keep a copy of the largest limb stack (by K2's work,
    ``B * n_g**2 * n_k``) that the pallas tier hands K2, with its block
    masks, ``lw`` and ``block_i``, in ``seen``; ``seen["stacks"]`` counts
    them."""
    from repro_torch.kernels.butterfly import ops

    entry = ops.butterfly_count_pallas_windows_multiset_limbs

    def recording(planes, masks, *, lw, block_i=256):
        work = planes.shape[0] * planes.shape[2] ** 2 * planes.shape[3]
        seen["stacks"] = seen.get("stacks", 0) + 1
        if work > seen.get("work", -1):
            seen.update(work=work, planes=planes.clone(), masks=masks.clone(),
                        lw=lw, block_i=block_i)
        return entry(planes, masks, lw=lw, block_i=block_i)

    ops.butterfly_count_pallas_windows_multiset_limbs = recording
    try:
        yield seen
    finally:
        ops.butterfly_count_pallas_windows_multiset_limbs = entry


def gram_envelope(adj) -> tuple[float, float, float]:
    """For one weighted biadjacency: the largest ``W^2`` and ``S`` entry and
    the sum of ``(W^2 - S)/2`` over the whole matrix (diagonal included, as
    the dense tier sums it), all in float64.  When all three stay below
    2**24 every float32 step of the dense tier and K2 is exact."""
    import torch

    a = adj.to(torch.float64)
    if a.shape[0] > a.shape[1]:
        a = a.T
    w = a @ a.T
    a2 = a * a
    s = a2 @ a2.T
    return (float((w * w).max()), float(s.max()),
            float(((w * w - s) * 0.5).sum()))


def phase_kernel_k2(seen, device) -> dict:
    """Phase 1 for K2: equal to its plain version bit for bit and, below
    2**24, to the float64 plain version on adversarial shapes with
    multiplicities <= 8 (through the float32 entry, route
    ``wgmma_limbs_copy``); equal to its plain version bit for bit and
    within RTOL_K2 of the float64 one on the largest limb stack the
    multiset engine handed K2 in phase 4 (``seen``, from
    :func:`largest_k2_stack`, route ``wgmma_limbs``), then its time
    there."""
    import torch

    from repro_torch.core.butterfly import (
        full_fp32_matmul,
        join_limbs,
        limb_block_masks,
    )
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.kernels.butterfly.ops import clamp_block_i, window_sums

    max_err = 0.0
    cuda = device.type == "cuda"
    gen = torch.Generator().manual_seed(13)
    rng = np.random.default_rng(13)

    def sparse_weights(shape, density):
        present = torch.rand(shape, generator=gen) < density
        mult = torch.randint(1, 9, shape, generator=gen).float()
        return (present * mult).to(device)

    corpus = corpus_edges()
    corpus_m = [rng.integers(1, 9, len(e)) for e in corpus]
    hub = torch.zeros((2, 600, 700), dtype=torch.float32)
    hub[0, 256, :] = 1.0                      # hub on the first row of tile 1
    hub[0, 255, ::2] = 1.0                    # and its neighbour across the edge
    hub[0, ::3, 5] = torch.randint(1, 9, (200,), generator=gen).float()
    hub[1] = (torch.rand((600, 700), generator=gen) < 0.02).float() * (
        torch.randint(1, 9, (600, 700), generator=gen).float())
    cstack = weighted_stack(corpus, corpus_m, device)
    cases = {
        "adversarial corpus": cstack,
        "corpus oriented": cstack.transpose(1, 2).contiguous(),
        "all-zero windows": torch.zeros((3, 70, 90), device=device),
        "n_i > n_j": sparse_weights((2, 300, 40), 0.05),
        "non-tile-multiple": sparse_weights((3, 129, 515), 0.02),
        "hub on a tile boundary": hub.to(device),
    }
    for what, a in cases.items():
        for block_i in (8, 64, 256):
            bi = clamp_block_i(block_i, a.shape[1])
            want64 = kk.butterfly_pairs_windows_multiset_plain(
                a, block_i=bi, dtype=torch.float64)
            check(want64.numel() == 0 or float(want64.abs().max()) < 2**24,
                  f"K2 case {what} passes 2**24: not an exactness case")
            kk.reset_launch_count()
            got = kk.butterfly_pairs_windows_multiset_kernel_call(a,
                                                                  block_i=bi)
            want = kk.butterfly_pairs_windows_multiset_plain(a, block_i=bi)
            sync(device)
            err = (float((got.double() - want64).abs().max())
                   if got.numel() else 0.0)
            max_err = max(max_err, err)
            check(torch.equal(got, want),
                  f"K2 != plain on {what} (block_i={bi})")
            check(torch.equal(got.double(), want64),
                  f"K2 != float64 plain on {what} (block_i={bi}, max abs "
                  f"err {err})")
            check(not cuda or got.numel() == 0
                  or kk.launch_count("K2", "wgmma_limbs_copy") == 1,
                  f"K2 on {what} did not take the route wgmma_limbs_copy")
    log(f"[kernel] K2 (a) adversarial shapes, multiplicities <= 8, every "
        f"partial below 2**24: K2 == plain and == float64 plain exactly "
        f"({len(cases)} float32 stacks x 3 tile sizes, each through one "
        f"limb split, route wgmma_limbs_copy)")

    # (b) the largest limb stack the engine handed K2 in phase 4's counted
    # run, at the tile the pallas tier clamps it to
    planes, masks, lw = seen["planes"], seen["masks"], seen["lw"]
    bsz, n_planes, n_g, n_k = planes.shape
    block_i = clamp_block_i(seen["block_i"], n_g)
    check(torch.equal(masks, limb_block_masks(planes)),
          "the scatter's block masks differ from the planes' own")
    kk.reset_launch_count()
    got = kk.butterfly_pairs_windows_multiset_limbs_call(
        planes, masks, lw=lw, block_i=block_i)
    sync(device)
    check(not cuda or kk.launch_count("K2", "wgmma_limbs") == 1,
          "K2 on the engine's limb stack did not take the route wgmma_limbs")
    want = kk.butterfly_pairs_windows_multiset_plain(planes, block_i=block_i,
                                                     lw=lw)
    check(torch.equal(got, want),
          f"K2 != plain on the engine's largest limb stack (max abs err "
          f"{float((got - want).abs().max())})")
    adjs = join_limbs(planes, lw).to(torch.float32)
    want64 = kk.butterfly_pairs_windows_multiset_plain(adjs, block_i=block_i,
                                                       dtype=torch.float64)
    counts64, want_counts = window_sums(got).double(), want64.sum(dim=1)
    rel = float(((counts64 - want_counts).abs()
                 / want_counts.abs().clamp_min(1.0)).max())
    prel = float(((got.double() - want64).abs()
                  / want64.abs().clamp_min(1.0)).max())
    max_err = max(max_err, float((got.double() - want64).abs().max()))
    max_mult = int(adjs.max())
    vsq = kk.vertex_sq(adjs)
    hist = {}
    for window in masks.cpu().tolist():
        seen_planes = 0
        for m in window:
            seen_planes |= m
        limbs = ((seen_planes & ((1 << lw) - 1)).bit_length(),
                 (seen_planes >> lw).bit_length())
        hist[limbs] = hist.get(limbs, 0) + 1
    hist_s = ", ".join(f"(lw {a}, ls {b}): {c}" for (a, b), c in
                       sorted(hist.items()))
    log(f"[kernel] K2 (b) the largest of the {seen['stacks']} limb stacks "
        f"the multiset engine handed K2 in phase 4 (planes [{bsz}, "
        f"{n_planes}, {n_g}, {n_k}] uint8, lw={lw}, ls={n_planes - lw}, "
        f"block_i={block_i}, multiplicities up to {max_mult}; windows by "
        f"the limbs they need: {hist_s}; overflow margin: largest sum of "
        f"squared multiplicities at one vertex {vsq} of the "
        f"{kk.MAX_VERTEX_SQ} K2 takes, {vsq / kk.MAX_VERTEX_SQ:.6%}): K2 == "
        f"plain bit for bit (route wgmma_limbs); window counts up to "
        f"{float(want_counts.max()):.6g}, partials up to "
        f"{float(want64.max()):.6g}; K2 vs float64 plain: max rel err "
        f"{rel:.6g} per window count (bound {RTOL_K2}), {prel:.6g} per "
        f"partial")
    check(rel <= RTOL_K2, f"K2 vs float64 plain: rel err {rel} > {RTOL_K2}")

    ms = time_ms(lambda: kk.butterfly_pairs_windows_multiset_limbs_call(
        planes, masks, lw=lw, block_i=block_i), device, reps=10, warmup=2)
    plain_ms = time_ms(lambda: kk.butterfly_pairs_windows_multiset_plain(
        planes, block_i=block_i, lw=lw), device, reps=2)

    def library():
        with full_fp32_matmul():
            w = torch.bmm(adjs, adjs.transpose(1, 2))
            a2 = adjs * adjs
            s2 = torch.bmm(a2, a2.transpose(1, 2))
        pairs = (w * w - s2) * 0.5
        return (pairs.sum(dim=(1, 2))
                - torch.diagonal(pairs, dim1=1, dim2=2).sum(dim=1)) * 0.5

    library_ms = time_ms(library, device)
    lib_rel = float(((library().double() - want_counts).abs()
                     / want_counts.abs().clamp_min(1.0)).max())
    check(lib_rel <= RTOL_MULTISET,
          f"the bmm yardstick is {lib_rel} off the float64 counts")
    bound_ms, bound_by, ops, share = k2_bounds(planes, masks, lw, got)
    log(f"[kernel] K2 timing there: K2 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"two float32 torch.bmm Grams + epilogue {library_ms:.4f} ms (max "
        f"rel err {lib_rel:.6g} vs float64; K2 {library_ms / ms:.4f}x "
        f"faster); bound {bound_ms:.4f} ms ({bound_by}: {ops:.4g} int8 "
        f"operations at the int8 tensor-core peak, the limb products each "
        f"pair of 64-row blocks needs: {share:.4%} of all {lw}**2 + "
        f"{n_planes - lw}**2 in every pair); K2 at {bound_ms / ms:.4%} of "
        f"the bound")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "rel": rel}


def max_vertex_sq(wins) -> int:
    """The largest sum of squared multiplicities at one vertex (either
    side) over ``replay_dynamic``'s windows: what K2's overflow guard
    (``check_no_wrap``) holds to its limit."""
    top = 0
    for w in wins:
        if len(w.mult) == 0:
            continue
        sq = w.mult.astype(np.int64) ** 2
        for side in (0, 1):
            _, inv = np.unique(w.edges[:, side], return_inverse=True)
            top = max(top, int(np.bincount(inv, weights=sq).max()))
    return top


def phase_multiset(stream, wins, nt_w, alpha0, device, seen: dict):
    """Phase 4: the multiset engine on pallas (K2) and dense, held to
    itself bit for bit across micro-batch sizes and a restore, and to the
    int64 oracle on ``wins`` (``replay_dynamic``'s windows) within
    RTOL_MULTISET.  The largest stack K2 receives in the counted run is
    kept in ``seen`` for phase 1's K2 check.  Returns K2's launches, its
    routes and the pallas counts (phase 15 holds the sharded engine to
    them)."""
    import torch

    from repro_torch.core import count_butterflies_multiset_np
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.streams import EngineConfig

    n = len(stream)
    cols = (stream.tau, stream.edge_i, stream.edge_j)
    margin = max_vertex_sq(wins)
    pallas = EngineConfig(tier="pallas", dup_policy="multiset",
                          flush_every=32, device=device)
    kk.reset_launch_count()
    t0 = time.perf_counter()
    with largest_k2_stack(seen):
        _, res, half, n_sd = push_engine(pallas, nt_w, alpha0, *cols,
                                         restore_at=n // 2)
        sync(device)
    sec = time.perf_counter() - t0
    launches, routes = kk.launch_count("K2"), k2_routes(kk)
    check(launches > 0 or device.type != "cuda",
          "the multiset engine never launched K2")
    check(kk.launch_count("K2", "wgmma_limbs") == launches,
          "a K2 launch of the multiset engine did not read the scatter's "
          "limb stack as it lies")
    check(kk.launch_count("K1") == 0, "the multiset engine launched K1")
    check(len(res.window_counts) == len(wins), "multiset window count")
    log(f"[multiset] pallas (K2), mb=256, flush_every=32, state_dict/"
        f"restore after {half} sgrs ({n_sd} windows): {len(wins)} windows, "
        f"{n} sgrs in {sec:.4f} s = {n / sec:.4f} sgrs/s; K2 launches "
        f"{launches}, every one on the scatter's limb stack as it lies "
        f"(route wgmma_limbs); largest sum of squared multiplicities at one "
        f"vertex {margin} of the {kk.MAX_VERTEX_SQ} K2 takes "
        f"({margin / kk.MAX_VERTEX_SQ:.6%})")
    t0 = time.perf_counter()
    _, whole, _, _ = push_engine(pallas, nt_w, alpha0, *cols, mb=n)
    sync(device)
    wsec = time.perf_counter() - t0
    check(np.array_equal(whole.window_counts, res.window_counts),
          "multiset pallas counts differ between mb=256 + restore and "
          "mb=the whole stream")
    check(np.array_equal(whole.estimates, res.estimates),
          "multiset pallas estimates differ between mb=256 + restore and "
          "mb=the whole stream")
    log(f"[multiset] pallas at mb={n} (one push, {wsec:.4f} s): counts and "
        f"estimates bit-identical to mb=256 across the restore")
    t0 = time.perf_counter()
    _, dense, _, _ = push_engine(EngineConfig(
        tier="dense", dup_policy="multiset", flush_every=32, device=device),
        nt_w, alpha0, *cols, mb=n)
    sync(device)
    dsec = time.perf_counter() - t0
    pc, dc = res.window_counts, dense.window_counts
    rel_pd = float(np.max(np.abs(pc - dc) / np.maximum(np.abs(dc), 1.0)))
    log(f"[multiset] dense at mb={n}: {dsec:.4f} s; pallas vs dense max rel "
        f"diff {rel_pd:.6g} over {len(pc)} windows ({int(np.sum(pc != dc))} "
        f"differ); counts {pc.min():.6g}..{pc.max():.6g} per window")
    check(rel_pd <= RTOL_MULTISET,
          f"multiset pallas vs dense: rel diff {rel_pd} > {RTOL_MULTISET}")

    worst = {"pallas": 0.0, "dense": 0.0}
    n_exact = 0
    envelope = []
    t0 = time.perf_counter()
    for k in range(0, len(wins), 10):
        e, m = wins[k].edges, wins[k].mult
        want = count_butterflies_multiset_np(e, m)
        # the window's weighted biadjacency on compact ids
        ui, ci = np.unique(e[:, 0], return_inverse=True)
        uj, cj = np.unique(e[:, 1], return_inverse=True)
        adj = torch.zeros((len(ui), len(uj)), dtype=torch.float32,
                          device=device)
        adj[torch.as_tensor(ci, device=device),
            torch.as_tensor(cj, device=device)] = torch.as_tensor(
                m.astype(np.float32), device=device)
        w2, smax, total = gram_envelope(adj)
        envelope.append((k, w2, smax))
        small = max(w2, smax, abs(total)) < 2**24
        for tier, c in (("pallas", pc[k]), ("dense", dc[k])):
            rel = abs(c - want) / max(abs(want), 1.0)
            worst[tier] = max(worst[tier], rel)
            check(rel <= RTOL_MULTISET,
                  f"window {k}: multiset {tier} {c} vs oracle {want}: rel "
                  f"err {rel} > {RTOL_MULTISET}")
            check(not small or c == want,
                  f"window {k}: W^2, S and the pair sum stay below 2**24 "
                  f"but {tier} {c} != oracle {want}")
        n_exact += small
    osec = time.perf_counter() - t0
    top = max(envelope, key=lambda x: x[1])
    log(f"[multiset] int64 oracle on every 10th window ({len(envelope)} "
        f"windows, {osec:.4f} s): largest rel err pallas "
        f"{worst['pallas']:.6g}, dense {worst['dense']:.6g} (bound "
        f"{RTOL_MULTISET}); {n_exact} of them keep W^2, S and the pair sum "
        f"below 2**24 and are exact; largest W^2 {top[1]:.6g} and S "
        f"{max(x[2] for x in envelope):.6g} (window {top[0]})")
    return launches, routes, res.window_counts


def phase_dynamic(device, *, n_records, nt_w, n_ids, seed, alpha0):
    """Phase 5: a dynamic stream with deletes and duplicates through the
    engine's windowizer and the engine under both policies on pallas,
    against ``replay_dynamic`` and ``oracle_window_counts``.  Returns the
    windowizer's closed windows and the oracle's, for phase 11."""
    import torch

    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.streams import (
        EngineConfig,
        dynamic_sgr_stream,
        oracle_window_counts,
        replay_dynamic,
    )
    from repro_torch.streams.engine import resolve_pending_window
    from repro_torch.streams.state import (
        stream_state_init,
        windowizer_close_tail,
        windowizer_push,
    )

    t0 = time.perf_counter()
    tau, ei, ej, op = dynamic_sgr_stream(n_records, nt_w, delete_frac=0.1,
                                         dup_frac=0.2, n_i=n_ids, n_j=n_ids,
                                         seed=seed)
    gsec = time.perf_counter() - t0
    oracle = replay_dynamic(tau, ei, ej, op, nt_w=nt_w)
    n_del = int((op == 1).sum())
    log(f"[dynamic] dynamic_sgr_stream({n_records}, {nt_w}, delete_frac=0.1,"
        f" dup_frac=0.2, ids {n_ids} x {n_ids}, seed={seed}) in {gsec:.4f} s:"
        f" {n_del} deletes, {len(oracle)} windows of up to "
        f"{max(len(w.edges) for w in oracle)} surviving edges, "
        f"multiplicities up to {max(int(w.mult.max()) for w in oracle)}")

    # the engine's windowizer and resolution against the oracle's loop
    st = stream_state_init(1, alpha0)
    closed = []
    for a in range(0, len(tau), 256):
        closed += windowizer_push(st, 0, tau[a:a + 256], ei[a:a + 256],
                                  ej[a:a + 256], nt_w, op=op[a:a + 256])
    tail = windowizer_close_tail(st, 0, nt_w, drop_partial=True)
    closed += [] if tail is None else [tail]
    check(len(closed) == len(oracle), "windowizer and oracle window counts")
    for k, ((_, wi, wj, ops, m, end), ow) in enumerate(zip(closed, oracle)):
        e, mult = resolve_pending_window(wi, wj, ops, "multiset")
        ed, _ = resolve_pending_window(wi, wj, ops, "distinct")
        check(np.array_equal(e, ow.edges) and np.array_equal(mult, ow.mult),
              f"window {k}: multiset edges or multiplicities differ")
        check(np.array_equal(np.unique(ed, axis=0), ow.edges),
              f"window {k}: distinct edge set differs")
        check(m == ow.n_sgrs and end == ow.end_tau,
              f"window {k}: n_sgrs or end_tau differ")
    margin = max_vertex_sq(oracle)
    log(f"[dynamic] the engine's windows (edges, multiplicities, n_sgrs, "
        f"end_tau) equal replay_dynamic's on all {len(oracle)} windows; "
        f"largest sum of squared multiplicities at one vertex {margin} of "
        f"the {kk.MAX_VERTEX_SQ} K2 takes ({margin / kk.MAX_VERTEX_SQ:.6%})")

    launches = {}
    for policy, kernel in (("distinct", "K1"), ("multiset", "K2")):
        want = oracle_window_counts(oracle, policy)
        for k, w in enumerate(oracle):
            if len(w.edges) == 0:
                continue
            adj = torch.zeros((n_ids, n_ids), dtype=torch.float32,
                              device=device)
            adj[torch.as_tensor(w.edges[:, 0], device=device),
                torch.as_tensor(w.edges[:, 1], device=device)] = (
                torch.as_tensor((w.mult if policy == "multiset"
                                 else np.ones_like(w.mult)).astype(
                                     np.float32), device=device))
            check(max(gram_envelope(adj)) < 2**24,
                  f"dynamic window {k} leaves the exact envelope")
        kk.reset_launch_count()
        t0 = time.perf_counter()
        eng, res, _, _ = push_engine(
            EngineConfig(tier="pallas", dup_policy=policy, flush_every=8,
                         device=device), nt_w, alpha0, tau, ei, ej, op=op)
        sync(device)
        sec = time.perf_counter() - t0
        launches[kernel] = kk.launch_count(kernel)
        check(launches[kernel] > 0 or device.type != "cuda",
              f"the {policy} dynamic engine never launched {kernel}")
        check(np.array_equal(res.window_counts, want),
              f"dynamic {policy}: engine counts differ from the oracle")
        check(np.array_equal(res.cum_edges,
                             np.cumsum([w.n_sgrs for w in oracle])),
              f"dynamic {policy}: |E_k| differs from the oracle")
        check(np.array_equal(eng.state_dict()["end_tau"],
                             [w.end_tau for w in oracle]),
              f"dynamic {policy}: end_tau differs from the oracle")
        log(f"[dynamic] {policy} on pallas ({kernel} launches "
            f"{launches[kernel]}), mb=256: counts equal oracle_window_counts "
            f"on all {len(oracle)} windows (every W^2, S and pair sum below "
            f"2**24, so exact); counts {want.min():.6g}..{want.max():.6g}; "
            f"{n_records} records in {sec:.4f} s")
    return closed, oracle


def phase_tiers(wb, alpha0, device, dense_counts) -> None:
    """Phase 6: one distinct replay on tiled, sparse and auto, exact against
    dense; wall time, and device time on every fourth window; auto's sparse
    buckets; and the card's crossover for route_tier on every third
    bucket."""
    import torch

    from repro_torch.core import (
        WindowExecutor,
        build_biadjacency,
        count_butterflies_dense,
        count_butterflies_sparse,
        route_tier,
        run_sgrapp,
    )

    # the profiles replay every fourth window: the profiler's processing of
    # the whole replays' 15,000-26,000 launches took most of the phase
    sub = wb.take(np.arange(0, wb.n_windows, 4))
    for tier in ("tiled", "sparse", "auto"):
        ex = WindowExecutor(tier, device=device)
        t0 = time.perf_counter()
        res = run_sgrapp(wb, alpha0, executor=ex)
        sync(device)
        wall = time.perf_counter() - t0
        bad = np.flatnonzero(res.window_counts != dense_counts)
        check(bad.size == 0, f"{tier} != dense on windows {bad[:10]}")
        _, busy, _ = profile(
            f"tiers, replay on {tier}, every 4th window ({sub.n_windows})",
            lambda: run_sgrapp(sub, alpha0, executor=ex), device, top=3)
        plan = ex.plan(wb)
        extra = ""
        if tier == "auto":
            sp = [b for b in plan if ex.bucket_tier(b) == "sparse"]
            extra = (f"; auto sent {len(sp)} of {len(plan)} buckets "
                     f"({sum(b.n_windows for b in sp)} windows) to sparse, "
                     f"the largest "
                     + ", ".join(f"{b.cap_e}x{b.cap_i}x{b.cap_j} w{b.cap_w}"
                                 for b in sp[-3:]))
        log(f"[tiers] {tier}: {wb.n_windows} windows equal dense exactly; "
            f"wall {wall:.4f} s; device busy {busy:.4f} ms under the "
            f"profiler on every 4th window; {len(plan)} buckets{extra}")

    # the crossover: on every third bucket of auto's plan (all 91 took
    # about 50 s), one chunk on dense and on sparse, against the cost
    # model's two terms
    ex = WindowExecutor("auto", device=device)
    rows = []
    for b in ex.plan(wb)[::3]:
        win = b.windows[:ex.chunk]
        ei, ej, v = (torch.as_tensor(x[win, :b.cap_e], device=device)
                     for x in (wb.edge_i, wb.edge_j, wb.valid))
        t_d = time_ms(lambda: count_butterflies_dense(build_biadjacency(
            ei, ej, v, b.cap_i, b.cap_j)), device, reps=2)
        t_s = time_ms(lambda: count_butterflies_sparse(
            ei, ej, v, b.cap_i, b.cap_j, max(b.cap_w, 1)), device, reps=2)
        dense_flops = float(b.cap_i) * b.cap_j * min(b.cap_i, b.cap_j)
        sort_ops = (b.cap_e * max(np.log2(max(b.cap_e, 2)), 1.0)
                    + b.cap_w * max(np.log2(max(b.cap_w, 2)), 1.0))
        rows.append((dense_flops / sort_ops, t_d, t_s,
                     route_tier(b.cap_e, b.cap_i, b.cap_j, b.cap_w)))
    ratio = np.array([r[0] for r in rows])
    t_d = np.array([r[1] for r in rows])
    t_s = np.array([r[2] for r in rows])
    implied = (t_s / (t_d / ratio))       # sort_cost at which the model ties
    sparse_wins = t_s < t_d
    agree = np.mean([(r[3] == "sparse") == w for r, w in zip(rows,
                                                            sparse_wins)])
    cands = np.concatenate([[0.0], np.sort(ratio), [np.inf]])
    misroutes = [int(np.sum((c < ratio) != sparse_wins)) for c in cands]
    best = cands[int(np.argmin(misroutes))]
    log(f"[tiers] route_tier crossover over {len(rows)} buckets (one chunk "
        f"each, dense vs sparse on the card): sparse faster in "
        f"{int(sparse_wins.sum())}; the sort cost at which the model ties "
        f"each bucket's measured times is {np.median(implied):.6g} dense "
        f"flops per sort element (median; range {implied.min():.6g}.."
        f"{implied.max():.6g}); sort_cost=96 routes {agree:.2%} of buckets "
        f"to the faster tier; the fewest misroutes ({min(misroutes)}) come "
        f"at sort_cost = {best:.6g}; dense {t_d.sum():.4f} ms vs sparse "
        f"{t_s.sum():.4f} ms summed over the chunks")


def phase_k3(wb, replay_counts, device) -> dict:
    """Phase 7: single matrices through K3 (K1's kernel at B = 1)."""
    import torch

    from repro_torch.core import build_biadjacency
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.kernels.butterfly.ops import (
        butterfly_count_pallas,
        butterfly_count_tiles,
        clamp_block_i,
        oriented,
    )

    def matrix(k):
        n_i, n_j = int(wb.n_i_per_window[k]), int(wb.n_j_per_window[k])
        ei, ej, v = (torch.as_tensor(x[k], device=device)
                     for x in (wb.edge_i, wb.edge_j, wb.valid))
        return build_biadjacency(ei, ej, v, n_i, n_j)

    picks = list(range(0, wb.n_windows, 25))
    kk.reset_launch_count()
    for k in picks:
        adj = matrix(k)
        c1 = float(butterfly_count_pallas(adj))
        c2 = butterfly_count_tiles(adj)
        check(c1 == c2 == replay_counts[k],
              f"window {k}: K3 {c1} / {c2} != replay {replay_counts[k]}")
    launches = kk.launch_count("K3")
    routes = {r: kk.launch_count("K3", r) for r in kk.ROUTES}
    check(launches == 2 * len(picks) or device.type != "cuda",
          f"K3 launches {launches} != {2 * len(picks)}")
    log(f"[k3] butterfly_count_pallas and butterfly_count_tiles equal the "
        f"replay on {len(picks)} windows; K3 launches {launches} (routes "
        f"{routes}: float32 matrices go through the padded uint8 copy)")

    k = int(np.argmax(wb.n_i_per_window * wb.n_j_per_window))
    a = oriented(matrix(k))
    n_g, n_k = a.shape
    block_i = clamp_block_i(256, n_g)
    kk.reset_launch_count()
    got = kk.butterfly_pairs_kernel_call(a, block_i=block_i)
    want = kk.butterfly_pairs_plain(a, block_i=block_i)
    sync(device)
    route = "wgmma" if kk.tma_ready(a) else "wgmma_padded"
    check(device.type != "cuda" or kk.launch_count("K3", route) == 1,
          f"K3 did not take the route {route}")
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"K3 != plain (max abs err {err})")
    ms = time_ms(lambda: kk.butterfly_pairs_kernel_call(a, block_i=block_i),
                 device, reps=20, warmup=2)
    plain_ms = time_ms(lambda: kk.butterfly_pairs_plain(a, block_i=block_i),
                       device)
    lib_ms = {}
    for name, fn in gram_yardsticks(a).items():
        check(torch.allclose(fn().double(), got.double().sum(), rtol=1e-6,
                             atol=0),
              f"the {name} yardstick computes another function than K3")
        lib_ms[name] = time_ms(fn, device)
    bound_ms, bound_by, ops = k1_bounds(a[None], got[None])
    log(f"[k3] K3 == plain exactly on the largest window ({k}: "
        f"{str(a.dtype).split('.')[-1]} [{n_g}, {n_k}], block_i={block_i}, "
        f"route {route}): K3 {ms:.4f} ms with its padded copy, plain "
        f"{plain_ms:.4f} ms; torch.mm Gram + epilogue: float32 "
        f"{lib_ms['fp32']:.4f} ms, bf16 with float32 output "
        f"{lib_ms['bf16']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{ops:.4g} at the int8 tensor-core peak, the float32 matrix read "
        f"once); {bound_ms / ms:.4%} of the bound, "
        f"{lib_ms['fp32'] / ms:.4f}x faster than the float32 yardstick and "
        f"{lib_ms['bf16'] / ms:.4f}x than the bf16 one")
    return {"launches": launches, "routes": routes, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms["bf16"],
            "fp32_library_ms": lib_ms["fp32"], "bound_ms": bound_ms,
            "bound_by": bound_by}


def k1_routes(kk) -> dict:
    """K1's launches so far by route."""
    return {r: kk.launch_count("K1", r) for r in kk.ROUTES}


def k2_routes(kk) -> dict:
    """K2's launches so far by route."""
    return {r: kk.launch_count("K2", r) for r in kk.K2_ROUTES}


def add_routes(*routes: dict) -> dict:
    """The sum of route counts, route by route."""
    return {r: sum(d[r] for d in routes) for r in routes[0]}


def phase_entries(stream, wb, nt_w, device, replay_counts, dyn_closed,
                  dyn_oracle) -> tuple[int, dict]:
    """Phase 11: the executor's entries on pallas (K1): ``run`` in tumbling
    and sliding mode, the multi-stream refusal, ``count_edges`` on raw
    windows and ``decrement_window_counts`` on phase 5's dynamic windows.
    Returns K1's launches and routes over the phase."""
    import dataclasses

    from repro_torch.core import WindowExecutor, count_butterflies_np
    from repro_torch.core.windows import window_bounds
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.streams import oracle_window_counts

    ex = WindowExecutor("pallas", device=device)
    kk.reset_launch_count()
    t0 = time.perf_counter()
    tumbling = ex.run(wb)
    sync(device)
    tsec = time.perf_counter() - t0
    check(np.array_equal(tumbling.counts, replay_counts),
          "run(mode='tumbling') differs from phase 2's counts")
    check(tumbling.mode == "tumbling" and tumbling.n_shards == 1,
          "tumbling result fields")
    launches_run = kk.launch_count("K1")
    check(launches_run > 0 or device.type != "cuda", "run() never launched K1")
    prefix = np.concatenate([[0.0], np.cumsum(replay_counts)])
    t0 = time.perf_counter()
    dense = WindowExecutor("dense", device=device).run(
        wb, mode="sliding", span=32)
    sync(device)
    dsec = time.perf_counter() - t0
    secs = []
    for span in (1, 4, 32):
        t0 = time.perf_counter()
        got = ex.run(wb, mode="sliding", span=span)
        sync(device)
        secs.append(time.perf_counter() - t0)
        lo = np.maximum(np.arange(wb.n_windows) - span + 1, 0)
        check(np.array_equal(got.counts, prefix[1:] - prefix[lo]),
              f"sliding span {span} differs from the prefix difference")
        check(got.span == span and got.mode == "sliding", "sliding fields")
        if span == 32:
            check(np.array_equal(got.counts, dense.counts),
                  "pallas sliding span 32 differs from dense's")
    log(f"[entries] run(): tumbling equals phase 2 on all {wb.n_windows} "
        f"windows ({tsec:.4f} s); sliding spans 1, 4, 32 equal the prefix "
        f"difference ({', '.join(f'{x:.4f}' for x in secs)} s) and span 32 "
        f"equals dense's sliding run ({dsec:.4f} s); K1 launches "
        f"{kk.launch_count('K1')}")
    mixed = dataclasses.replace(
        wb, stream_ids=(np.arange(wb.n_windows) % 2).astype(np.int32))
    before = (kk.launch_count("K1"), ex.chunks_dispatched)
    try:
        ex.run(mixed, mode="sliding", span=4)
    except ValueError as e:
        check("sliding" in str(e), f"unexpected refusal: {e}")
    else:
        raise AssertionError("sliding mode took a multi-stream batch")
    check((kk.launch_count("K1"), ex.chunks_dispatched) == before,
          "the refused sliding run dispatched work")
    log("[entries] a two-tenant batch in sliding mode raises before any "
        "dispatch (no K1 launch, no chunk)")

    bounds = window_bounds(stream.tau, nt_w)
    picks = list(range(0, wb.n_windows, 10))
    n0, r0 = kk.launch_count("K1"), k1_routes(kk)
    t0 = time.perf_counter()
    for k in picks:
        a, b = bounds[k]
        got = ex.count_edges(stream.edge_i[a:b], stream.edge_j[a:b])
        check(got == replay_counts[k],
              f"count_edges window {k}: {got} != replay {replay_counts[k]}")
    sync(device)
    csec = time.perf_counter() - t0
    n_ce = kk.launch_count("K1") - n0
    routes_ce = {r: kk.launch_count("K1", r) - r0[r] for r in kk.ROUTES}
    check(n_ce == len(picks) or device.type != "cuda",
          f"count_edges launched K1 {n_ce} times for {len(picks)} windows")
    check(routes_ce["wgmma"] == n_ce,
          f"count_edges K1 routes {routes_ce}: a stack went through a "
          "padded copy")
    log(f"[entries] count_edges on the raw, duplicated sgrs of every 10th "
        f"window ({len(picks)} windows, {csec:.4f} s) equals the replay; "
        f"K1 launches {n_ce} at B = 1, routes {routes_ce} (the [1, cap_i, "
        f"cap_j] uint8 stack as it lies)")

    per_edges, per_del, prior = [], [], []
    for (_, wi, wj, ops, _, _), ow in zip(dyn_closed, dyn_oracle):
        ins = np.stack([wi, wj], 1)
        if ops is not None:
            ins = ins[ops > 0]
        ins = np.unique(ins.astype(np.int64), axis=0)
        keep = np.isin(ins[:, 0] << 32 | ins[:, 1],
                       ow.edges[:, 0] << 32 | ow.edges[:, 1])
        per_edges.append(ins)
        per_del.append(ins[~keep])
        prior.append(count_butterflies_np(ins))
    want = oracle_window_counts(dyn_oracle, "distinct")
    n_del = sum(len(d) for d in per_del)
    for frac in (0.0, 1.0):
        n0 = kk.launch_count("K1")
        t0 = time.perf_counter()
        got = ex.decrement_window_counts(per_edges, per_del,
                                         np.asarray(prior, np.float64),
                                         delta_frac=frac)
        sync(device)
        sec = time.perf_counter() - t0
        check(np.array_equal(got, want),
              f"decrement_window_counts (delta_frac={frac}) differs from "
              "oracle_window_counts")
        n_dec = kk.launch_count("K1") - n0
        if frac == 0.0:
            check(n_dec > 0 or device.type != "cuda",
                  "the recount route never launched K1")
        else:
            check(n_dec == 0, f"the delta route launched K1 {n_dec} times")
        log(f"[entries] decrement_window_counts, delta_frac={frac} "
            f"({'all recount' if frac == 0.0 else 'all delta'}): "
            f"{n_del} deletions over {len(per_edges)} windows of phase 5 "
            f"equal oracle_window_counts ({sec:.4f} s); K1 launches {n_dec}")
    return kk.launch_count("K1"), k1_routes(kk)


def push_fleet(fleet, tenants, mb, start, stop):
    """Push each tenant's records [start, stop) interleaved at ``mb``."""
    for a in range(start, stop, mb):
        for sid, t in enumerate(tenants):
            b = min(a + mb, stop)
            fleet.push(sid, t.tau[a:b], t.edge_i[a:b], t.edge_j[a:b])


def phase_multistream(device, *, n_sgrs, n_unique, nt_w, seed,
                      alpha0) -> dict:
    """Phase 12: ``N_TENANTS`` streams interleaved through one
    ``MultiStreamSGrapp`` on pallas under both policies (K1, K2), across a
    state_dict / restore at the midpoint; every tenant equals a dedicated
    engine bit for bit, and the fleet equals a ``dense`` fleet: exactly
    under distinct, within RTOL_MULTISET under multiset.  Returns each
    kernel's launches and routes, each policy's fleet results and the
    tenants' streams (phase 14 serves them)."""
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.streams import (
        EngineConfig,
        MultiStreamSGrapp,
        bipartite_pa_stream,
    )

    t0 = time.perf_counter()
    tenants = [bipartite_pa_stream(n_sgrs, temporal="uniform",
                                   n_unique=n_unique, seed=seed + s)
               for s in range(N_TENANTS)]
    log(f"[multi] {N_TENANTS} tenants of bipartite_pa_stream({n_sgrs}, "
        f"n_unique={n_unique}, seed={seed}+s) in "
        f"{time.perf_counter() - t0:.4f} s")
    half = (n_sgrs // 2 // MB) * MB
    out = {}
    for policy, kernel in (("distinct", "K1"), ("multiset", "K2")):
        cfg = EngineConfig(tier="pallas", dup_policy=policy, flush_every=32,
                           device=device)

        def fleet_run(restore, stop=n_sgrs):
            fleet = MultiStreamSGrapp(N_TENANTS, nt_w, alpha0, config=cfg)
            push_fleet(fleet, tenants, MB, 0, half if restore else stop)
            if restore:
                sd = fleet.state_dict()
                fleet = MultiStreamSGrapp(N_TENANTS, nt_w, alpha0,
                                          config=cfg).restore(sd)
                push_fleet(fleet, tenants, MB, half, n_sgrs)
            return fleet.finalize()

        kk.reset_launch_count()
        t0 = time.perf_counter()
        res = fleet_run(True)
        sync(device)
        sec = time.perf_counter() - t0
        launches = kk.launch_count(kernel)
        routes = k1_routes(kk) if kernel == "K1" else k2_routes(kk)
        other = "K2" if kernel == "K1" else "K1"
        check(launches > 0 or device.type != "cuda",
              f"the {policy} fleet never launched {kernel}")
        check(kk.launch_count(other) == 0,
              f"the {policy} fleet launched {other}")
        check(routes["wgmma" if kernel == "K1" else "wgmma_limbs"]
              == launches, f"{kernel} routes {routes}: a padded copy")
        n_win = [len(r.window_counts) for r in res]
        t0 = time.perf_counter()
        for sid, t in enumerate(tenants):
            _, ded, _, _ = push_engine(cfg, nt_w, alpha0, t.tau, t.edge_i,
                                       t.edge_j, mb=MB)
            check(np.array_equal(res[sid].window_counts, ded.window_counts)
                  and np.array_equal(res[sid].estimates, ded.estimates)
                  and np.array_equal(res[sid].cum_edges, ded.cum_edges),
                  f"{policy} tenant {sid} differs from its dedicated engine")
        sync(device)
        dsec = time.perf_counter() - t0
        log(f"[multi] {policy} on pallas, mb={MB}, flush_every=32, "
            f"state_dict/restore after {half} sgrs per tenant: "
            f"{N_TENANTS * n_sgrs} sgrs in {sec:.4f} s = "
            f"{N_TENANTS * n_sgrs / sec:.4f} sgrs/s; windows per tenant "
            f"{n_win}; {kernel} launches {launches}, routes {routes}; every "
            f"tenant's counts and estimates bit-identical to a dedicated "
            f"StreamingSGrapp ({dsec:.4f} s for the {N_TENANTS})")
        # an independent counter on the same tenants: the dense tier
        t0 = time.perf_counter()
        dense_fleet = MultiStreamSGrapp(N_TENANTS, nt_w, alpha0,
                                        config=cfg.replace(tier="dense"))
        push_fleet(dense_fleet, tenants, n_sgrs, 0, n_sgrs)
        dres = dense_fleet.finalize()
        pc = np.concatenate([r.window_counts for r in res])
        dc = np.concatenate([r.window_counts for r in dres])
        dsec = time.perf_counter() - t0
        if policy == "distinct":
            # distinct counts stay below 2**24: both tiers are exact
            check(np.array_equal(pc, dc),
                  "distinct fleet pallas counts differ from dense")
            log(f"[multi] distinct dense fleet ({dsec:.4f} s): pallas "
                f"counts equal dense on all {len(pc)} windows")
        else:
            rel = float(np.max(np.abs(pc - dc) / np.maximum(np.abs(dc), 1)))
            check(rel <= RTOL_MULTISET,
                  f"multiset fleet pallas vs dense: {rel} > {RTOL_MULTISET}")
            log(f"[multi] multiset dense fleet ({dsec:.4f} s): pallas vs "
                f"dense max rel diff {rel:.6g} over {len(pc)} windows "
                f"(bound {RTOL_MULTISET})")
        # the profile runs on a quarter of each tenant: the profiler's event
        # processing takes about 8 s for a whole fleet
        profile(f"multi-tenant fleet, pallas tier, {policy}, "
                f"{N_TENANTS} tenants x first {n_sgrs // 4} sgrs, mb={MB}",
                lambda: fleet_run(False, n_sgrs // 4), device)
        out[kernel] = (launches, routes)
        out[policy] = res
    out["tenants"] = tenants
    return out


def phase_sampled(stream, wb, nt_w, device, exact, alpha0, *,
                  capacity=2048) -> None:
    """Phase 13: the sampled tier (threefry coins, the dense counter on the
    survivors; no TPU kernel) on the card against the CPU port, its error
    against the exact counts, the degenerate capacity, the reservoir over
    the whole stream, and the sampled engine against the replay."""
    from repro_torch.core import WindowExecutor, reservoir_run, run_sgrapp
    from repro_torch.core.fleet import sample_keep_mask
    from repro_torch.streams import EngineConfig

    import torch

    cpu = torch.device("cpu")

    def sampled(seed, dev):
        return WindowExecutor("sampled", capacity=capacity,
                              gamma=SAMPLED_GAMMA, seed=seed, device=dev)

    res_kw = dict(capacity=RES_CAPACITY, gamma=SAMPLED_GAMMA, seed=0)
    first = wb.take(np.arange(min(SAMPLED_CPU_WINDOWS, wb.n_windows)))
    nz = exact > 0
    errs, secs = [], []
    card0 = None
    t_cpu = 0.0
    for seed in range(SAMPLED_SEEDS):
        t0 = time.perf_counter()
        got = sampled(seed, device).window_counts(wb)
        sync(device)
        secs.append(time.perf_counter() - t0)
        if seed == 0:
            card0 = got
        check(np.isfinite(got).all() and (got >= 0).all(),
              f"seed {seed}: sampled counts not finite and >= 0")
        t0 = time.perf_counter()
        want = sampled(seed, cpu).window_counts(first)
        t_cpu += time.perf_counter() - t0
        check(np.array_equal(got[:first.n_windows], want),
              f"seed {seed}: card and CPU sampled counts differ on the "
              f"first {first.n_windows} windows")
        errs.append(float(np.mean(np.abs(got[nz] / exact[nz] - 1.0))))
    uid = WindowExecutor._batch_uids(first)
    lanes = [torch.as_tensor(x[:, :first.capacity]) for x in
             (first.edge_i, first.edge_j, first.valid)]
    mask_kw = dict(capacity=capacity, gamma=SAMPLED_GAMMA, seed=0)
    keep_c, p_c = sample_keep_mask(*lanes, uid[:, 0], uid[:, 1], **mask_kw)
    keep_g, p_g = sample_keep_mask(*(x.to(device) for x in lanes),
                                   torch.as_tensor(uid[:, 0], device=device),
                                   torch.as_tensor(uid[:, 1], device=device),
                                   **mask_kw)
    check(torch.equal(keep_g.cpu(), keep_c) and torch.equal(p_g.cpu(), p_c),
          "the card's keep masks or rungs differ from the CPU's")
    mean_err = float(np.mean(errs))
    log(f"[sampled] WindowExecutor('sampled', capacity={capacity}, "
        f"gamma={SAMPLED_GAMMA}), seeds 0..{SAMPLED_SEEDS - 1}: replays "
        f"{', '.join(f'{x:.4f}' for x in secs)} s; the card's counts equal "
        f"the CPU port's bit for bit on the first {first.n_windows} windows "
        f"of every seed (CPU {t_cpu:.4f} s), and its seed-0 keep masks and "
        f"p too (kept {int(keep_c.sum())} of {int(first.valid.sum())} "
        f"lanes, p {float(p_c.min()):.6g}..{float(p_c.max()):.6g}); mean "
        f"relative error against phase 2's exact counts per seed "
        f"{', '.join(f'{x:.6f}' for x in errs)}, mean {mean_err:.6f} "
        f"(band 0.6)")
    check(mean_err < 0.6, f"sampled mean relative error {mean_err} >= 0.6")

    big = max(capacity, int(max(b.cap_e for b in WindowExecutor(
        "dense", device=device).plan(wb))))
    t0 = time.perf_counter()
    degenerate = WindowExecutor("sampled", capacity=big,
                                device=device).window_counts(wb)
    sync(device)
    check(np.array_equal(degenerate, exact),
          f"sampled at capacity {big} >= cap_e differs from dense")
    log(f"[sampled] capacity {big} >= every bucket's cap_e: equal to the "
        f"exact counts on all {wb.n_windows} windows "
        f"({time.perf_counter() - t0:.4f} s)")

    t0 = time.perf_counter()
    est_g, res_g = reservoir_run(stream.edge_i, stream.edge_j, **res_kw,
                                 device=device)
    sync(device)
    gsec = time.perf_counter() - t0
    t0 = time.perf_counter()
    est_c, res_c = reservoir_run(stream.edge_i, stream.edge_j, **res_kw,
                                 device=cpu)
    csec = time.perf_counter() - t0
    for name in ("edge_i", "edge_j", "u", "valid", "k"):
        check(torch.equal(getattr(res_g, name).cpu(), getattr(res_c, name)),
              f"reservoir {name} differs between the card and the CPU")
    check(est_g == est_c, f"reservoir estimate {est_g} != CPU {est_c}")
    log(f"[sampled] reservoir_run over the whole stream ({len(stream)} "
        f"sgrs, capacity {RES_CAPACITY}): card {gsec:.4f} s, CPU "
        f"{csec:.4f} s; final lanes, rung k={int(res_g.k)} and estimate "
        f"{est_g:.6g} equal ({int(res_g.valid.sum())} survivors)")

    cfg = EngineConfig(tier="sampled", capacity=capacity, gamma=SAMPLED_GAMMA,
                       seed=0, flush_every=32, device=device)
    t0 = time.perf_counter()
    _, res, _, _ = push_engine(cfg, nt_w, alpha0, stream.tau, stream.edge_i,
                               stream.edge_j, mb=MB)
    sync(device)
    esec = time.perf_counter() - t0
    replay = run_sgrapp(wb, alpha0, executor=sampled(0, device))
    check(np.array_equal(res.window_counts, card0),
          "the sampled engine's counts differ from the seed-0 replay")
    check(np.array_equal(res.window_counts, replay.window_counts)
          and np.array_equal(res.estimates, replay.estimates),
          "the sampled engine's estimates differ from the seed-0 replay")
    log(f"[sampled] StreamingSGrapp(tier='sampled', seed=0) at mb={MB} "
        f"({esec:.4f} s): counts and estimates bit-identical to the seed-0 "
        f"replay on all {len(res.estimates)} windows")
    # the profiles run on a tenth of the work each: the profiler's event
    # processing takes about 20x the wall time of these many-launch paths
    ex0 = sampled(0, device)
    part = wb.take(np.arange(min(25, wb.n_windows)))
    profile(f"sampled replay, capacity {capacity}, seed 0, first "
            f"{part.n_windows} windows", lambda: ex0.window_counts(part),
            device)
    n_res = min(200_000, len(stream))
    profile(f"reservoir_run, capacity {RES_CAPACITY}, first {n_res} sgrs",
            lambda: reservoir_run(stream.edge_i[:n_res], stream.edge_j[:n_res],
                                  **res_kw, device=device), device)


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ndjson(obj: dict) -> bytes:
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def _records(t, a: int, b: int) -> dict:
    from repro_torch.streams.wire import normalize_records, records_to_json

    return records_to_json(normalize_records(t.tau[a:b], t.edge_i[a:b],
                                             t.edge_j[a:b]))


def push_lines(tenants, batch: int) -> list[list[bytes]]:
    """Each tenant's push messages of ``batch`` records as NDJSON lines,
    with ``seq`` = batch index + 1 (so a restarted server sees the same
    seqs)."""
    return [[_ndjson({"type": "push", "seq": k + 1,
                      "records": _records(t, a, a + batch)})
             for k, a in enumerate(range(0, len(t), batch))]
            for t in tenants]


async def ndjson_tenant(host, port, token, lines, lat_ms, finalize):
    """One tenant's connection: ``hello``, each pre-encoded push line (its
    round trip in ms appended to ``lat_ms``) and, if asked, ``finalize``,
    whose reply it returns."""
    import asyncio

    r, w = await asyncio.open_connection(host, port)

    async def call(line: bytes) -> dict:
        w.write(line)
        await w.drain()
        while True:
            reply = json.loads(await r.readline())
            if reply.get("type") != "estimate":
                return reply

    hello = await call(_ndjson({"type": "hello", "token": token}))
    check(hello["type"] == "hello_ok", f"hello {token}: {hello}")
    for line in lines:
        t0 = time.perf_counter()
        reply = await call(line)
        lat_ms.append((time.perf_counter() - t0) * 1e3)
        check(reply["type"] == "ack" and not reply.get("duplicate"),
              f"push of {token}: {reply}")
    out = await call(_ndjson({"type": "finalize"})) if finalize else None
    w.close()
    return out


async def http_json(host, port, path: str) -> dict:
    import asyncio

    r, w = await asyncio.open_connection(host, port)
    w.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    data = await r.read()
    w.close()
    return json.loads(data.split(b"\r\n\r\n", 1)[1])


def check_served(finals, refs, label: str) -> None:
    """Every served tenant's finalized estimates, counts and |E| equal the
    dedicated fleet's bit for bit (float32 estimates travel as JSON
    floats, which round-trip exactly)."""
    for sid, (msg, ref) in enumerate(zip(finals, refs)):
        check(msg["type"] == "finalized", f"{label} tenant {sid}: {msg}")
        check(np.array_equal(np.asarray(msg["estimates"], np.float32),
                             ref.estimates)
              and np.array_equal(msg["counts"], ref.window_counts)
              and np.array_equal(msg["cum_sgrs"], ref.cum_edges),
              f"{label}: tenant {sid} differs from the dedicated fleet")


def serve_in_process(device, tenants, lines, *, nt_w, alpha0, policy,
                     state_dir=None, wal=True, fsync=True, part=None,
                     checkpoint=True, finalize=True):
    """Drive an in-process ``StreamServer`` on ``device`` (pallas, latency
    budget ``SERVE_BUDGET_MS``): every tenant pushes its lines (``part`` =
    a slice of them) concurrently.  Returns the finalize replies, the
    wall seconds of the pushes, client round trips (ms), ``/metrics``,
    the seconds from construction to ready, and the server."""
    import asyncio

    from repro_torch.streams.config import EngineConfig, ServingConfig
    from repro_torch.streams.server import StreamServer

    cfg = EngineConfig(tier="pallas", dup_policy=policy, device=device)
    part = part or slice(None)

    async def scenario():
        t0 = time.perf_counter()
        server = await StreamServer(
            nt_w=nt_w, alpha0=alpha0,
            tenants={f"t{s}": s for s in range(len(tenants))}, config=cfg,
            flush_ms=SERVE_FLUSH_MS, latency_budget_ms=SERVE_BUDGET_MS,
            checkpoint_dir=None if state_dir is None else str(state_dir),
            serving=ServingConfig(wal=wal, wal_fsync=fsync)).start()
        ready = time.perf_counter() - t0
        lat: list[float] = []
        t0 = time.perf_counter()
        finals = await asyncio.gather(*[
            ndjson_tenant(server.host, server.port, f"t{s}", ls[part], lat,
                          False) for s, ls in enumerate(lines)])
        push_s = time.perf_counter() - t0
        metrics = await http_json(server.host, server.http_port, "/metrics")
        if finalize:
            finals = await asyncio.gather(*[
                ndjson_tenant(server.host, server.port, f"t{s}", [], lat,
                              True) for s in range(len(lines))])
        await server.stop(checkpoint=checkpoint)
        return finals, push_s, lat, metrics, ready, server

    return asyncio.run(scenario())


def phase_serving(device, tenants, refs, *, nt_w, alpha0,
                  batch: int = SERVE_BATCH) -> dict:
    """Phase 14: phase 12's tenants served over TCP by the port's
    ``StreamServer`` on pallas, in four legs: (a) a server subprocess on
    ``device`` (WAL, checkpoints every ``SERVE_CKPT_S`` s, latency budget)
    SIGKILLed at ``pre_ack`` midway and restarted on its state directory
    while ``DurableClient``s retry; (b) an in-process server with K1's
    launches counted, its edges/s with the WAL on and off, ``/metrics``'s
    push latency and dispatch coalescing, and the device's idle share on a
    quarter of the records; (c) multiset tenants (K2) across a stop and a
    restart from checkpoint plus WAL; (d) that restart's time to ready and
    its replayed WAL records.  Every push carries ``batch`` records, and
    every served tenant equals phase 12's fleet bit for bit.  Returns K1's
    and K2's launches and routes."""
    import asyncio
    import shutil
    import tempfile

    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.streams.faults import (
        DurableClient,
        FaultPlan,
        ServerProcess,
    )

    n_sgrs = len(tenants[0])
    n_batches = -(-n_sgrs // batch)
    total = sum(len(t) for t in tenants)
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="serving_", dir=ROOT / "build"))
    out = {}
    try:
        # (a) a server subprocess on the card, SIGKILLed at pre_ack midway
        t_leg = time.perf_counter()
        port, http_port = _free_port(), _free_port()
        kill_at = n_batches // 2
        kw = dict(nt_w=nt_w, alpha0=alpha0,
                  tenants={f"t{s}": s for s in range(len(tenants))},
                  checkpoint_dir=str(work / "a"), tier="pallas",
                  device=device.type, checkpoint_every_s=SERVE_CKPT_S,
                  flush_ms=SERVE_FLUSH_MS,
                  extra_args=["--port", str(port), "--http-port",
                              str(http_port), "--latency-budget-ms",
                              str(SERVE_BUDGET_MS)],
                  log_path=str(work / "a.log"))

        async def crash_leg():
            clients = [DurableClient("127.0.0.1", port, f"t{s}")
                       for s in range(len(tenants))]
            acked = [0] * len(tenants)

            async def push_all(sid):
                t = tenants[sid]
                for a in range(0, n_sgrs, batch):
                    await clients[sid].push(_records(t, a, a + batch))
                    acked[sid] += 1

            with ServerProcess(plan=FaultPlan(
                    {"pre_ack": {"action": "kill", "at": kill_at}}),
                    **kw) as first:
                t0 = time.perf_counter()
                first.wait_ready(timeout_s=300)
                first_ready = time.perf_counter() - t0
                check(first.device.startswith(device.type),
                      f"the server subprocess reports {first.device}")
                for c in clients:
                    await c.connect()
                pushers = [asyncio.create_task(push_all(s))
                           for s in range(len(tenants))]
                code = await asyncio.to_thread(first.wait_dead, 300)
                check(code == -9, f"the server exited {code}, not SIGKILL")
                at_kill = sum(acked)
                steps = sorted(p.name for p in (work / "a").glob("step_*"))
                t0 = time.perf_counter()
                with ServerProcess(plan=None, **kw) as second:
                    second.wait_ready(timeout_s=300)
                    restart = time.perf_counter() - t0
                    m = await http_json("127.0.0.1", http_port, "/metrics")
                    await asyncio.wait_for(asyncio.gather(*pushers), 600)
                    finals = [await c.call({"type": "finalize"})
                              for c in clients]
                    for c in clients:
                        c.close()
            return (first_ready, at_kill, steps, restart, m, finals,
                    first.device)

        (first_ready, at_kill, steps, restart, m, finals,
         served_on) = asyncio.run(crash_leg())
        check_served(finals, refs["distinct"], "(a) after SIGKILL")
        log_text = (work / "a.log").read_text()
        check(f"SIGKILL at pre_ack (traversal {kill_at})" in log_text,
              f"the planned kill is not in the server's log: {log_text}")
        log(f"[serve] (a) subprocess `python -m repro_torch.launch."
            f"serve_streams --device {device.type} --tier pallas` on "
            f"{served_on}: ready in {first_ready:.4f} s; SIGKILL at pre_ack "
            f"cycle {kill_at} after {at_kill} of {len(tenants) * n_batches} "
            f"pushes acked; checkpoints on disk at the kill {steps or 'none'}"
            f"; restart to ready {restart:.4f} s (interpreter, torch, card "
            f"and recovery), {m['wal']['replayed']} WAL records replayed, "
            f"watermarks {m['watermarks']}; every tenant's estimates after "
            f"recovery bit-identical to phase 12's fleet")
        log(f"[time] phase 14 (a) subprocess crash: "
            f"{time.perf_counter() - t_leg:.4f} s")

        # (b) in-process, distinct (K1): WAL on, WAL off, a profiled quarter
        t_leg = time.perf_counter()
        lines = push_lines(tenants, batch)
        log(f"[serve] {len(tenants)} x {n_batches} push lines of "
            f"{batch} records encoded in "
            f"{time.perf_counter() - t_leg:.4f} s")
        rates = {}
        for wal in (True, False):
            kk.reset_launch_count()
            finals, push_s, lat, m, _, server = serve_in_process(
                device, tenants, lines, nt_w=nt_w, alpha0=alpha0,
                policy="distinct", state_dir=work / f"b_{wal}" if wal
                else None, wal=wal, checkpoint=False)
            sync(device)
            launches = kk.launch_count("K1")
            routes = k1_routes(kk)
            check(launches > 0 or device.type != "cuda",
                  "the server never launched K1")
            check(kk.launch_count("K2") == 0, "the server launched K2")
            check(routes["wgmma"] == launches, f"K1 routes {routes}")
            check_served(finals, refs["distinct"], f"(b) wal={wal}")
            agg = m["aggregate"]
            rates[wal] = total / push_s
            lat_np = np.asarray(lat)
            log(f"[serve] (b) in-process, distinct, WAL "
                f"{'on (fsync per cycle)' if wal else 'off'}: {total} "
                f"edges in {push_s:.4f} s = {total / push_s:.4f} edges/s; "
                f"/metrics push ms p50 {agg['push_latency_ms']['p50']:.4f} "
                f"p99 {agg['push_latency_ms']['p99']:.4f} over "
                f"{agg['pushes']} cycles ({agg['coalesced_items']} pushes); "
                f"client round trip ms p50 "
                f"{np.percentile(lat_np, 50):.4f} p99 "
                f"{np.percentile(lat_np, 99):.4f}; dispatch_count "
                f"{agg['dispatch_count']}, coalesced_windows_per_dispatch "
                f"{agg['coalesced_windows_per_dispatch']:.4f}, reap wait ms "
                f"p50 {agg['reap_wait_ms']['p50']:.4f}; WAL "
                f"{m['wal'].get('bytes', 0)} bytes; K1 launches "
                f"{launches}, routes {routes}; every tenant bit-identical")
            if wal:
                out["K1"] = (launches, routes)
        log(f"[serve] (b) edges/s WAL on / off: {rates[True]:.4f} / "
            f"{rates[False]:.4f} ({rates[True] / rates[False]:.4f})")
        # where the WAL's cost lies, on the first quarter of the pushes:
        # with its fsync per cycle, without it, and without the WAL
        quarter = slice(0, n_batches // 4)
        n_q = sum(min(len(t), (n_batches // 4) * batch) for t in tenants)
        parts = []
        for label, wal, fsync in (("WAL with fsync", True, True),
                                  ("WAL without fsync", True, False),
                                  ("no WAL", False, True)):
            _, push_s, _, m, _, _ = serve_in_process(
                device, tenants, lines, nt_w=nt_w, alpha0=alpha0,
                policy="distinct", state_dir=work / f"q_{wal}_{fsync}"
                if wal else None, wal=wal, fsync=fsync, part=quarter,
                checkpoint=False, finalize=False)
            p = m["aggregate"]["push_latency_ms"]
            parts.append(f"{label} {n_q / push_s:.4f} edges/s (push ms "
                         f"p50 {p['p50']:.4f}, p99 {p['p99']:.4f})")
        log(f"[serve] (b) the WAL's cost on the first {n_batches // 4} "
            f"pushes of each tenant ({n_q} edges): " + "; ".join(parts))
        profile(f"server, pallas tier, distinct, {len(tenants)} tenants x "
                f"first {n_batches // 4} pushes of {batch}, WAL on",
                lambda: serve_in_process(
                    device, tenants, lines, nt_w=nt_w, alpha0=alpha0,
                    policy="distinct", state_dir=work / "b_profile",
                    part=quarter, checkpoint=False, finalize=False),
                device)
        log(f"[time] phase 14 (b) in-process distinct: "
            f"{time.perf_counter() - t_leg:.4f} s")

        # (c) multiset (K2) across a stop and a restart from checkpoint +
        # WAL; (d) that restart's time to ready
        t_leg = time.perf_counter()
        kk.reset_launch_count()
        third = n_batches // 3
        state = work / "c"
        serve_in_process(device, tenants, lines, nt_w=nt_w, alpha0=alpha0,
                         policy="multiset", state_dir=state,
                         part=slice(0, third), finalize=False)
        # the second third rides the WAL only: no checkpoint at this stop
        serve_in_process(device, tenants, lines, nt_w=nt_w, alpha0=alpha0,
                         policy="multiset", state_dir=state,
                         part=slice(third, 2 * third), checkpoint=False,
                         finalize=False)
        finals, _, _, m, ready, server = serve_in_process(
            device, tenants, lines, nt_w=nt_w, alpha0=alpha0,
            policy="multiset", state_dir=state,
            part=slice(2 * third, None), checkpoint=False)
        sync(device)
        launches, routes = kk.launch_count("K2"), k2_routes(kk)
        check(launches > 0 or device.type != "cuda",
              "the multiset server never launched K2")
        check(kk.launch_count("K1") == 0, "the multiset server launched K1")
        check(routes["wgmma_limbs"] == launches, f"K2 routes {routes}")
        check(server._recovered, "the restarted server did not recover")
        replayed = m["wal"]["replayed"]
        check(replayed == len(tenants) * third,
              f"{replayed} WAL records replayed, expected "
              f"{len(tenants) * third}")
        check_served(finals, refs["multiset"], "(c) multiset")
        out["K2"] = (launches, routes)
        log(f"[serve] (c) in-process, multiset, stopped after a third "
            f"(checkpoint) and after two thirds (WAL only), restarted from "
            f"checkpoint + WAL: K2 launches {launches}, routes {routes}; "
            f"every tenant bit-identical to phase 12's multiset fleet")
        log(f"[serve] (d) restart to ready {ready:.4f} s in-process "
            f"(fleet construction, checkpoint restore and the replay of "
            f"{replayed} WAL records, {replayed * batch} edges), "
            f"watermarks {m['watermarks']}")
        log(f"[time] phase 14 (c, d) multiset restart: "
            f"{time.perf_counter() - t_leg:.4f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def phase_profile(stream, wb, nt_w, alpha0, device, ex) -> None:
    """Phase 8: where the time goes in the replay (both tiers) and in the
    distinct and multiset streams, after the checks above have passed."""
    from repro_torch.core import run_sgrapp
    from repro_torch.streams import EngineConfig

    profile("replay, pallas tier",
            lambda: run_sgrapp(wb, alpha0, executor=ex), device)
    host_profile("replay, pallas tier",
                 lambda: run_sgrapp(wb, alpha0, executor=ex), device)
    profile("replay, dense tier", lambda: run_sgrapp(
        wb, alpha0, tier="dense", device=device), device)
    cols = (stream.tau, stream.edge_i, stream.edge_j)
    for policy in ("distinct", "multiset"):
        cfg = EngineConfig(tier="pallas", dup_policy=policy, flush_every=32,
                           device=device)
        profile(f"stream, pallas tier, {policy}, mb=256",
                lambda: push_engine(cfg, nt_w, alpha0, *cols), device)
        if policy == "distinct":
            host_profile(f"stream, pallas tier, {policy}, mb=256",
                         lambda: push_engine(cfg, nt_w, alpha0, *cols),
                         device)


def host_profile(label: str, fn, device, top: int = 4) -> None:
    """Where the host time of ``fn`` goes: ``cProfile`` over one call (it
    sees the numpy and Python work that ``torch.profiler``'s operator list
    does not) and the ``top`` functions with the most own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    sync(device)
    prof.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof).stats
    rows = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)
    log(f"[profile] {label}: host functions with the most own time, wall "
        f"{wall_ms:.4f} ms under cProfile")
    for (path, line, name), (_, calls, own, _, _) in rows[:top]:
        where = f"{Path(path).name}:{line}({name})" if line else name
        log(f"[profile]   host {own * 1e3:12.4f} ms {calls:6d} x  {where[:80]}")


def profile(label: str, fn, device, top: int = 8, spans: tuple = ()
            ) -> tuple[float, float, dict[str, float]]:
    """Where the device time of ``fn`` goes: ``torch.profiler`` over one
    call, the device's busy share of the host wall time (one stream, so
    kernels never overlap) and the ``top`` kernels that took the most of
    it.  Returns (wall ms, device busy ms, device ms by kernel name); the
    last also holds, under ``span:<name>``, the device time of the kernels
    launched inside each ``record_function`` span named in ``spans``,
    summed over its calls."""
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
                    reverse=True)[:top]:
        log(f"[profile]   {e.self_device_time_total / 1e3:12.4f} ms "
            f"{e.count:6d} x  {e.key[:90]}")
    # the host side of the device work: kernel launches, copies (a copy
    # from pageable host memory waits for the stream) and synchronizations
    api = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("cuda")),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:3]
    for e in api:
        log(f"[profile]   host {e.self_cpu_time_total / 1e3:12.4f} ms "
            f"{e.count:6d} x  {e.key[:80]}")
    by_kernel: dict[str, float] = {}
    for e in dev:
        by_kernel[e.key] = by_kernel.get(e.key, 0.0) + e.self_device_time_total / 1e3
    for name in spans:
        # the host-side span: its device time is that of the kernels its
        # ops launched (the span on the device's own timeline is left out)
        calls = [e for e in prof.events()
                 if e.name == name and e.device_type == DeviceType.CPU]
        ms = sum(e.device_time_total for e in calls) / 1e3
        by_kernel[f"span:{name}"] = ms
        log(f"[profile]   span {name}: {len(calls)} calls, {ms:.4f} ms of "
            f"device time ({ms / max(busy_ms, 1e-9):.4%} of the busy time)")
    return wall_ms, busy_ms, by_kernel


def build_lines(info, describe) -> list[str]:
    """One line for each kernel that ``nvcc -Xptxas -v`` compiled into the
    library ``info`` and that ``describe`` names: ``describe(info, entry
    name)`` gives (what it is, its dynamic shared memory in bytes or None),
    or None to skip it; the line adds its registers and spills.  Any warning of
    ptxas that it serialized wgmma instructions gets a line of its own."""
    import re

    out, what, spills = [], None, ""
    for line in info.log.splitlines():
        if "wgmma" in line and "serialized" in line:
            out.append(f"[setup] ptxas: {line.strip()}")
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            what = describe(info, m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m is None or what is None:
            continue
        out.append(f"[setup] {what[0]}: {m.group(1)} registers at entry, "
                   f"{spills}" + ("" if what[1] is None else
                                  f"; {what[1]} B of dynamic shared memory"))
        what = None
    return out


def butterfly_kernel_name(info, name: str):
    """``build_lines``' description of a butterfly kernel: K1's and K2's
    wgmma kernels with the shared memory their launchers ask for
    (``*_smem_bytes``) and their rounding passes."""
    if "butterfly_windows_wgmma_kernel" in name:
        return ("K1/K3 wgmma (u8 operands, s32 accumulators, TMA, "
                "persistent; setmaxnreg: producer 40, consumers 232)",
                info.lib.butterfly_windows_wgmma_smem_bytes())
    if "round_sums_kernel" in name:
        return "K1/K3 rounding pass (exact sums -> float32)", None
    if "butterfly_windows_multiset_wgmma_kernel" in name:
        return ("K2 wgmma (u8 limb operands, s32 accumulators folded into "
                "64-bit totals, TMA, persistent; setmaxnreg: producer 40, "
                "consumers 232)",
                info.lib.butterfly_windows_multiset_wgmma_smem_bytes())
    if "round_half_sums_kernel" in name:
        return "K2 rounding pass (exact split sums -> float32, halved)", None
    return None


def k4_kernel_name(info, name: str):
    """``build_lines``' description of a K4 kernel: variant, head dims and
    the shared memory its launcher asks for
    (``flash_attention_smem_bytes``)."""
    import re

    fn = info.lib.flash_attention_smem_bytes
    w = re.search(r"flash_attention_wgmma_kernelILi(\d+)ELi(\d+)E", name)
    f = re.search(r"flash_attention_kernelILi(\d+)E", name)
    if w:
        qk, v = (int(g) for g in w.groups())
        return (f"K4 bf16 wgmma (TMA, 3-limb P), hd {64 * qk - 63}-{64 * qk}, "
                f"hd_v {64 * v - 63}-{64 * v} (setmaxnreg: producer 40, "
                "consumers 232)", fn(1, 64 * qk, 64 * v))
    if f:
        hdp = int(f.group(1))
        return (f"K4 float32 SIMT, max(hd, hd_v) "
                f"{hdp // 2 + 1 if hdp > 32 else 1}-{hdp}", fn(0, hdp, hdp))
    return None


def within(got, want, tol: dict) -> tuple[bool, float]:
    """Whether ``|got - want| <= atol + rtol * |want|`` everywhere (in
    float32), and the largest absolute difference."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def k4_bound_ms(q, k, v, *, causal: bool) -> tuple[float, str, float, str]:
    """The least time an H100 could take for K4's work on these bf16
    inputs: (bound ms, "bytes" or "operations", the operations' GFLOP, the
    rates).  The work counts the (query, key) pairs the causal mask keeps,
    QK^T at the query head dim and PV at the value head dim (MLA's differ).
    QK^T on bf16 inputs is exact on bf16 tensor cores with fp32
    accumulation; PV takes the reference's fp32 P, which three bf16 limbs
    hold exactly, so three bf16 products.  Bytes: q, k, v read once and the
    output ``[B, Sq, H, hd_v]`` written once."""
    import torch

    check(q.dtype == torch.bfloat16, "K4's bound is reckoned for bf16 inputs")
    b, sq, h, hd = q.shape
    skv, hd_v = k.shape[1], v.shape[3]
    keys = np.minimum(skv, np.arange(sq) + 1) if causal else np.full(sq, skv)
    pairs = float(keys.sum()) * b * h
    qk, pv = 2.0 * pairs * hd, 2.0 * pairs * hd_v
    ops_ms = (qk + 3 * pv) / PEAK_BF16_OPS * 1e3
    moved = (q.numel() + k.numel() + v.numel() + b * sq * h * hd_v) * q.element_size()
    bytes_ms = moved / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", (qk + pv) / 1e9,
            "QK^T on bf16 tensor cores, PV on bf16 tensor cores over 3 bf16 "
            "limbs of P")


def hold_k4(got, q, k, v, *, causal: bool, q_offset: int, chunk: int,
            what: str, scale: float | None = None) -> tuple[float, float]:
    """Hold K4's output ``got`` to the plain version on the same inputs at
    the same ``scale`` (None: the reference kernel's): within ``K4_TOL`` of
    its output in ``q.dtype`` and, for bf16, within ``K4_ROUNDED`` of its
    float32 output.  Returns both max abs errors."""
    from repro_torch.kernels.flash_attention.flash_kernel import (
        flash_attention_plain,
    )

    want32 = flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal, q_offset=q_offset,
                                   block_q=chunk, block_k=chunk, scale=scale)
    tol = K4_TOL[str(q.dtype).split(".")[-1]]
    ok, err = within(got, want32.to(q.dtype), tol)
    check(ok, f"K4 != plain on {what} beyond rtol {tol['rtol']}, atol "
          f"{tol['atol']} (max abs err {err})")
    ok, err32 = within(got, want32, K4_ROUNDED)
    check(ok or q.dtype == want32.dtype,
          f"K4 in bf16 on {what} is not the rounding of the plain version's "
          f"float32 output (rtol {K4_ROUNDED['rtol']:.6g}, atol "
          f"{K4_ROUNDED['atol']}; max abs err {err32}): is P kept in fp32?")
    return err, err32


def phase_k4(device, seed: int, *, batch: int, seq: int, heads: int,
             kv_heads: int, head_dim: int, chunk: int) -> dict:
    """Phase 9: K4 at the serve path's shapes (q [batch, seq, heads,
    head_dim], k and v with ``kv_heads``, bf16, causal) against its plain
    version at the model's attention chunk; again in float32 and at a
    ragged later prompt chunk (``q_offset > 0``); then K4's, the plain
    version's and ``scaled_dot_product_attention``'s times and the
    bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_kernel as k4

    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(sq, skv, dtype):
        return [torch.randn(shape, generator=gen, device=device).to(dtype)
                for shape in ((batch, sq, heads, head_dim),
                              (batch, skv, kv_heads, head_dim),
                              (batch, skv, kv_heads, head_dim))]

    def hold(q, k, v, q_offset, what):
        k4.reset_launch_count()
        got = k4.flash_attention_bshd(q, k, v, causal=True, q_offset=q_offset)
        sync(device)
        variant = "simt" if q.dtype == torch.float32 else "wgmma"
        check(device.type != "cuda" or k4.launch_count(variant) == 1,
              f"K4 on {what} did not run its {variant} variant")
        err, err32 = hold_k4(got, q, k, v, causal=True, q_offset=q_offset,
                             chunk=chunk, what=what)
        tol = K4_TOL[str(q.dtype).split(".")[-1]]
        log(f"[k4] {what}: K4 vs plain max abs err {err:.6g} (rtol "
            f"{tol['rtol']}, atol {tol['atol']})"
            + ("" if q.dtype == torch.float32 else
               f"; vs the plain version's float32 output {err32:.6g} (rtol "
               f"{K4_ROUNDED['rtol']:.6g}, atol {K4_ROUNDED['atol']})"))
        return err

    q, k, v = draw(seq, seq, torch.float32)
    hold(q, k, v, 0, f"float32 q {list(q.shape)}, k/v {list(k.shape)}, causal")
    fq, fk, fv = q, k, v
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    err = hold(q, k, v, 0, f"bf16 q {list(q.shape)}, k/v {list(k.shape)}, "
               "causal")
    sq, skv = seq // 4 - 24, seq - 96
    rq, rk, rv = draw(sq, skv, torch.bfloat16)
    hold(rq, rk, rv, skv - sq, f"bf16 ragged later chunk: q {list(rq.shape)} "
         f"at q_offset {skv - sq}, k/v {list(rk.shape)}")
    del rq, rk, rv

    ms = time_ms(lambda: k4.flash_attention_bshd(q, k, v, causal=True), device)
    f32_ms = time_ms(lambda: k4.flash_attention_bshd(fq, fk, fv, causal=True),
                     device, reps=3)
    plain_ms = time_ms(lambda: k4.flash_attention_plain(
        q, k, v, causal=True, block_q=chunk, block_k=chunk), device, reps=3)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)

    library_ms = time_ms(library, device)
    # the control: SDPA keeps P in bf16, so K4_ROUNDED must reject it
    lib = library()
    want32 = k4.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal=True, block_q=chunk,
                                      block_k=chunk)
    lib_ok, lib_err = within(lib, want32.to(q.dtype), K4_TOL["bfloat16"])
    lib_rounded, lib_err32 = within(lib, want32, K4_ROUNDED)
    lim = K4_ROUNDED["atol"] + K4_ROUNDED["rtol"] * want32.abs()
    lib_out = float(((lib.float() - want32).abs() > lim).float().mean())
    del lib, want32, lim
    check(lib_err < 0.05, f"scaled_dot_product_attention is {lib_err} off "
          "the plain version: not the same function")
    check(not lib_rounded, "scaled_dot_product_attention (bf16 P) passes "
          "K4_ROUNDED: the check no longer tells a bf16 P from K4's fp32 P")
    log(f"[k4] control, scaled_dot_product_attention (bf16 P) on the same bf16 "
        f"inputs: vs plain in bf16 max abs err {lib_err:.6g}, "
        f"{'within' if lib_ok else 'beyond'} K4_TOL['bfloat16']; vs the plain "
        f"version's float32 output {lib_err32:.6g}, beyond K4_ROUNDED at "
        f"{lib_out:.4%} of the elements (K4 at none)")
    bound_ms, bound_by, gflop, rate = k4_bound_ms(q, k, v, causal=True)
    simt_ms = gflop * 1e9 / PEAK_FP32_SIMT * 1e3
    log(f"[k4] timing, bf16, causal: K4 (wgmma variant) {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (blocks {chunk}), "
        f"scaled_dot_product_attention(enable_gqa=True) {library_ms:.4f} ms "
        f"(max abs err {lib_err:.4g} vs plain: it keeps P in bf16); bound "
        f"{bound_ms:.4f} ms ({bound_by}: {gflop:.6g} GFLOP, {rate})")
    log(f"[k4] K4 bf16 at {bound_ms / ms:.4%} of its bound; "
        f"{ms / library_ms:.4f}x the time of scaled_dot_product_attention; "
        f"float32 inputs (SIMT variant) {f32_ms:.4f} ms, {simt_ms / f32_ms:.2%} "
        f"of the fp32 SIMT peak ({simt_ms:.4f} ms)")
    del fq, fk, fv
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "float32_simt_ms": f32_ms}


def sdpa_backends(q, k, v) -> tuple[dict, object]:
    """Which of ``scaled_dot_product_attention``'s fused backends take these
    causal inputs: ``({backend: None or the first line of its refusal},
    a function that runs the first that takes them, or None)``."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    refused, run = {}, None
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(
                    *args, is_causal=True).transpose(1, 2)
        try:
            call()
            refused[backend.name] = None
            run = run or call
        except RuntimeError as e:
            refused[backend.name] = str(e).strip().splitlines()[0][:160]
    return refused, run


def phase_k4_mla(device, seed: int, *, batch: int, seq: int, heads: int,
                 qk_dim: int, v_dim: int, chunk: int) -> dict:
    """Phase 9 at MLA's prefill shape (minicpm3-4b: q and k [batch, seq,
    heads, qk_dim], v [batch, seq, heads, v_dim], causal): K4 against its
    plain version at the model's scale (the reference's float32
    ``1/sqrt(qk_dim)``) in bf16 (``K4_TOL`` and ``K4_ROUNDED``, on route
    ``wgmma``) and float32 (``simt``); K4's, the plain version's and the
    bound's times, and ``scaled_dot_product_attention``'s where one of its
    fused backends takes a value head dim other than the query's."""
    import torch

    from repro_torch.kernels.flash_attention import flash_kernel as k4
    from repro_torch.models.transformer.attention import attention_scale

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               for shape in ((batch, seq, heads, qk_dim),
                             (batch, seq, heads, qk_dim),
                             (batch, seq, heads, v_dim)))
    scale = attention_scale(qk_dim)
    errs = {}
    for dtype, route in ((torch.float32, "simt"), (torch.bfloat16, "wgmma")):
        q, k, v = (t.to(dtype) for t in (q, k, v))
        k4.reset_launch_count()
        got = k4.flash_attention_bshd(q, k, v, causal=True, scale=scale)
        sync(device)
        check(device.type != "cuda" or k4.launch_count(route) == 1,
              f"K4 at the MLA shape in {dtype} did not take route {route}")
        what = (f"MLA shape, {str(dtype).split('.')[-1]} q/k "
                f"{list(q.shape)}, v {list(v.shape)}, causal")
        err, err32 = hold_k4(got, q, k, v, causal=True, q_offset=0,
                             chunk=chunk, what=what, scale=scale)
        errs[dtype] = err
        log(f"[k4] {what}: K4 (route {route}) vs plain max abs err {err:.6g}"
            + ("" if dtype == torch.float32 else
               f"; vs the plain version's float32 output {err32:.6g} (rtol "
               f"{K4_ROUNDED['rtol']:.6g}, atol {K4_ROUNDED['atol']})"))
        del got
    ms = time_ms(lambda: k4.flash_attention_bshd(q, k, v, causal=True,
                                                 scale=scale), device)
    plain_ms = time_ms(lambda: k4.flash_attention_plain(
        q, k, v, causal=True, block_q=chunk, block_k=chunk, scale=scale),
        device, reps=3)
    bound_ms, bound_by, gflop, rate = k4_bound_ms(q, k, v, causal=True)
    refused, library = sdpa_backends(q, k, v)
    library_ms = None
    for name, why in refused.items():
        log(f"[k4] scaled_dot_product_attention backend {name} at the MLA "
            f"shape (hd {qk_dim}, hd_v {v_dim}): "
            + ("takes it" if why is None else f"refuses it: {why}"))
    if library is not None:
        library_ms = time_ms(library, device)
        lib = library()
        want32 = k4.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal=True, block_q=chunk,
                                          block_k=chunk, scale=scale)
        _, lib_err = within(lib, want32.to(q.dtype), K4_TOL["bfloat16"])
        lib_rounded, lib_err32 = within(lib, want32, K4_ROUNDED)
        del lib, want32
        check(lib_err < 0.05, f"scaled_dot_product_attention is {lib_err} off "
              "the plain version at the MLA shape: not the same function")
        log(f"[k4] control at the MLA shape: scaled_dot_product_attention vs "
            f"plain in bf16 max abs err {lib_err:.6g}; vs the plain version's "
            f"float32 output {lib_err32:.6g}, "
            f"{'within' if lib_rounded else 'beyond'} K4_ROUNDED")
    log(f"[k4] timing at the MLA shape, bf16, causal: K4 (wgmma variant, "
        f"NQK {-(-qk_dim // 64)}, NV {-(-v_dim // 64)}) {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (blocks {chunk}), "
        f"scaled_dot_product_attention "
        + ("refused by every fused backend" if library_ms is None else
           f"{library_ms:.4f} ms")
        + f"; bound {bound_ms:.4f} ms ({bound_by}: {gflop:.6g} GFLOP useful "
        f"at hd {qk_dim} and hd_v {v_dim}, {rate}); K4 at "
        f"{bound_ms / ms:.4%} of its bound")
    return {"shape": {"q": list(q.shape), "k": list(k.shape),
                      "v": list(v.shape), "causal": True},
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_backends": {n: w is None for n, w in refused.items()}}


@contextlib.contextmanager
def held_attention(errs: list):
    """While open, the model's prefill attention also runs K4's plain
    version on each layer's own q, k, v at the model's scale and holds K4's
    output to it (``hold_k4``); each layer's max abs errors, against the
    plain version in the layer's dtype and against its float32 output, are
    appended to ``errs``.  A GQA layer calls the attention from the model
    module, MLA's prefill from the attention module: both are held."""
    from repro_torch.models.transformer import attention as attn
    from repro_torch.models.transformer import model as lm

    entry = attn.gqa_attention_chunked

    def holding(q, k, v, **kw):
        check(kw["chunk_q"] == kw["chunk_k"], "one attention chunk")
        got = entry(q, k, v, **kw)
        errs.append(hold_k4(got, q, k, v, causal=kw["causal"],
                            q_offset=kw.get("q_offset", 0),
                            chunk=kw["chunk_q"],
                            what=f"layer {len(errs)}'s q, k, v",
                            scale=attn.attention_scale(q.shape[-1])))
        return got

    lm.gqa_attention_chunked = attn.gqa_attention_chunked = holding
    try:
        yield errs
    finally:
        lm.gqa_attention_chunked = attn.gqa_attention_chunked = entry


@contextlib.contextmanager
def recorded_routes(log_: list):
    """While open, each MoE layer's call (``model.moe_apply``) appends a
    list to ``log_``, and each dispatch it makes (one per slab) appends its
    ``MoERoute`` to that list; the routes stay on the device (no host
    synchronization)."""
    from repro_torch.models.transformer import model as lm
    from repro_torch.models.transformer import moe as moe_mod

    route, apply = moe_mod.moe_route, lm.moe_apply

    def recording(*args, **kw):
        r = route(*args, **kw)
        log_[-1].append(r)
        return r

    def layer(*args, **kw):
        log_.append([])
        return apply(*args, **kw)

    moe_mod.moe_route, lm.moe_apply = recording, layer
    try:
        yield log_
    finally:
        moe_mod.moe_route, lm.moe_apply = route, apply


def dropped_shares(routes: list, n_layers: int) -> list[float]:
    """Per layer, the share of ``(token, choice)`` pairs dropped at capacity
    over the layer calls in ``routes`` (``recorded_routes``' log), layer
    ``i % n_layers`` for the ``i``-th call."""
    kept, total = np.zeros(n_layers), np.zeros(n_layers)
    for i, call in enumerate(routes):
        for r in call:
            kept[i % n_layers] += int(r.keep.sum())
            total[i % n_layers] += r.keep.numel()
    return list(1.0 - kept / np.maximum(total, 1))


def phase_serve(device, seed: int, *, arch: str, batch: int, prompt: int,
                gen: int, smoke: bool = False, n_layers: int | None = None
                ) -> dict:
    """Phases 10 and 16-18: LM serving through ``repro_torch.launch.serve``
    at full width: seeded random weights (the first ``n_layers`` layers
    where the whole model does not fit one card, a cut logged as
    ``reduced``), ``batch`` prompts of ``prompt`` tokens, greedy decoding
    to ``gen`` tokens.  K4 is held against its plain version on every
    layer's q, k, v in one prefill; then a counted, timed serving run (an
    MoE's dropped share of choices per layer, in prefill and in decode);
    the profile of a prefill and of decode steps; the smoke config on the
    card against the CPU path (logits, greedy tokens and an MoE's routing);
    and the sGrapp monitor's count of the (request, token) graph against
    the numpy oracle."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core import count_butterflies_np
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.kernels.flash_attention import flash_kernel as k4
    from repro_torch.launch.serve import (
        make_prompts,
        monitor_butterflies,
        serve,
    )
    from repro_torch.models.transformer import (
        decode_step,
        init_lm_params,
        prefill,
    )

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_arch(arch).smoke_config() if smoke else get_arch(arch).full_config()
    if n_layers is not None and n_layers < cfg.n_layers:
        log(f"[serve] reduced: {arch} keeps {n_layers} of its {cfg.n_layers} "
            f"layers (dataclasses.replace(cfg, n_layers={n_layers})); every "
            "width as published")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = init_lm_params(cfg, seed=seed, device=device)
    sync(device)
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if cfg.is_mla:
        m = cfg.mla
        attn_desc = (f"MLA (q_lora {m.q_lora_rank}, kv_lora {m.kv_lora_rank}, "
                     f"q/k head dim {m.qk_nope_head_dim} + "
                     f"{m.qk_rope_head_dim}, v head dim {m.v_head_dim})")
    else:
        attn_desc = f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}"
    ffn_desc = (f"d_ff {cfg.d_ff}" if cfg.moe is None else
                f"MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff "
                f"{cfg.moe.d_ff_expert}")
    log(f"[serve] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads, {attn_desc}, {ffn_desc}, vocab "
        f"{cfg.vocab_size} (padded {cfg.padded_vocab}); {n_params:.6g} "
        f"parameters ({n_bytes / 1e9:.4f} GB) drawn on {device} in "
        f"{time.perf_counter() - t0:.4f} s")
    prompts = make_prompts(cfg, batch, prompt, seed)
    toks = torch.as_tensor(prompts, device=device)

    errs: list = []
    with held_attention(errs):
        last, _ = prefill(model, toks, cfg, prompt + gen)
        sync(device)
    check(len(errs) == cfg.n_layers, f"{len(errs)} attention calls held")
    err = max(e for e, _ in errs)
    log(f"[serve] prefill with K4 held against its plain version on every "
        f"layer's q, k, v: {len(errs)} layers, max abs err {err:.6g} (bf16 "
        f"within one ulp: rtol {K4_TOL['bfloat16']['rtol']}, atol "
        f"{K4_TOL['bfloat16']['atol']}); against its float32 output "
        f"{max(e for _, e in errs):.6g} (rtol {K4_ROUNDED['rtol']:.6g}, atol "
        f"{K4_ROUNDED['atol']})")
    del last

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    kk.reset_launch_count()
    k4.reset_launch_count()
    routes: list = []
    with recorded_routes(routes):
        res = serve(model, cfg, prompts, gen)
    launches = k4.launch_count()
    tma = k4.launch_count("wgmma")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    # K4 launches only for CUDA tensors (a CPU rehearsal runs its plain twin)
    check(launches == cfg.n_layers or not cuda,
          f"K4 launches {launches} != {cfg.n_layers} (one per layer)")
    check(tma == launches,
          f"only {tma} of K4's {launches} serve launches took the TMA route "
          "on the tensors as they lie (the rest a padded copy or SIMT)")
    check(all(kk.launch_count(n) == 0 for n in kk.KERNELS),
          "LM serving launched a butterfly kernel")
    for name, lg in (("prefill", res.prefill_logits),
                     ("last decode step", res.last_logits)):
        check(lg.shape == (batch, cfg.padded_vocab), f"{name} logits shape")
        check(bool(torch.isfinite(lg).all()), f"{name} logits not finite")
    check(res.tokens.shape == (batch, gen)
          and ((0 <= res.tokens) & (res.tokens < cfg.vocab_size)).all(),
          "generated tokens out of the vocabulary")
    tokens = res.tokens
    log(f"[serve] prefill {batch}x{prompt}: {res.prefill_s * 1e3:.4f} ms; "
        f"decode {gen - 1} steps ({batch * (gen - 1)} tokens; the prefill "
        f"gives the first): {res.decode_s * 1e3:.4f} ms = "
        f"{res.decode_tok_s():.4f} tok/s; K4 launches {launches} (one per "
        f"layer, all the bf16 wgmma variant through TMA with no padded copy; "
        f"decode attention is plain torch); logits finite; peak device "
        f"memory {peak / 2**30:.4f} GiB; sample {res.tokens[0][:8].tolist()}")
    if cfg.moe is not None:
        check(len(routes) == cfg.n_layers * gen,
              f"{len(routes)} MoE layer calls, not {cfg.n_layers} x {gen}")
        slabs = len(routes[0])
        for name, calls in (("prefill", routes[:cfg.n_layers]),
                            ("decode", routes[cfg.n_layers:])):
            shares = dropped_shares(calls, cfg.n_layers)
            r = calls[0][0]
            log(f"[serve] MoE {name}: capacity {r.cap} per dispatch of "
                f"{r.keep.shape[0]} tokens x top-{cfg.moe.top_k}"
                + (f" ({slabs} slabs)" if name == "prefill" else "")
                + "; dropped share of (token, choice) pairs per layer "
                + ", ".join(f"{x:.4%}" for x in shares))
    del routes

    _, busy, by_kernel = profile("serve, one prefill", lambda: prefill(
        model, toks, cfg, prompt + gen), device)
    k4_ms = sum(t for name, t in by_kernel.items()
                if "flash_attention" in name)
    log(f"[serve] K4 takes {k4_ms:.4f} ms of the prefill's {busy:.4f} ms of "
        f"device time ({k4_ms / max(busy, 1e-9):.4%})")
    _, cache = prefill(model, toks, cfg, prompt + gen)
    nxt = torch.as_tensor(res.tokens[:, 0], device=device)

    n_steps = min(8, gen - 1)

    def steps():
        c = cache
        for _ in range(n_steps):
            _, c = decode_step(model, c, nxt, cfg)

    profile(f"serve, {n_steps} decode steps", steps, device)
    summary = {"launches": launches, "max_abs_err": err,
               "prefill_ms": res.prefill_s * 1e3,
               "decode_tok_s": res.decode_tok_s()}
    del cache, res, model

    # the whole path on a small input: the smoke config in float32 on the
    # card (K4) against the CPU path (K4's plain version); an MoE's routing
    # (each dispatch's gate indices and kept choices) equal on both
    small = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
    cpu_model = init_lm_params(small, seed=seed, device="cpu")
    small_prompts = make_prompts(small, 2, 150, seed)
    cpu_routes: list = []
    card_routes: list = []
    with recorded_routes(cpu_routes):
        on_cpu = serve(cpu_model, small, small_prompts, 6)
    with recorded_routes(card_routes):
        on_card = serve(cpu_model.to(device), small, small_prompts, 6)
    ok, logit_err = within(on_card.prefill_logits.cpu(), on_cpu.prefill_logits,
                           dict(rtol=1e-4, atol=1e-4))
    check(ok and np.array_equal(on_card.tokens, on_cpu.tokens),
          f"smoke {arch} in float32: the card's prefill logits are {logit_err} "
          f"off the CPU path's, or the greedy tokens differ")
    same = len(card_routes) == len(cpu_routes) and all(
        torch.equal(a.gate_idx.cpu(), b.gate_idx)
        and torch.equal(a.keep.cpu(), b.keep)
        for ca, cb in zip(card_routes, cpu_routes) for a, b in zip(ca, cb))
    check(same, f"smoke {arch} in float32: the MoE routing differs between "
          "the card and the CPU path")
    log(f"[serve] smoke config in float32, 2 prompts x 150 tokens, 6 tokens: "
        f"{device} (K4 on a card) and the CPU path (plain) agree (prefill logits max "
        f"abs err {logit_err:.6g} <= 1e-4, greedy tokens equal"
        + ("" if small.moe is None else
           f", gate indices and kept choices of all {len(cpu_routes)} MoE "
           "dispatches equal")
        + ")")
    del cpu_model, on_cpu, on_card, cpu_routes, card_routes

    # the sGrapp monitor over prompts plus generations.  snapshot_count is
    # the dense tier: it sums C(W, 2) over the whole request x request Gram
    # in float32, the diagonal's C(degree, 2) included, and subtracts the
    # diagonal, as the reference does.  Below 2**24 every step is exact;
    # past it, float32 summation of these n**2 + n nonnegative terms in any
    # order is off by at most (n**2 + n) * 2**-24 times their sum.
    t0 = time.perf_counter()
    bf = monitor_butterflies(prompts, tokens, device)
    msec = time.perf_counter() - t0
    full = np.concatenate([prompts, tokens], axis=1)
    edges = np.unique(np.stack([np.repeat(np.arange(batch), full.shape[1]),
                                full.reshape(-1)], 1), axis=0)
    want = count_butterflies_np(edges)
    deg = np.bincount(edges[:, 0], minlength=batch).astype(np.float64)
    total = float(np.sum(deg * (deg - 1) / 2) + 2 * want)
    slack = 0.0 if total < 2**24 else (batch**2 + batch) * 2.0**-24 * total
    check(abs(bf - want) <= slack,
          f"monitor {bf} vs oracle {want}: off by more than {slack}")
    log(f"[serve] sGrapp monitor: {bf:.0f} butterflies in the (request, "
        f"token) graph of {full.size} emissions ({msec * 1e3:.4f} ms through "
        f"snapshot_count on {device}); numpy oracle {want}: off by "
        f"{abs(bf - want):.0f}, within the float32 envelope {slack:.4f} (the "
        f"dense tier's whole-Gram sum reaches {total:.6g}"
        + (", past 2**24)" if total >= 2**24 else ", below 2**24: exact)"))
    return summary


def sync_all(devices) -> None:
    """Wait for every CUDA device among ``devices`` (a sharded run may
    queue work on several)."""
    import torch

    for d in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(d)


def phase_analysis(stream, wb, device, replay_counts, max_edges=5000):
    """Phase 15 (a): the paper's SS3 analysis on the first ``max_edges``
    sgrs (the reference's cap), and the dense per-vertex support on the
    card against the int64 oracle on the largest smoke window."""
    import torch

    from repro_torch.core import analysis as an
    from repro_torch.core.butterfly import (
        Snapshot,
        butterfly_support_dense,
        butterfly_support_np,
        count_butterflies_np,
    )

    n = min(max_edges, len(stream))
    ei, ej, tau = stream.edge_i[:n], stream.edge_j[:n], stream.tau[:n]
    t0 = time.perf_counter()
    ts, curve = an.butterfly_growth_curve(stream.edge_i, stream.edge_j,
                                          max_edges=n, stride=50)
    eta, c, r2 = an.fit_power_law(ts, curve)
    fits = an.fit_polynomials(ts, curve)
    di = np.bincount(ei, minlength=stream.n_i)
    hubs = an.hub_mask(di)
    frac = an.butterfly_hub_fractions(ei, ej, stream.n_i, stream.n_j)
    corr = an.degree_support_correlation(ei, ej, stream.n_i, stream.n_j)
    conn = an.hub_connection_fraction(di, n)
    first = np.full(stream.n_i, np.inf)
    for t in range(n - 1, -1, -1):
        first[ei[t]] = tau[t]
    young, old = an.young_old_hubs(di, first, np.unique(tau))
    gaps = an.interarrival_distribution(stream.tau, stream.edge_i,
                                        stream.edge_j, max_edges=n)
    alpha = an.hub_probability_exponent(stream.edge_i, stream.edge_j,
                                        stream.n_i, stream.n_j, n)
    sec = time.perf_counter() - t0
    b_n = count_butterflies_np(stream.edges()[:n])
    check(len(curve) == n // 50 and np.all(np.diff(curve) >= 0)
          and curve[-1] == b_n, "growth curve not monotone or off the oracle")
    check(len(fits) == 10 and all(np.isfinite(f.rmse) for f in fits),
          "polynomial fits")
    check(hubs.dtype == bool and hubs.sum() > 0, "no hub in the prefix")
    if frac["n_butterflies"]:
        check(frac["n_butterflies"] == b_n, "hub fractions count another "
              "number of butterflies than the oracle")
        for k in ("hubs_0_4", "i_hubs_0_2", "j_hubs_0_2"):
            check(abs(frac[k].sum() - 1.0) < 1e-9, f"{k} does not sum to 1")
        check(gaps.size == 6 * b_n and np.all(gaps >= 0),
              "inter-arrival sample: 6 edge pairs per butterfly")
        check(0.0 <= alpha <= 2.0, f"hub probability exponent {alpha}")
    check(0.0 <= conn <= 1.0 and young >= 0 and old >= 0, "hub statistics")
    log(f"[analysis] first {n} sgrs in {sec:.4f} s: {b_n} butterflies; "
        f"B(t) ~ |E(t)|^eta with eta {eta:.6f} (c {c:.6g}, R^2 {r2:.6f}) "
        f"over {len(curve)} points; best polynomial R^2 "
        f"{max(f.r2 for f in fits):.6f}; {int(hubs.sum())} i-hubs; hub "
        f"fractions 0-4 {np.round(frac['hubs_0_4'], 4).tolist()}; "
        f"degree/support Pearson i {corr[0]:.4f}, j {corr[1]:.4f}; hub "
        f"connection fraction {conn:.6g}; young/old hubs {young}/{old}; "
        f"{gaps.size} inter-arrival gaps (median "
        f"{np.median(gaps) if gaps.size else float('nan'):.6g}); alpha = "
        f"P(t) {alpha:.6f}")

    k = int(np.argmax(wb.n_i_per_window.astype(np.int64)
                      * wb.n_j_per_window))
    n_i, n_j = int(wb.n_i_per_window[k]), int(wb.n_j_per_window[k])
    v = wb.valid[k]
    edges = np.stack([wb.edge_i[k][v], wb.edge_j[k][v]], 1)
    lanes = [torch.as_tensor(x[k], device=device)
             for x in (wb.edge_i, wb.edge_j, wb.valid)]
    snap = Snapshot(*lanes, n_i, n_j)
    adj = torch.zeros((n_i, n_j), dtype=torch.float32, device=device)
    adj[lanes[0][lanes[2]].long(), lanes[1][lanes[2]].long()] = 1.0
    t0 = time.perf_counter()
    sup = butterfly_support_dense(adj)
    sync(device)
    dsec = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = butterfly_support_np(edges, n_i, n_j)
    nsec = time.perf_counter() - t0
    for side, got, w in zip("ij", sup, want):
        check(got.device.type == device.type, "support left the device")
        check(w.sum() < 2**24 and np.array_equal(got.cpu().numpy(), w),
              f"butterfly_support_dense ({side}) differs from the oracle")
    count = float(snap.count())
    check(count == count_butterflies_np(edges) == replay_counts[k],
          f"Snapshot.count() {count} differs from the oracle")
    log(f"[analysis] window {k} ({n_i} x {n_j} ids, {len(edges)} edges, "
        f"{int(count)} butterflies): butterfly_support_dense on the card "
        f"({dsec * 1e3:.4f} ms, both Grams) equals butterfly_support_np "
        f"({nsec * 1e3:.4f} ms) on every vertex; largest support i "
        f"{int(want[0].max())}, j {int(want[1].max())}; Snapshot.count() "
        f"equals count_butterflies_np")


def shard_layouts(device) -> list[list]:
    """The shard layouts of phase 15: one shard per card (up to 4) where
    the machine has more than one, then two and three shards on the first
    card (three never divides the window count: the pad windows are
    live)."""
    import torch

    first = torch.device(device.type, 0) if device.type == "cuda" else device
    layouts = []
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n > 1:
        layouts.append([torch.device("cuda", k) for k in range(min(n, 4))])
    return layouts + [[first] * 2, [first] * 3]


def phase_sharded(stream, wb, nt_w, alpha0, device, replay,
                  multiset_counts, mb: int = 256):
    """Phase 15 (b): the executor's window sharding (``devices=``) under
    each layout: the pallas replay (K1) and run_sgrapp equal phase 2 bit
    for bit, the multiset engine (K2) equals phase 4, dense / tiled /
    sparse / auto / sampled on every 10th window equal their unsharded
    counts, and the pallas engine at mb=256 equals phase 3's replay.  The
    replay's yardstick is an unsharded replay with a fresh executor, as
    each layout's is; each layout first runs one window per shard, so that
    no time holds a card's first launches.  Returns K1's and K2's launches
    over the phase, each with its routes as read after each run."""
    from repro_torch.core import WindowExecutor, run_sgrapp
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.streams import EngineConfig

    n = len(stream)
    cols = (stream.tau, stream.edge_i, stream.edge_j)
    sub = wb.take(np.arange(0, wb.n_windows, 10))
    tiers = {"dense": {}, "tiled": {}, "sparse": {}, "auto": {},
             "sampled": dict(capacity=2048, seed=0)}
    one = {t: WindowExecutor(t, device=device, **kw).window_counts(sub)
           for t, kw in tiers.items()}
    kk.reset_launch_count()
    t0 = time.perf_counter()
    run_sgrapp(wb, alpha0, executor=WindowExecutor("pallas", device=device))
    sync(device)
    replay_sec = time.perf_counter() - t0
    k1_total, k1_seen = kk.launch_count("K1"), [k1_routes(kk)]
    k2_total, k2_seen = kk.launch_count("K2"), [k2_routes(kk)]
    for devs in shard_layouts(device):
        cards = len({d for d in devs if d.type == "cuda"})
        label = f"[{', '.join(str(d) for d in devs)}]"
        lap = time.perf_counter()
        ex = WindowExecutor("pallas", devices=devs)
        check(ex.n_shards == len(devs) and ex.device == devs[0],
              f"{label}: {ex.n_shards} shards on {ex.device}")
        # a card's first launches (context, kernel modules) stay out of
        # the times: one all-invalid window of the largest rung per shard
        kk.reset_launch_count()
        top = ex.plan(wb)[-1]
        rung = [(top.cap_e, top.cap_i, top.cap_j)]
        ex.warmup(rung)
        ex.warmup(rung, multiset=True)
        sync_all(devs)
        k1_total += kk.launch_count("K1")
        k2_total += kk.launch_count("K2")
        k1_seen.append(k1_routes(kk))
        k2_seen.append(k2_routes(kk))
        kk.reset_launch_count()
        t0 = time.perf_counter()
        res = run_sgrapp(wb, alpha0, executor=ex)
        sync_all(devs)
        sec = time.perf_counter() - t0
        k1 = kk.launch_count("K1")
        check(k1 > 0 or device.type != "cuda",
              f"{label}: the sharded replay never launched K1")
        check(kk.launch_count("K1", "wgmma") == k1,
              f"{label}: a sharded K1 launch was not on route wgmma")
        check(np.array_equal(res.window_counts, replay.window_counts),
              f"{label}: sharded pallas counts differ from phase 2")
        check(np.array_equal(res.estimates, replay.estimates),
              f"{label}: sharded estimates differ from phase 2")
        k1_total += k1
        k1_seen.append(k1_routes(kk))

        kk.reset_launch_count()
        t0 = time.perf_counter()
        _, ms, _, _ = push_engine(EngineConfig(
            tier="pallas", dup_policy="multiset", flush_every=32,
            devices=devs), nt_w, alpha0, *cols, mb=n)
        sync_all(devs)
        ms_sec = time.perf_counter() - t0
        k2 = kk.launch_count("K2")
        check(k2 > 0 or device.type != "cuda",
              f"{label}: the sharded multiset engine never launched K2")
        check(kk.launch_count("K2", "wgmma_limbs") == k2,
              f"{label}: a sharded K2 launch was not on route wgmma_limbs")
        check(kk.launch_count("K1") == 0,
              f"{label}: the multiset engine launched K1")
        check(np.array_equal(ms.window_counts, multiset_counts),
              f"{label}: sharded multiset counts differ from phase 4")
        k2_total += k2
        k2_seen.append(k2_routes(kk))

        t0 = time.perf_counter()
        for t, kw in tiers.items():
            got = WindowExecutor(t, devices=devs, **kw).window_counts(sub)
            check(np.array_equal(got, one[t]),
                  f"{label}: sharded {t} differs from unsharded on every "
                  "10th window")
        tier_sec = time.perf_counter() - t0

        kk.reset_launch_count()
        t0 = time.perf_counter()
        _, st, _, _ = push_engine(EngineConfig(
            tier="pallas", flush_every=32, devices=devs), nt_w, alpha0,
            *cols, mb=mb)
        sync_all(devs)
        st_sec = time.perf_counter() - t0
        check(np.array_equal(st.window_counts, replay.window_counts)
              and np.array_equal(st.estimates, replay.estimates),
              f"{label}: the sharded engine differs from phase 3's replay")
        k1_stream = kk.launch_count("K1")
        check(kk.launch_count("K1", "wgmma") == k1_stream,
              f"{label}: a sharded engine K1 launch was not on route wgmma")
        k1_total += k1_stream
        k1_seen.append(k1_routes(kk))
        wall = time.perf_counter() - lap
        log(f"[sharded] {label}: {len(devs)} shards on {cards} distinct "
            f"card(s); pallas replay {sec:.4f} s (unsharded "
            f"{replay_sec:.4f} s), counts and run_sgrapp estimates equal "
            f"phase 2 bit for bit, K1 launches {k1}, all on route wgmma; "
            f"multiset engine (mb={n}, {ms_sec:.4f} s) equals phase 4 bit "
            f"for bit, K2 launches {k2}, all on route wgmma_limbs; dense, "
            f"tiled, sparse, auto and sampled (capacity 2048, seed 0) equal "
            f"their unsharded counts on every 10th window ({sub.n_windows}; "
            f"{tier_sec:.4f} s); StreamingSGrapp(devices=) at mb={mb} "
            f"({st_sec:.4f} s) equals phase 3's replay, K1 launches "
            f"{k1_stream}; layout wall {wall:.4f} s"
            + ("" if cards > 1 else
               " (one card: the shards run one after another, so this time "
               "says nothing about scale-out)"))
    return ((k1_total, add_routes(*k1_seen)),
            (k2_total, add_routes(*k2_seen)))


def grid_devices(device, n: int) -> list:
    """``n`` devices for a grid: distinct cards where the machine has
    that many, else the first card ``n`` times."""
    import torch

    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", k) for k in range(n)]
    first = torch.device(device.type, 0) if device.type == "cuda" else device
    return [first] * n


def phase_ring(wb, device, replay_counts):
    """Phase 15 (c): the Gram-sharded ring counter on (2, 2) and (1, 3)
    grids (of distinct cards where there are enough, else of the first
    card) over every 10th window, under both schedules, and
    ``distributed_count_dense`` on the largest window, against phase 2's
    counts (exact below 2**24, rtol 1e-6 past it)."""
    import torch

    from repro_torch.core.butterfly import build_biadjacency
    from repro_torch.core.distributed import (
        distributed_count_dense,
        make_distributed_window_counter,
    )
    from repro_torch.core.executor import _pad_window_axis
    from repro_torch.launch.mesh import make_mesh

    idx = np.arange(0, wb.n_windows, 10)
    want = replay_counts[idx]

    def held(got, want, what):
        exact = want < 2**24
        check(np.array_equal(got[exact], want[exact]),
              f"{what}: counts below 2**24 differ from phase 2")
        rel = np.abs(got[~exact] - want[~exact]) / want[~exact]
        check(np.all(rel <= 1e-6), f"{what}: counts past 2**24 off by "
              f"{rel.max() if rel.size else 0}")

    for shape in ((2, 2), (1, 3)):
        devs = grid_devices(device, shape[0] * shape[1])
        first = devs[0]
        mesh = make_mesh(shape, ("data", "model"), devs)
        lanes = _pad_window_axis(wb.edge_i[idx], wb.edge_j[idx],
                                 wb.valid[idx], multiple=shape[0])
        for half, wire in ((False, None), (True, torch.int8)):
            fn = make_distributed_window_counter(
                wb.n_i, wb.n_j, mesh, half_ring=half, wire_dtype=wire)
            t0 = time.perf_counter()
            got = fn(*lanes)
            sync_all(devs)
            sec = time.perf_counter() - t0
            check(got.device == first, "ring counts left the home device")
            got = got.cpu().numpy().astype(np.float64)
            held(got[:len(idx)], want, f"ring {shape}")
            check(np.all(got[len(idx):] == 0), "pad windows counted")
            log(f"[ring] grid {shape} (data, model) on "
                f"{len(set(devs))} distinct device(s) ({first} first), "
                f"{'half ring, int8 wire' if half else 'full ring, fp32 wire'}"
                f": {len(idx)} windows (every 10th) at {wb.n_i} x {wb.n_j} "
                f"in {sec:.4f} s, equal to phase 2")
    k = int(np.argmax(wb.n_i_per_window.astype(np.int64)
                      * wb.n_j_per_window))
    n_i = -(-int(wb.n_i_per_window[k]) // 3) * 3
    adj = build_biadjacency(*(torch.as_tensor(x[k], device=device)
                              for x in (wb.edge_i, wb.edge_j, wb.valid)),
                            n_i, int(wb.n_j_per_window[k]))
    devs = grid_devices(device, 3)
    adj = adj.to(devs[0])
    mesh = make_mesh((1, 3), ("data", "model"), devs)
    t0 = time.perf_counter()
    total = distributed_count_dense(adj, mesh)
    sync_all(devs)
    sec = time.perf_counter() - t0
    held(np.array([float(total)]), replay_counts[k:k + 1],
         "distributed_count_dense")
    log(f"[ring] distributed_count_dense on window {k} ({n_i} x "
        f"{adj.shape[1]}, 3 row-blocks, half ring, int8 wire): "
        f"{float(total):.0f} butterflies in {sec * 1e3:.4f} ms, equal to "
        f"phase 2")


# --------------------------------------------------------------------------
# phases 19-20: the registry's cells and LM training
# --------------------------------------------------------------------------

def uniform_lanes(W, cap, n_i, n_j, seed):
    """The uniform draw of the reference's sgrapp smoke test."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_i, (W, cap)).astype(np.int32),
            rng.integers(0, n_j, (W, cap)).astype(np.int32),
            rng.random((W, cap)) < 0.8)


def skewed_lanes(W, cap, n_i, n_j, seed):
    """Hubs on both sides: ids drawn as ``floor(n * u**3)``, so id 0 takes
    about ``cap / n**(1/3)`` of a window's lanes."""
    rng = np.random.default_rng(seed)
    return ((n_i * rng.random((W, cap)) ** 3).astype(np.int32),
            (n_j * rng.random((W, cap)) ** 3).astype(np.int32),
            rng.random((W, cap)) < 0.9)


def hold_counts(got, lanes, every: int, what: str) -> tuple[int, int, float]:
    """Hold window counts to the int64 oracle on every ``every``-th window:
    equal where the count is below 2**24 (then every partial is, and K1's
    float32 sums are exact), else within rtol 1e-6 (one float32 rounding of
    the exact sum is 2**-24 of it).  Returns (windows held, held exactly,
    largest relative error)."""
    from repro_torch.core import count_butterflies_np

    ei, ej, v = lanes
    n = exact = 0
    worst = 0.0
    for w in range(0, len(got), every):
        want = count_butterflies_np(np.stack([ei[w][v[w]], ej[w][v[w]]], 1))
        g = float(got[w])
        if want < 2**24:
            check(g == want, f"{what}: window {w} counts {g}, oracle {want}")
            exact += 1
        else:
            rel = abs(g - want) / want
            check(rel <= 1e-6, f"{what}: window {w} counts {g}, oracle {want} "
                  f"(rel {rel:.3g} > 1e-6)")
            worst = max(worst, rel)
        n += 1
    return n, exact, worst


def phase_sgrapp_cells(device, seed: int, *, smoke: bool = False) -> tuple[int, dict]:
    """Phase 19: ``list_cells("sgrapp")`` at its full shapes through each
    cell's ``make_step(Sharder(None))`` on the card: ``win_8k`` (32 windows
    of 8,192 lanes, 4,096 x 8,192), ``estimator`` (512 windows, the same
    lanes) and ``win_64k`` (32 windows of 65,536 lanes, 32,768 x 65,536),
    each on a uniform and a skewed draw from ``seed``; window stacks are
    chunked to ``registry.STACK_BYTES`` (win_64k's uint8 stack is 2 GiB a
    window).  Counts are held to the oracle (every window, every 8th of
    win_64k); the estimator's output equals ``sgrapp_x_estimate`` of the
    held counts on the same device.  Logs K1's launches by route, wall time,
    windows/s and K1's share of the device time of one profiled run.
    Returns K1's launches and routes over the counted runs."""
    import torch

    from repro_torch.configs import get_arch, list_cells
    from repro_torch.configs.registry import STACK_BYTES, window_counter
    from repro_torch.core.sgrapp import sgrapp_x_estimate
    from repro_torch.distributed import Sharder
    from repro_torch.kernels.butterfly import butterfly_kernel as kk

    cfg = get_arch("sgrapp").smoke_config() if smoke else \
        get_arch("sgrapp").full_config()
    cells = list_cells("sgrapp", smoke=smoke)
    launches, routes = 0, k1_routes(kk)
    routes = dict.fromkeys(routes, 0)
    for name in ("win_8k", "estimator", "win_64k"):
        if name not in cells:
            continue
        cell = cells[name]
        W, cap, n_i, n_j = cfg["shapes"][name]
        per = max(1, STACK_BYTES // (n_i * n_j))
        step = cell.make_step(Sharder(None), device=device)
        every = 8 if name == "win_64k" else 1
        for d, draw in enumerate((uniform_lanes, skewed_lanes)):
            lanes = draw(W, cap, n_i, n_j, seed + d)
            extra = ()
            if name == "estimator":
                cum = np.cumsum(lanes[2].sum(1)).astype(np.float32)
                truths = (cum.astype(np.float64) ** 1.5).astype(np.float32)
                extra = (cum, truths, np.arange(W) < W // 8, 1.02)
            sync(device)
            kk.reset_launch_count()
            t0 = time.perf_counter()
            out = step(*lanes, *extra)
            sync(device)
            sec = time.perf_counter() - t0
            n_k1 = kk.launch_count("K1")
            r = k1_routes(kk)
            want_launches = -(-W // per) if device.type == "cuda" else 0
            check(n_k1 == want_launches,
                  f"sgrapp/{name}: {n_k1} K1 launches, want {want_launches}")
            check(device.type != "cuda" or r["wgmma"] == n_k1,
                  f"sgrapp/{name}: K1 routes {r}, want all wgmma")
            launches += n_k1
            routes = add_routes(routes, r)
            if name == "estimator":
                est, alpha = out
                counts = window_counter(n_i, n_j, device)(*lanes)
                cum, truths, tmask, alpha0 = extra
                want_est, want_alpha = sgrapp_x_estimate(
                    counts, cum, alpha0, truths, tmask, device=device)
                check(bool(torch.isfinite(est).all()) and est.shape == (W,),
                      f"sgrapp/{name}: estimates not finite [{W}]")
                check(torch.equal(est, want_est) and
                      float(alpha) == float(want_alpha),
                      f"sgrapp/{name}: estimates differ from sgrapp_x_estimate "
                      "of the same counts")
            else:
                counts = out
            check(counts.shape == (W,) and counts.dtype == torch.float32,
                  f"sgrapp/{name}: counts {tuple(counts.shape)} {counts.dtype}")
            t1 = time.perf_counter()
            held, exact, worst = hold_counts(counts.cpu().numpy(), lanes, every,
                                             f"sgrapp/{name} {draw.__name__}")
            osec = time.perf_counter() - t1
            c = counts.cpu().numpy()
            log(f"[sgrapp] {name} ({W} x {cap} lanes, {n_i} x {n_j}), "
                f"{draw.__name__}: {sec:.4f} s, {W / sec:.4f} windows/s, K1 "
                f"launches {n_k1} ({per} windows a launch) by route {r}; "
                f"counts {c.min():.6g}-{c.max():.6g}, {held} windows held to "
                f"the int64 oracle ({osec:.4f} s): {exact} equal below 2**24, "
                f"the rest within rtol 1e-6 (max rel {worst:.3g})")
            del lanes, out, counts
        # K1's share of the device time of one run on the skewed draw
        lanes = skewed_lanes(W, cap, n_i, n_j, seed + 1)
        extra = () if name != "estimator" else (
            np.cumsum(lanes[2].sum(1)).astype(np.float32),
            np.ones(W, np.float32), np.zeros(W, bool), 1.02)
        if device.type == "cuda":
            _, busy, by_kernel = profile(f"sgrapp/{name}, skewed draw",
                                         lambda: step(*lanes, *extra), device,
                                         top=4)
            k1_ms = sum(ms for k, ms in by_kernel.items()
                        if "butterfly_windows_wgmma" in k or "round_sums" in k)
            log(f"[sgrapp] {name}: K1 {k1_ms:.4f} ms of {busy:.4f} ms device "
                f"time ({k1_ms / busy:.4%}), {k1_ms / W:.4f} ms a window; the "
                "rest is the scatter, its zero fill and the lanes' upload")
        del lanes
    return launches, routes


def lm_batch(cfg, b: int, s: int, seed: int, device) -> dict:
    """``b`` sequences of ``s`` tokens of ``data.token_batches`` (copy
    structure, so a model can learn it) as tensors on ``device``."""
    import torch

    from repro_torch.data import token_batches

    host = next(token_batches(cfg.vocab_size, b, s, seed=seed))
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


def tree_to(x, device):
    """A copy of a tensor, or of a dict of tensors, on ``device``."""
    if isinstance(x, dict):
        return {k: tree_to(v, device) for k, v in x.items()}
    return x.to(device, copy=True)


def grads_of(model, batch, cfg, n_micro: int = 1) -> tuple[float, dict]:
    """The loss and its gradients as the train step takes them: the mean
    over ``n_micro`` equal microbatches of rows, in float32 (each routes
    its MoE tokens with its own capacity)."""
    import torch

    from repro_torch.models.transformer import lm_loss

    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss, grads = 0.0, None
    for mb in zip(*(v.chunk(n_micro) for v in batch.values())):
        l_mb = lm_loss(model, dict(zip(batch, mb)), cfg)
        g_mb = torch.autograd.grad(l_mb, list(named.values()))
        loss += float(l_mb.detach()) / n_micro
        grads = [g.float() for g in g_mb] if grads is None else \
            [acc + g.float() for acc, g in zip(grads, g_mb)]
    return loss, {n: g / n_micro for n, g in zip(named, grads)}


# Where a parameter may miss rtol 1e-5, atol 1e-6 after one AdamW step at
# lr 3e-4 from a common state: a gradient gap d at an entry of size |g|
# moves Adam's normalised step by up to about 2 * lr * d / |g| (bias
# correction weighs the earlier steps' moments in), so with d <= 3e-6 *
# max|g| (the gap measured on every leaf is at most 2.1e-6 * max|g|) the
# step reaches a gap of atol 1e-6 only where |g| <= 2 * 3e-4 * 3e-6 / 1e-6
# * max|g|, i.e. 1.8e-3 * max|g|, rounded up here.
ADAM_FLOOR = 2e-3


def phase_train_smoke(device, seed: int, tmp: Path, smoke: bool) -> int:
    """Phase 20 (a): the five LM archs' smoke configs in float32 through
    their ``train_4k`` cell's step (8 microbatches) on the card against the
    CPU port: the loss within rtol 1e-4 and every gradient leaf within
    ``1e-4 * max|g_cpu| + 1e-6``, and after 3 AdamW steps every parameter
    within ``2 * lr`` and within rtol 1e-5, atol 1e-6 except where the
    step's CPU gradient entry is at most ``ADAM_FLOOR * max|g_cpu|`` of its
    leaf (there Adam's normalised step turns the gradients' rounding gap
    into a step gap of up to about lr).  Each of the 3 steps starts the
    card from the CPU's state, so that only that step's rounding separates
    the two, and the loss and gradients are held at each.  Then the
    launcher (``launch.train.main``) trains phi4-mini-3.8b's smoke config
    for 3 steps on the card with a checkpoint each step and restores it.
    Returns K4's launches over the card's train steps."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import lm_cells
    from repro_torch.distributed import Sharder
    from repro_torch.kernels.flash_attention import flash_kernel as k4
    from repro_torch.launch import train as launcher
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.train import AdamWState, TrainState, adamw_init

    lr = 3e-4
    k4_total = 0
    for arch in ("phi4-mini-3.8b", "granite-8b", "minicpm3-4b",
                 "phi3.5-moe-42b", "dbrx-132b"):
        cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
        cpu = init_lm_params(cfg, seed=seed, device="cpu")
        b_cpu = lm_batch(cfg, 8, 96, seed, "cpu")
        b_card = {k: v.to(device) for k, v in b_cpu.items()}
        n_micro = 8                      # lm_cells' default for train_4k
        step = lm_cells(cfg, n_microbatches=n_micro)["train_4k"].make_step(
            Sharder(None))
        s_cpu = TrainState(cpu, adamw_init(cpu), seed)
        losses, worst, worst_g, off, n_k4 = [], 0.0, 0.0, 0, 0
        for t in range(3):
            # each step starts the card from the CPU's state, so that only
            # this step's rounding separates the two
            card = copy.deepcopy(s_cpu.params).to(device)
            opt = s_cpu.opt
            s_card = TrainState(card, AdamWState(*(
                tree_to(x, device) for x in (opt.step, opt.m, opt.v))), seed)
            l_cpu, g_cpu = grads_of(s_cpu.params, b_cpu, cfg, n_micro)
            l_card, g_card = grads_of(card, b_card, cfg, n_micro)
            losses.append((l_card, l_cpu))
            check(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu),
                  f"{arch} step {t}: loss {l_card} on the card, {l_cpu} on "
                  "the CPU")
            for name, g in g_cpu.items():
                gap = float((g_card[name].cpu() - g).abs().max())
                scale = float(g.abs().max())
                check(gap <= 1e-4 * scale + 1e-6, f"{arch} step {t}: gradient "
                      f"{name} off by {gap} (max {scale})")
                worst = max(worst, gap / max(scale, 1e-30))
            before = k4.launch_count()
            s_card, m_card = step(s_card, b_card)
            sync(device)
            n_k4 += k4.launch_count() - before
            s_cpu, m_cpu = step(s_cpu, b_cpu)
            check(abs(float(m_card["loss"]) - float(m_cpu["loss"]))
                  <= 1e-4 * abs(float(m_cpu["loss"])),
                  f"{arch} step {t}: step loss {float(m_card['loss'])} vs "
                  f"{float(m_cpu['loss'])}")
            p_card = dict(s_card.params.named_parameters())
            total = 0
            for name, p in s_cpu.params.named_parameters():
                gap = (p_card[name].detach().cpu() - p.detach()).abs()
                check(float(gap.max()) <= 2 * lr, f"{arch} step {t}: "
                      f"parameter {name} off by {float(gap.max())}")
                miss = gap > 1e-6 + 1e-5 * p.detach().abs()
                if bool(miss.any()):
                    g = g_cpu[name].abs()
                    rel_g = float(g[miss].max()) / float(g.max())
                    worst_g = max(worst_g, rel_g)
                    check(rel_g <= ADAM_FLOOR,
                          f"{arch} step {t}: parameter {name} beyond rtol "
                          f"1e-5 where its gradient entry is over "
                          f"{ADAM_FLOOR} max|g| ({rel_g:.3g})")
                off += int(miss.sum())
                total += p.numel()
        k4_total += n_k4
        check(device.type != "cuda" or n_k4 == 3 * 8 * 2 * cfg.n_layers,
              f"{arch}: {n_k4} K4 launches over 3 steps of 8 microbatches, "
              f"want {3 * 8 * 2 * cfg.n_layers} (forward and recompute)")
        (l_card, l_cpu) = losses[0]
        log(f"[train] {arch} smoke (float32, 8 x 96 tokens, 8 microbatches): "
            f"loss {l_card:.6f} on {device} vs {l_cpu:.6f} on the CPU "
            f"(rel {abs(l_card - l_cpu) / l_cpu:.3g}); worst gradient leaf "
            f"max|dg|/max|g| over 3 steps {worst:.3g}; 3 AdamW steps, each "
            f"from the CPU's state: loss after {float(m_card['loss']):.6f}, "
            f"{off} of 3 x {total} parameter updates beyond rtol 1e-5"
            + (f", each where its gradient entry is at most "
               f"{worst_g:.3g} max|g|" if off else "")
            + f"; K4 launches {n_k4}")
        del cpu, card, s_cpu, s_card, g_cpu, g_card, opt
    # the launcher: 3 steps with a checkpoint each, then a restart (a CPU
    # rehearsal cuts train_4k's sequences to 32 tokens)
    from repro_torch.configs import registry

    ck = str(tmp / "train_ckpt")
    shapes = registry.LM_SHAPES
    if smoke:
        registry.LM_SHAPES = {**shapes, "train_4k": (32, 256, "train")}
    try:
        t0 = time.perf_counter()
        out = launcher.main(["--arch", "phi4-mini-3.8b", "--smoke", "--steps",
                             "3", "--ckpt", ck, "--ckpt_every", "1",
                             "--device", device.type])
        sec = time.perf_counter() - t0
        check(out["start"] == 0 and int(out["metrics"]["step"]) == 3
              and np.isfinite(float(out["metrics"]["loss"])),
              "the launcher did not train 3 steps")
        again = launcher.main(["--arch", "phi4-mini-3.8b", "--smoke", "--steps",
                               "4", "--ckpt", ck, "--device", device.type])
    finally:
        registry.LM_SHAPES = shapes
    check(again["start"] == 3 and int(again["metrics"]["step"]) == 4,
          "the launcher did not restore step 3 and train on")
    log(f"[train] launcher: phi4-mini-3.8b smoke (bf16, 64 x 4,096 tokens, 8 "
        f"microbatches) 3 steps on {device} in {sec:.4f} s with a checkpoint "
        f"each step, loss {float(out['metrics']['loss']):.6f}; restarted, "
        f"restored step 3 and took step 4 (loss "
        f"{float(again['metrics']['loss']):.6f})")
    return k4_total


def attention_bwd_bound_ms(q, k, v, chunk: int) -> tuple[float, str]:
    """The least time an H100 could take for ``attention_backward``'s work
    on these inputs, as it computes it: per query chunk the kept (query,
    key) pairs (keys up to the chunk's last row) through five float32
    matmuls (scores, dV, dP, dQ, dK) at the fp32 SIMT peak; bytes: q, k, v
    and dO read once, dq, dk, dv written once."""
    b, sq, h, hd = q.shape
    skv, hd_v = k.shape[1], v.shape[3]
    pairs = sum(min(q0 + chunk, skv) * min(chunk, sq - q0)
                for q0 in range(0, sq, chunk)) * b * h
    ops = 2.0 * pairs * (3 * hd + 2 * hd_v)
    moved = 2 * (q.numel() + k.numel() + v.numel()) * q.element_size() \
        + b * sq * h * hd_v * q.element_size()
    ops_ms, bytes_ms = ops / PEAK_FP32_SIMT * 1e3, moved / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_attention_backward(device, seed: int, shapes) -> dict:
    """Phase 20 (d): the attention's autograd function (K4 forward, the
    float32 torch backward) against torch autograd through K4's plain
    version on the same card, at phi4-mini's shape and at MLA's (hd 96,
    hd_v 64), bf16: dq, dk, dv each within one bf16 rounding of the other
    (``|d| <= 2**-7 |g| + 2**-10 max|g|``), and both times (forward plus
    backward, and the backward alone).  Returns the backward's ms at each
    shape."""
    import torch

    from repro_torch.kernels.flash_attention.flash_kernel import (
        flash_attention_plain,
    )
    from repro_torch.models.transformer.attention import (
        attention_backward,
        attention_scale,
        gqa_attention_chunked,
    )

    out_ms = {}
    for label, (b, s, h, hkv, hd, hd_v, chunk) in shapes.items():
        g = torch.Generator(device=device).manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=g, device=device).to(torch.bfloat16)
                   for shape in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd_v)))
        d_out = torch.randn((b, s, h, hd_v), generator=g, device=device).to(torch.bfloat16)
        scale = attention_scale(hd)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def ours():
            out = gqa_attention_chunked(*leaves, chunk_q=chunk, chunk_k=chunk)
            return torch.autograd.grad(out, leaves, d_out)

        def plain():
            out = flash_attention_plain(*leaves, block_q=chunk, block_k=chunk,
                                        scale=scale)
            return torch.autograd.grad(out, leaves, d_out)

        got, want = ours(), plain()
        errs = []
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            gap = (a.float() - w.float()).abs()
            top = float(w.float().abs().max())
            ok = bool((gap <= 2.0**-7 * w.float().abs() + 2.0**-10 * top).all())
            check(ok, f"attention backward {label}: {name} beyond one bf16 "
                  f"rounding of autograd through the plain version (max abs "
                  f"{float(gap.max())}, max |g| {top})")
            errs.append(float(gap.max()))
        ms_ours = time_ms(ours, device, reps=3)
        ms_plain = time_ms(plain, device, reps=3)
        ms_bwd = time_ms(lambda: attention_backward(
            q, k, v, d_out, causal=True, q_offset=0, chunk_q=chunk,
            scale=scale), device, reps=3)
        bound, by = attention_bwd_bound_ms(q, k, v, chunk)
        out_ms[label] = ms_bwd
        log(f"[train] attention backward at {label} (q [{b}, {s}, {h}, {hd}], "
            f"k [{b}, {s}, {hkv}, {hd}], v [.., {hd_v}], bf16, chunk {chunk}): "
            f"dq/dk/dv max abs err {errs[0]:.4g}/{errs[1]:.4g}/{errs[2]:.4g} "
            f"against autograd through flash_attention_plain; forward + "
            f"backward {ms_ours:.4f} ms (K4 + the torch backward) vs "
            f"{ms_plain:.4f} ms (plain + autograd); the backward alone "
            f"{ms_bwd:.4f} ms, bound {bound:.4f} ms by {by} (fp32 SIMT "
            f"{PEAK_FP32_SIMT / 1e12:.0f} TFLOP/s)")
        del q, k, v, d_out, leaves, got, want
    return out_ms


def phase_train_full(device, seed: int, *, smoke: bool, bwd_ms: float) -> dict:
    """Phase 20 (b, c): phi4-mini-3.8b at full width on seeded random
    weights.  (b) All 32 layers: train_4k's cell step with one microbatch
    on one 1 x 4,096 sequence, 3 steps on that repeated batch at lr 3e-4:
    the loss finite and falling, 64 K4 launches a step (forward and
    per-block recompute) all on route ``wgmma``; step ms, tokens/s, peak
    memory, a profile of one step with the attention backward's share of
    its device time (the kernels inside its ``record_function`` span;
    beside it ``bwd_ms``, phase 20 (d)'s time at this shape alone) and
    ``6 N tokens / (step s * peak)`` against the dense bf16 peak.  (c) The
    config cut to 8 of its 32 layers, 2 x 4,096 tokens in 2 microbatches
    (float32 accumulation) against one microbatch on the same weights and
    batch.  Returns K4's launches and routes over (b)'s three steps."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import lm_cells
    from repro_torch.distributed import Sharder
    from repro_torch.kernels.flash_attention import flash_kernel as k4
    from repro_torch.models.transformer import init_lm_params
    from repro_torch.train import TrainState, adamw_init

    arch = get_arch(LM_ARCH)
    cfg = arch.smoke_config() if smoke else arch.full_config()
    seq = 96 if smoke else 4096
    if not smoke:
        log("[train] reduced: global batch 256 -> 1: train_4k's 1,048,576 "
            "tokens a step need a pod")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = init_lm_params(cfg, seed=seed, device=device)
    state = TrainState(params, adamw_init(params), seed)
    sync(device)
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[train] {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params:,} parameters ({cfg.dtype}) and float32 moments on "
        f"{device} in {time.perf_counter() - t0:.4f} s")
    step = lm_cells(cfg, n_microbatches=1)["train_4k"].make_step(Sharder(None))
    batch = lm_batch(cfg, 1, seq, seed, device)
    losses, step_ms = [], []
    k4.reset_launch_count()
    for i in range(3):
        before = k4.launch_count()
        sync(device)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        check(device.type != "cuda"
              or k4.launch_count() - before == 2 * cfg.n_layers,
              f"step {i}: {k4.launch_count() - before} K4 launches, want "
              f"{2 * cfg.n_layers}")
    launches = k4.launch_count()
    routes = {r: k4.launch_count(r) for r in k4.VARIANTS}
    check(all(np.isfinite(losses)) and losses[0] > losses[1] > losses[2],
          f"the loss does not fall over 3 steps on one batch: {losses}")
    check(device.type != "cuda" or routes["wgmma"] == launches,
          f"K4 routes {routes}, want all wgmma")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tokens = seq
    best = min(step_ms[1:])
    flops = 6.0 * cfg.active_param_count() * tokens
    log(f"[train] {LM_ARCH} train_4k, 1 x {seq} tokens, 1 microbatch: losses "
        f"{', '.join(f'{x:.6f}' for x in losses)} (falling); step ms "
        f"{', '.join(f'{x:.4f}' for x in step_ms)}; {tokens / best * 1e3:.4f} "
        f"tokens/s at the best later step; peak memory {peak / 2**30:.4f} GiB; "
        f"K4 launches {launches} ({2 * cfg.n_layers} a step) by variant "
        f"{routes}")
    if device.type == "cuda":
        log(f"[train] 6 N tokens / (step s x peak) = {flops / (best / 1e3) / PEAK_BF16_OPS:.4%} "
            f"of the dense bf16 peak {PEAK_BF16_OPS / 1e12:.0f} TFLOP/s (H100 "
            f"SXM data sheet; N = {cfg.active_param_count():,})")
        _, busy, by_kernel = profile(f"{LM_ARCH} train step",
                                     lambda: step(state, batch), device,
                                     top=10, spans=("attention_backward",))
        bwd_step = by_kernel["span:attention_backward"]
        check(0 < bwd_step < busy,
              f"the attention backward's span reads {bwd_step} ms of the "
              f"profiled step's {busy} ms of device time")
        log(f"[train] the attention backward takes {bwd_step:.4f} ms of the "
            f"profiled step's {busy:.4f} ms of device time "
            f"({bwd_step / busy:.4%}; its record_function span over "
            f"{cfg.n_layers} layers); alone at this shape (phase 20 (d)) "
            f"{bwd_ms:.4f} ms a layer, {cfg.n_layers * bwd_ms:.4f} ms for "
            f"{cfg.n_layers}")
    del state, params, m
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # (c) microbatching at full width, 8 of 32 layers
    depth = cfg.n_layers if smoke else 8
    cut = dataclasses.replace(cfg, n_layers=depth)
    if not smoke:
        log(f"[train] reduced: {LM_ARCH} cut to {depth} of its "
            f"{cfg.n_layers} layers for 2 x 4,096 tokens in 2 microbatches (a "
            "float32 gradient accumulator beside the whole model's state "
            "does not fit one card)")
    batch2 = lm_batch(cut, 2, seq, seed + 1, device)
    res = {}
    for nm in (2, 1):
        params = init_lm_params(cut, seed=seed, device=device)
        state = TrainState(params, adamw_init(params), seed)
        k4.reset_launch_count()
        sync(device)
        t0 = time.perf_counter()
        state, m = lm_cells(cut, n_microbatches=nm)["train_4k"].make_step(
            Sharder(None))(state, batch2)
        sync(device)
        res[nm] = (float(m["loss"]), float(m["grad_norm"]),
                   (time.perf_counter() - t0) * 1e3, k4.launch_count())
        del state, params, m
        if device.type == "cuda":
            torch.cuda.empty_cache()
    (l2, g2, ms2, n2), (l1, g1, ms1, _) = res[2], res[1]
    check(np.isfinite([l2, g2]).all()
          and (device.type != "cuda" or n2 == 2 * 2 * depth),
          f"microbatched step: loss {l2}, grad norm {g2}, K4 launches {n2}")
    check(abs(l2 - l1) <= 1e-5 * abs(l1) and abs(g2 - g1) <= 1e-4 * abs(g1),
          f"2 microbatches (loss {l2}, grad norm {g2}) vs 1 (loss {l1}, grad "
          f"norm {g1}) beyond rtol 1e-5 / 1e-4")
    log(f"[train] {LM_ARCH} at {depth} layers, 2 x {seq} tokens: 2 "
        f"microbatches (float32 accumulation) loss {l2:.6f}, grad norm "
        f"{g2:.6f}, {ms2:.4f} ms, K4 launches {n2}; 1 microbatch loss "
        f"{l1:.6f}, grad norm {g1:.6f}, {ms1:.4f} ms")
    return {"launches": launches, "routes": routes, "step_ms": best}


def phase_train(device, seed: int, *, smoke: bool) -> dict:
    """Phase 20: LM training.  (a) the smoke configs on the card against
    the CPU port and the launcher; (d) the attention backward held; (b, c)
    phi4-mini-3.8b at full width.  Returns K4's launches on (b)."""
    import tempfile

    from repro_torch.configs import get_arch

    with tempfile.TemporaryDirectory() as tmp:
        phase_train_smoke(device, seed, Path(tmp), smoke)
    full = get_arch(LM_ARCH).smoke_config() if smoke else get_arch(LM_ARCH).full_config()
    mla = get_arch("minicpm3-4b").smoke_config() if smoke else \
        get_arch("minicpm3-4b").full_config()
    s = 96 if smoke else 4096
    shapes = {
        LM_ARCH: (1, s, full.n_heads, full.n_kv_heads, full.head_dim,
                  full.head_dim, full.attn_chunk_q),
        "minicpm3-4b (MLA)": (1, s, mla.n_heads, mla.n_heads,
                              mla.mla.qk_nope_head_dim + mla.mla.qk_rope_head_dim,
                              mla.mla.v_head_dim, mla.attn_chunk_q),
    }
    bwd = phase_attention_backward(device, seed, shapes)
    return phase_train_full(device, seed, smoke=smoke, bwd_ms=bwd[LM_ARCH])


# --------------------------------------------------------------------------
# phases 21-22: GNN and xDeepFM training (no TPU kernel on this path)
# --------------------------------------------------------------------------

# phase 21 (b): the GNN cells run at full width on one card; a cell that
# does not fit 80 GB is cut to the largest share of its nodes and edges in
# CUT_SHARES that fits, and logged as reduced
GNN_CELLS = (("graphsage-reddit", "ogb_products"),
             ("graphsage-reddit", "minibatch_lg"),
             ("graphcast", "minibatch_lg"), ("graphcast", "ogb_products"),
             ("dimenet", "molecule"), ("dimenet", "minibatch_lg"),
             ("dimenet", "ogb_products"),
             ("equiformer-v2", "full_graph_sm"), ("equiformer-v2", "molecule"),
             ("equiformer-v2", "minibatch_lg"),
             ("equiformer-v2", "ogb_products"))
CUT_SHARES = (1, 3 / 4, 1 / 2, 3 / 8, 1 / 4, 3 / 16, 1 / 8, 3 / 32, 1 / 16,
              3 / 64, 1 / 32)
# DimeNet's full-width trunk has no normalization: under the reference's
# AdamW (lr 3e-4, clip 1.0) its loss overshoots at the first step (lr *
# sign(g) on every entry) and oscillates after it on random inputs, so it
# is not required to fall over 3 steps; its gradient must point downhill
# (``descent_check``) and its losses stay finite
OSCILLATES = {"dimenet"}
# minibatch_lg's sampled-from graph: Reddit's nodes and edges
# (arXiv:1706.02216), degrees skewed, 1,024 seeds, fanout 15-10
REDDIT_NODES, REDDIT_EDGES = 232_965, 114_615_892
# phase 21 (a): the card against the CPU port in float32.  The card sums
# segments with atomics in a run-dependent order, and the CPU in another:
# the loss within rtol 1e-4, every gradient leaf within 1e-4 * max|g| +
# 1e-6, and after each AdamW step every parameter within 2 * lr and within
# rtol 1e-5, atol 1e-6 except where its gradient entry is at most
# ADAM_FLOOR * max|g| of its leaf (phase 20's derivation).  A leaf whose
# gradient is 0 up to rounding is held within 2 * lr only, since Adam turns
# its rounding noise into steps of about lr either way: EquiformerV2's last
# attention bias, which shifts every logit of a softmax.  It is told by its
# card-CPU gap: over NOISE_LEAF of its own max|g| (then the gradient check
# above bounds its max|g| near 1e-6), where every other leaf stays below
# 1e-5 of its max
NOISE_LEAF = 1e-2
GNN_SMOKE_NODES, GNN_SMOKE_EDGES = 1024, 8192
# phase 21 (c): the halo losses against the gather losses on a locality
# graph, GraphSAGE at 2**20 edges; EquiformerV2 at 2**18 (its gather loss
# holds [E, 49, 128] float32 stacks: 25.7 GB each at 2**20 edges)
HALO_SIZES = {"graphsage-reddit": (1 << 18, 1 << 20),
              "equiformer-v2": (1 << 16, 1 << 18)}
HALO_TOL = {"graphsage-reddit": 2e-5, "equiformer-v2": 3e-5}


def tree_copy(tree, device):
    """Detached copies of a tree's tensors on ``device``."""
    from repro_torch.train.checkpoint import tree_map

    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def tree_grads(loss_fn, params, batch) -> tuple[float, dict]:
    """The loss and its gradients by leaf name (``param_leaves``)."""
    import torch

    from repro_torch.train.optimizer import param_leaves

    leaves = param_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def hold_steps(label: str, step, loss_fn, params_cpu, batch_cpu, device,
               lr: float = 3e-4) -> str:
    """Phase 21/22 (a): three train steps of ``step`` (a cell's) on the card
    against the CPU port, each started on the card from the CPU's state:
    the loss and every gradient leaf before the step, the step's loss and
    every parameter after it (the tolerances above).  Returns the log's
    summary."""
    from repro_torch.train import AdamWState, TrainState, adamw_init
    from repro_torch.train.optimizer import param_leaves

    s_cpu = TrainState(params_cpu, adamw_init(params_cpu), 0)
    b_card = {k: v.to(device) for k, v in batch_cpu.items()}
    worst = worst_l = worst_g = 0.0
    off = total = 0
    noise: set = set()
    for t in range(3):
        card = tree_copy(s_cpu.params, device)
        opt = s_cpu.opt
        s_card = TrainState(card, AdamWState(*(tree_copy(x, device) for x in opt)), 0)
        l_cpu, g_cpu = tree_grads(loss_fn, s_cpu.params, batch_cpu)
        l_card, g_card = tree_grads(loss_fn, card, b_card)
        worst_l = max(worst_l, abs(l_card - l_cpu) / abs(l_cpu))
        check(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu),
              f"{label} step {t}: loss {l_card} on the card, {l_cpu} on the CPU")
        for name, g in g_cpu.items():
            gap = float((g_card[name].cpu() - g).abs().max())
            scale = float(g.abs().max())
            check(gap <= 1e-4 * scale + 1e-6, f"{label} step {t}: gradient "
                  f"{name} off by {gap} (max {scale})")
            if gap > NOISE_LEAF * scale:
                noise.add(name)
            else:
                worst = max(worst, gap / max(scale, 1e-30))
        s_card, m_card = step(s_card, b_card)
        s_cpu, m_cpu = step(s_cpu, batch_cpu)
        sync(device)
        check(abs(float(m_card["loss"]) - float(m_cpu["loss"]))
              <= 1e-4 * abs(float(m_cpu["loss"])),
              f"{label} step {t}: step loss {float(m_card['loss'])} vs "
              f"{float(m_cpu['loss'])}")
        p_card = param_leaves(s_card.params)
        for name, p in param_leaves(s_cpu.params).items():
            gap = (p_card[name].detach().cpu() - p.detach()).abs()
            check(float(gap.max()) <= 2 * lr, f"{label} step {t}: parameter "
                  f"{name} off by {float(gap.max())}")
            if name in noise:
                continue
            miss = gap > 1e-6 + 1e-5 * p.detach().abs()
            if bool(miss.any()):
                g = g_cpu[name].abs()
                rel_g = float(g[miss].max()) / max(float(g.max()), 1e-30)
                worst_g = max(worst_g, rel_g)
                check(rel_g <= ADAM_FLOOR, f"{label} step {t}: parameter "
                      f"{name} beyond rtol 1e-5 where its gradient entry is "
                      f"over {ADAM_FLOOR} max|g| ({rel_g:.3g})")
            off += int(miss.sum())
            total += p.numel()
    return (f"loss rel gap up to {worst_l:.3g}; worst gradient leaf "
            f"max|dg|/max|g| {worst:.3g}; 3 AdamW steps, each from the CPU's "
            f"state: {off} of {total} parameter updates beyond rtol 1e-5"
            + (f", each where its gradient entry is at most {worst_g:.3g} "
               "max|g|" if off else "")
            + (f"; held within 2 lr only (gradient 0 up to rounding): "
               f"{sorted(noise)}" if noise else ""))


def graph_edges(n: int, e: int, gen, device, molecule: int = 0,
                mesh: bool = False):
    """``e`` edges on ``n`` nodes from ``gen``: sources uniform,
    destinations skewed (``floor(n u**3)``: hubs at the low ids, where the
    scatter's atomics collide); with ``molecule`` > 0, each edge stays
    inside its source's block of that many atoms; with ``mesh``, each edge
    goes to one of the six next node ids (a ring lattice of bounded degree
    standing in for GraphCast's icosahedral multi-mesh: its sum
    aggregation over 16 layers overflows float32 at full width on a graph
    with hubs)."""
    import torch

    src = torch.randint(0, n, (e,), generator=gen, device=device)
    if mesh:
        dst = (src + torch.randint(1, 7, (e,), generator=gen, device=device)) % n
    elif molecule:
        off = (molecule * torch.rand(e, generator=gen, device=device) ** 3).long()
        dst = torch.clamp(src // molecule * molecule + off, max=n - 1)
    else:
        dst = (n * torch.rand(e, generator=gen, device=device) ** 3).long()
    return src, dst


def gnn_batch(arch: str, cfg, shp, n: int, e: int, seed: int, device) -> dict:
    """A seeded batch of ``n`` nodes and ``e`` edges for ``arch``'s cell at
    shape ``shp`` (the registry's layout; ``graph_edges``, GraphCast's on
    its mesh stand-in): masks about 97% on; labels in
    ``[0, n_classes)``; DimeNet's triplets by
    ``build_triplets_vectorised`` on the host (``TRIPLET_BUDGET`` a edge),
    its molecules 30 atoms each with one ``graph_id`` and target each;
    EquiformerV2's Wigner inputs seeded normals times 0.2 (the reference's
    halo test)."""
    import torch

    from repro_torch.configs.registry import GNN_KEY
    from repro_torch.configs.shapes import TRIPLET_BUDGET, pad_to
    from repro_torch.models.gnn.dimenet import build_triplets_vectorised

    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=device)  # noqa: E731
    key = GNN_KEY[cfg.name]
    src, dst = graph_edges(n, e, g, device, 30 if shp.batched else 0,
                           mesh=key == "graphcast")
    b = {"edge_src": src.int(), "edge_dst": dst.int(),
         "edge_mask": torch.rand(e, generator=g, device=device) < 0.97}
    if key == "graphsage":
        b |= {"x": rnd(n, cfg.d_in),
              "labels": torch.randint(0, cfg.n_classes, (n,), generator=g,
                                      device=device).int(),
              "label_mask": (torch.rand(n, generator=g, device=device) < 0.9).float()}
    elif key == "graphcast":
        b |= {"x": rnd(n, cfg.d_in), "edge_feat": rnd(e, cfg.d_edge_in),
              "target": rnd(n, cfg.d_out)}
    elif key == "dimenet":
        t = pad_to(e * TRIPLET_BUDGET[shp.name])
        t_in, t_out, t_mask = build_triplets_vectorised(
            src.cpu().numpy(), dst.cpu().numpy(), t)
        b |= {"pos": rnd(n, 3) * 2, "z": torch.randint(
                  1, 9, (n, 1), generator=g, device=device).float(),
              "t_in": torch.as_tensor(t_in, device=device).int(),
              "t_out": torch.as_tensor(t_out, device=device).int(),
              "triplet_mask": torch.as_tensor(t_mask, device=device)}
        if shp.batched:
            b |= {"graph_id": torch.clamp(torch.arange(n, device=device) // 30,
                                          max=shp.n_graphs - 1).int(),
                  "target": rnd(shp.n_graphs, 1)}
        else:
            b |= {"target": rnd(n, 1)}
    else:
        nc = cfg.n_coeff
        b |= {"x": rnd(n, cfg.d_in), "wigner": rnd(e, nc, nc) * 0.2,
              "labels": torch.randint(0, cfg.d_out, (n,), generator=g,
                                      device=device).int(),
              "label_mask": torch.ones(n, device=device)}
    return b


def sampled_batch(cfg, seed: int, device, smoke: bool) -> tuple[dict, str]:
    """GraphSAGE's minibatch_lg batch as the reference's layout describes
    it: ``fanout_sample`` of 1,024 seeds, fanout 15 then 10, on the CSR of a
    seeded graph of Reddit's size (232,965 nodes, 114,615,892 edges,
    degrees skewed), the seeds and both hops as one padded edge list;
    features seeded normals, the loss on the seeds.  Returns the batch and
    a line for the log."""
    import torch

    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.graphs.csr import build_csr
    from repro_torch.graphs.sampler import fanout_sample

    n_graph, e_graph, seeds, fan = ((4_000, 40_000, 32, [5, 3]) if smoke else
                                    (REDDIT_NODES, REDDIT_EDGES, 1024, [15, 10]))
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    w = rng.random(n_graph) ** 3
    src = np.repeat(np.arange(n_graph), rng.multinomial(e_graph, w / w.sum()))
    dst = rng.integers(0, n_graph, e_graph)
    indptr, indices = build_csr(src, dst, n_graph)
    del src, dst
    t1 = time.perf_counter()
    blocks = fanout_sample(indptr, indices, rng.choice(n_graph, seeds, replace=False),
                           fan, seed=seed)
    t2 = time.perf_counter()
    frontier = [blocks.seeds] + [nb.reshape(-1) for nb in blocks.nbr]
    nodes = np.concatenate(frontier)
    offs = np.cumsum([0] + [len(f) for f in frontier])
    e_src = np.concatenate([offs[h + 1] + np.arange(nb.size)
                            for h, nb in enumerate(blocks.nbr)])
    e_dst = np.concatenate([np.repeat(offs[h] + np.arange(nb.shape[0]), nb.shape[1])
                            for h, nb in enumerate(blocks.nbr)])
    e_mask = np.concatenate([m.reshape(-1) for m in blocks.nbr_mask])
    shp = GNN_SHAPES["minibatch_lg"]
    n_pad = len(nodes) if smoke else shp.n_nodes_pad
    e_pad = len(e_src) if smoke else shp.n_edges_pad
    pad = e_pad - len(e_src)
    g = torch.Generator(device=device).manual_seed(seed)
    feats = torch.randn((n_graph, cfg.d_in), generator=g, device=device)
    x = torch.zeros((n_pad, cfg.d_in), device=device)
    x[:len(nodes)] = feats[torch.as_tensor(nodes, device=device)]
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    batch = {"x": x,
             "edge_src": as_t(np.r_[e_src, np.zeros(pad, np.int64)]).int(),
             "edge_dst": as_t(np.r_[e_dst, np.zeros(pad, np.int64)]).int(),
             "edge_mask": as_t(np.r_[e_mask, np.zeros(pad, bool)]),
             "labels": torch.randint(0, cfg.n_classes, (n_pad,), generator=g,
                                     device=device).int(),
             "label_mask": (torch.arange(n_pad, device=device) < seeds).float()}
    line = (f"fanout_sample of {seeds} seeds, fanout {fan}, on a CSR of "
            f"{n_graph:,} nodes and {e_graph:,} edges (built in {t1 - t0:.4f} "
            f"s, sampled in {t2 - t1:.4f} s): {len(nodes):,} nodes and "
            f"{int(e_mask.sum()):,} live of {len(e_src):,} edges, padded to "
            f"{n_pad:,} x {e_pad:,}")
    return batch, line


def cut_shape(shp, n: int, e: int, share: float, smoke: bool):
    """The cell's shape with ``share`` of its ``n`` nodes and ``e`` edges
    (the cell's own, round budgets applied; multiples of 2,048); a CPU
    rehearsal takes at most 4,096 nodes and 16,384 edges."""
    import dataclasses

    if smoke:
        n, e = min(n, 4096), min(e, 16_384)
    if share < 1:
        n = max(2048, int(n * share) // 2048 * 2048)
        e = max(2048, int(e * share) // 2048 * 2048)
    return dataclasses.replace(shp, n_nodes=n, n_edges=e)


def cell_sizes(arch: str, cfg, shp) -> tuple[int, int]:
    """(nodes, edges) of the cell's abstract batch (the round budgets
    applied)."""
    from repro_torch.configs.registry import GNN_KEY, _gnn_batch

    batch, _ = _gnn_batch(GNN_KEY[arch], cfg, shp)
    return batch["x" if "x" in batch else "pos"].shape[0], batch["edge_src"].shape[0]


def train_three(tag: str, label: str, step, state, batch, device,
                flops: float, n_items: int, unit: str, falling: bool = True
                ) -> dict:
    """Three steps of ``step`` on one batch, the third under the profiler:
    the losses finite (and with ``falling``, falling), the first two
    steps' ms, items/s at the better one, ``flops / (step s x 67
    TFLOP/s)`` and the peak memory."""
    import torch

    losses, step_ms = [], []
    for i in range(3):
        sync(device)
        t0 = time.perf_counter()
        if i < 2:
            state, m = step(state, batch)
        else:
            box = {}

            def run():
                box["out"] = step(state, batch)
            if device.type == "cuda":
                profile(f"{label} step", run, device, top=6)
            else:
                run()
            state, m = box["out"]
        sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(not falling or losses[0] > losses[1] > losses[2],
          f"{label}: the loss does not fall over 3 steps on one batch: {losses}")
    best = min(step_ms[:2])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    log(f"[{tag}] {label}: losses {', '.join(f'{x:.6f}' for x in losses)} "
        f"({'falling' if falling else 'finite; not held to fall: OSCILLATES'}); "
        f"step ms {step_ms[0]:.4f}, {step_ms[1]:.4f} (the third under the "
        f"profiler: {step_ms[2]:.4f}); {n_items / best * 1e3:.4f} {unit}/s; "
        f"model_flops {flops:.6g}, {flops / (best / 1e3) / PEAK_FP32_SIMT:.4%} of "
        f"{PEAK_FP32_SIMT / 1e12:.0f} TFLOP/s fp32; peak memory "
        f"{peak / 2**30:.4f} GiB")
    return {"state": state, "losses": losses, "step_ms": best, "peak": peak}


def descent_check(label: str, loss_fn, params, batch) -> None:
    """The gradient points downhill at full width: a plain step of
    ``-eta g`` with ``eta = 1e-4 / max|g|`` (no entry moves by more than
    1e-4) lowers the loss, by about ``eta |g|**2``."""
    import torch

    from repro_torch.train.optimizer import leaves_as_tree, param_leaves

    l0, grads = tree_grads(loss_fn, params, batch)
    top = max(float(g.abs().max()) for g in grads.values())
    eta = 1e-4 / top
    with torch.no_grad():
        moved = leaves_as_tree({n: p.detach() - eta * grads[n] for n, p in
                                param_leaves(params).items()}, params)
        l1 = float(loss_fn(moved, batch))
    expect = eta * sum(float(torch.sum(g.float() ** 2)) for g in grads.values())
    check(np.isfinite(l1) and l1 < l0, f"{label}: a step down the gradient "
          f"moves the loss from {l0} to {l1}")
    log(f"[gnn] {label}: a step of -{eta:.3g} g (max|g| {top:.4g}) moves the "
        f"loss {l0:.6f} -> {l1:.6f} (first order: -{expect:.4g})")


def phase_gnn_smoke(device, seed: int) -> None:
    """Phase 21 (a): the four GNN archs' smoke configs through their
    ``molecule`` cell's step (float32) on a seeded graph of 1,024 nodes and
    8,192 edges (skewed destinations) on the card against the CPU port
    (``hold_steps``)."""
    import dataclasses

    from repro_torch.configs import list_cells
    from repro_torch.configs.registry import _GNN_INIT, _GNN_LOSS, GNN_KEY
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.distributed import Sharder

    shp = dataclasses.replace(GNN_SHAPES["molecule"], n_nodes=GNN_SMOKE_NODES,
                              n_edges=GNN_SMOKE_EDGES)
    for arch, key in GNN_KEY.items():
        cell = list_cells(arch, smoke=True)["molecule"]
        cfg = cell.config
        batch = gnn_batch(arch, cfg, shp, GNN_SMOKE_NODES, GNN_SMOKE_EDGES, seed,
                          "cpu")
        params = _GNN_INIT[key](cfg, seed=seed, device="cpu")
        loss_fn = lambda p, b, cfg=cfg, key=key: _GNN_LOSS[key](p, b, cfg)  # noqa: E731
        t0 = time.perf_counter()
        line = hold_steps(f"{arch} smoke", cell.make_step(Sharder(None)), loss_fn,
                          params, batch, device)
        log(f"[gnn] {arch} smoke (float32, molecule cell, {GNN_SMOKE_NODES:,} "
            f"nodes, {GNN_SMOKE_EDGES:,} edges) on {device} against the CPU "
            f"port in {time.perf_counter() - t0:.4f} s: {line}")


def phase_gnn_full(device, seed: int, smoke: bool) -> list[dict]:
    """Phase 21 (b): each cell of ``GNN_CELLS`` at the arch's full config
    (the smoke config in a CPU rehearsal): fresh seeded weights, one seeded
    batch (GraphSAGE's minibatch_lg through the fanout sampler), 3 steps
    of the cell's train step (``train_three``; DimeNet's losses are held
    finite and its gradient to ``descent_check``, ``OSCILLATES``).  A cell that runs out of card memory is retried at the
    next share of its nodes and edges in ``CUT_SHARES`` until it fits, and
    the cut is logged as reduced.  Returns one record per cell."""
    import torch

    from repro_torch.configs import list_cells
    from repro_torch.configs.registry import (
        _GNN_INIT,
        _GNN_LOSS,
        GNN_KEY,
        _gnn_flops,
    )
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.distributed import Sharder
    from repro_torch.train import TrainState, adamw_init

    out = []
    for arch, shape in GNN_CELLS:
        cell = list_cells(arch, smoke=smoke)[shape]
        cfg = cell.config
        shp = GNN_SHAPES[shape]
        n_full, e_full = cell_sizes(arch, cfg, shp)
        shares, rec = iter(CUT_SHARES), None
        t_cell = time.perf_counter()
        while rec is None:
            share = next(shares, None)
            check(share is not None, f"{arch}/{shape} does not fit at "
                  f"{CUT_SHARES[-1]} of its nodes and edges")
            cut = cut_shape(shp, n_full, e_full, share, smoke)
            n, e = cell_sizes(arch, cfg, cut)
            try:
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                if arch == "graphsage-reddit" and shape == "minibatch_lg":
                    batch, how = sampled_batch(cfg, seed, device, smoke)
                else:
                    batch = gnn_batch(arch, cfg, cut, n, e, seed, device)
                    how = f"{n:,} nodes, {e:,} edges"
                sync(device)
                made = time.perf_counter() - t0
                params = _GNN_INIT[GNN_KEY[arch]](cfg, seed=seed, device=device)
                oscillates = GNN_KEY[arch] in OSCILLATES
                if oscillates:
                    descent_check(f"{arch}/{shape}", lambda p, b, cfg=cfg, arch=arch:
                                  _GNN_LOSS[GNN_KEY[arch]](p, b, cfg), params, batch)
                state = TrainState(params, adamw_init(params), seed)
                flops = _gnn_flops(GNN_KEY[arch], cfg, cut)
                rec = train_three("gnn", f"{arch}/{shape}",
                                  cell.make_step(Sharder(None)), state, batch,
                                  device, flops, n, "nodes", falling=not oscillates)
            except torch.cuda.OutOfMemoryError:
                rec = None
            if rec is None:
                # out of the except block: its traceback no longer holds
                # the failed step's tensors
                batch = params = state = None
                log(f"[gnn] {arch}/{shape}: {n:,} nodes x {e:,} edges do not "
                    "fit one card")
        if (n, e) != (n_full, e_full) and not smoke:
            log(f"[gnn] reduced: {arch}/{shape} {n_full:,} nodes x {e_full:,} "
                f"edges -> {n:,} x {e:,} ({share:g}: the largest share of "
                f"{CUT_SHARES} that fits one 80 GB card; widths and depth as "
                "published)")
        log(f"[gnn] {arch}/{shape}: batch ({how}) made in {made:.4f} s; the "
            f"cell took {time.perf_counter() - t_cell:.4f} s in all")
        out.append({"cell": f"{arch}/{shape}", "nodes": n, "edges": e,
                    "share": share, "step_ms": rec["step_ms"], "peak": rec["peak"]})
        del rec, state, params, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def halo_inputs(arch: str, cfg, n: int, e: int, n_dev: int, seed: int, device):
    """A locality graph (destinations within 4 of their sources, a fifth
    anywhere), partitioned over ``n_dev`` devices with a halo budget that
    drops no edge: the gather batch and the halo batch as tensors on
    ``device``, and the budget.  EquiformerV2's Wigner inputs are seeded
    normals times 0.2 drawn on ``device``, each edge's in its receiver's
    edge slot."""
    import torch

    from repro_torch.configs.registry import GNN_KEY
    from repro_torch.graphs.halo import build_partitioned_batch

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-4, 5, e), 0, n - 1)
    dst = np.where(rng.random(e) < 0.2, rng.integers(0, n, e), dst)
    x = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
    n_cls = cfg.n_classes if hasattr(cfg, "n_classes") else cfg.d_out
    labels = rng.integers(0, n_cls, n)
    n_loc = -(-n // n_dev)
    so, do = np.minimum(src // n_loc, n_dev - 1), np.minimum(dst // n_loc, n_dev - 1)
    # the edges between two devices bound the sources one sends the other
    halo = int(np.bincount((so * n_dev + do)[so != do], minlength=n_dev * n_dev).max())
    pg = build_partitioned_batch(src, dst, x, labels, n_dev, halo=halo)
    check(int(pg.edge_mask.sum()) == e, "the halo budget dropped edges")
    put = lambda b: {k: torch.as_tensor(v, device=device) for k, v in b.items()}  # noqa: E731
    gather = put({"x": x, "edge_src": src, "edge_dst": dst, "labels": labels,
                  "label_mask": np.ones(n, np.float32)})
    halo_b = put(pg.device_batch())
    if GNN_KEY[arch] == "equiformer":
        nc = cfg.n_coeff
        g = torch.Generator(device=device).manual_seed(seed)
        wig = torch.randn((e, nc, nc), generator=g, device=device) * 0.2
        wig_p = torch.zeros((n_dev, pg.edge_src_ext.shape[1], nc, nc), device=device)
        for d in range(n_dev):
            mine = torch.as_tensor(np.flatnonzero(do == d), device=device)
            wig_p[d, :len(mine)] = wig[mine]
        gather["wigner"], halo_b["wigner"] = wig, wig_p
    return gather, halo_b, halo


def phase_halo(device, seed: int, smoke: bool) -> None:
    """Phase 21 (c): ``sage_loss_halo`` and ``eqv2_loss_halo`` at their full
    configs (``d_in`` 100, ogb_products' features) over a 2 x 4 ``("data",
    "model")`` mesh of ``[cuda:0] * 8`` (one shard per card round-robin
    where there are several) against the gather losses on the first card,
    within the reference's bounds (2e-5, 3e-5), forward only."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import gnn

    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    devs = [torch.device(device.type, i % cards) if device.type == "cuda"
            else device for i in range(8)]
    mesh = make_mesh((2, 4), ("data", "model"), devs)
    fns = {"graphsage-reddit": (gnn.init_sage, gnn.sage_loss, gnn.sage_loss_halo),
           "equiformer-v2": (gnn.init_eqv2, gnn.eqv2_loss, gnn.eqv2_loss_halo)}
    for arch, (init, loss, loss_halo) in fns.items():
        a = get_arch(arch)
        cfg = dataclasses.replace(a.smoke_config() if smoke else a.full_config(),
                                  d_in=16 if smoke else 100)
        n, e = (256, 2048) if smoke else HALO_SIZES[arch]
        t0 = time.perf_counter()
        gather, halo_b, halo = halo_inputs(arch, cfg, n, e, 8, seed, devs[0])
        sync(device)
        made = time.perf_counter() - t0
        params = init(cfg, seed=seed, device=devs[0])
        with torch.no_grad():
            t0 = time.perf_counter()
            lh = float(loss_halo(params, halo_b, cfg, mesh, ("data", "model")))
            sync(device)
            t_halo = time.perf_counter() - t0
            del halo_b
            t0 = time.perf_counter()
            lg = float(loss(params, gather, cfg))
            sync(device)
            t_gather = time.perf_counter() - t0
        check(np.isfinite(lh) and abs(lh - lg) < HALO_TOL[arch],
              f"{arch}: halo loss {lh} vs gather loss {lg} (bound {HALO_TOL[arch]})")
        log(f"[halo] {arch} (d {cfg.d_hidden}, {n:,} nodes, {e:,} edges, halo "
            f"{halo:,} rows a device pair, partitioned in {made:.4f} s) over "
            f"{len(set(map(str, devs)))} distinct device(s) as 8 shards: halo "
            f"loss {lh:.8f} ({t_halo:.4f} s) vs gather {lg:.8f} ({t_gather:.4f} "
            f"s), gap {abs(lh - lg):.3g} (bound {HALO_TOL[arch]})")
        if arch == "equiformer-v2" and not smoke:
            log(f"[halo] reduced: {arch} at {e:,} edges (GraphSAGE at "
                f"{HALO_SIZES['graphsage-reddit'][1]:,}): its gather loss "
                "holds [E, 49, 128] float32 stacks, 25.7 GB each at 2**20 edges")
        del params, gather
    if device.type == "cuda":
        torch.cuda.empty_cache()


def phase_gnn(device, seed: int, *, smoke: bool) -> list[dict]:
    """Phase 21: GNN training; (a) the smoke configs against the CPU port,
    (b) the cells at full width, (c) the halo losses."""
    phase_gnn_smoke(device, seed)
    cells = phase_gnn_full(device, seed, smoke)
    phase_halo(device, seed, smoke)
    return cells


def click_ids(cfg, b: int, gen, device):
    """``b`` rows of per-field ids, skewed (``floor(V u**3)``: hot rows, as
    Criteo's are)."""
    import torch

    u = torch.rand((b, cfg.n_sparse), generator=gen, device=device)
    return (cfg.vocab_per_field * u ** 3).long().clamp_(max=cfg.vocab_per_field - 1).int()


def serve_times(fn, device, reps: int) -> tuple[float, float]:
    """p50 and p99 ms of ``reps`` calls of ``fn`` (CUDA events each; the
    host clock on the CPU), after one warm-up call."""
    import torch

    fn()
    ms = []
    for _ in range(reps):
        if device.type == "cuda":
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def phase_xdeepfm(device, seed: int, *, smoke: bool) -> dict:
    """Phase 22: xDeepFM.  (a) The smoke config's train_batch step (float32,
    256 rows of skewed ids) on the card against the CPU port
    (``hold_steps``); serving and candidate scores (``chunk`` below the
    candidates) within rtol = atol = 1e-4.  (b) The full config (39 fields
    of 1,000,000 rows, CIN 200-200-200): 3 steps of train_batch on one
    seeded batch of 65,536 rows (the loss falling), then serve_p99 (512
    rows), serve_bulk (262,144 rows) and retrieval_cand (1,001,472
    candidates) through each cell's step: ms, rows/s, peak memory and
    ``model_flops / (s x 67 TFLOP/s)``."""
    import torch

    from repro_torch.configs import get_arch, list_cells
    from repro_torch.configs.registry import _xdfm_flops
    from repro_torch.configs.shapes import RECSYS_SHAPES, pad_to
    from repro_torch.distributed import Sharder
    from repro_torch.models.recsys import init_xdeepfm
    from repro_torch.models.recsys.xdeepfm import (
        xdeepfm_forward,
        xdeepfm_loss,
        xdeepfm_score_candidates,
    )
    from repro_torch.train import TrainState, adamw_init
    from repro_torch.train.optimizer import param_leaves

    # (a)
    scfg = get_arch("xdeepfm").smoke_config()
    cells = list_cells("xdeepfm", smoke=True)
    g = torch.Generator().manual_seed(seed)
    batch = {"ids": click_ids(scfg, 256, g, "cpu"),
             "clicks": (torch.rand(256, generator=g) < 0.25).float()}
    params = init_xdeepfm(scfg, seed=seed, device="cpu")
    line = hold_steps("xdeepfm smoke", cells["train_batch"].make_step(Sharder(None)),
                      lambda p, b: xdeepfm_loss(p, b, scfg), params, batch, device)
    card = tree_copy(params, device)
    ids = batch["ids"][:64]
    want = xdeepfm_forward(params, {"ids": ids}, scfg).detach()
    got = cells["serve_p99"].make_step(Sharder(None))(card, {"ids": ids.to(device)})
    err = float((got.cpu() - want).abs().max())
    check(bool(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)),
          f"xdeepfm smoke serve: card and CPU differ by {err}")
    cand = {"user_ids": ids[0, :3], "cand_ids": click_ids(scfg, 100, g, "cpu")[:, 3:]}
    with torch.no_grad():
        want = xdeepfm_score_candidates(params, cand, scfg, chunk=32)
        got = xdeepfm_score_candidates(card, {k: v.to(device) for k, v in cand.items()},
                                       scfg, chunk=32)
    err_c = float((got.cpu() - want).abs().max())
    check(bool(torch.allclose(got.cpu(), want, rtol=1e-4, atol=1e-4)),
          f"xdeepfm smoke retrieval: card and CPU differ by {err_c}")
    log(f"[xdeepfm] smoke (float32, 256 rows) on {device} against the CPU port: "
        f"{line}; serve max abs err {err:.3g}, candidate scores (100 in slabs of "
        f"32) {err_c:.3g}")
    del params, card

    # (b)
    arch = get_arch("xdeepfm")
    cfg = arch.smoke_config() if smoke else arch.full_config()
    cells = list_cells("xdeepfm", smoke=smoke)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params = init_xdeepfm(cfg, seed=seed, device=device)
    state = TrainState(params, adamw_init(params), seed)
    sync(device)
    n_params = sum(t.numel() for t in param_leaves(params).values())
    log(f"[xdeepfm] {cfg.n_sparse} fields x {cfg.vocab_per_field:,} rows, embed "
        f"{cfg.embed_dim}, CIN {cfg.cin_layers}, MLP {cfg.mlp_dims}: "
        f"{n_params:,} parameters and their float32 moments on {device} in "
        f"{time.perf_counter() - t0:.4f} s")
    g = torch.Generator(device=device).manual_seed(seed)
    # a CPU rehearsal takes at most 4,096 rows a cell
    rows = {name: min(b, 4096) if smoke else b
            for name, (b, _) in RECSYS_SHAPES.items()}
    b = rows["train_batch"]
    batch = {"ids": click_ids(cfg, b, g, device),
             "clicks": (torch.rand(b, generator=g, device=device) < 0.25).float()}
    rec = train_three("xdeepfm", "train_batch",
                      cells["train_batch"].make_step(Sharder(None)), state, batch,
                      device, _xdfm_flops(cfg, b, "train"), b, "rows")
    out = {"train_batch": rec["step_ms"]}
    params = rec["state"].params
    del rec, state, batch
    # retrieval joins 19 user fields onto each candidate, which the smoke
    # config's 8 fields cannot: a CPU rehearsal scores with 3
    n_user = 19 if cfg.n_sparse > 19 else 3
    for name in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cell = cells[name]
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        if name == "retrieval_cand":
            n = pad_to(rows[name])
            inp = {"user_ids": click_ids(cfg, 1, g, device)[0, :n_user],
                   "cand_ids": click_ids(cfg, n, g, device)[:, n_user:]}
            step = (cell.make_step(Sharder(None)) if n_user == 19 else
                    torch.no_grad()(lambda p, b: xdeepfm_score_candidates(p, b, cfg)))
        else:
            n = rows[name]
            inp = {"ids": click_ids(cfg, n, g, device)}
            step = cell.make_step(Sharder(None))
        scores = step(params, inp)
        check(scores.shape == (n,) and bool(torch.isfinite(scores).all())
              and not scores.requires_grad,
              f"xdeepfm/{name}: scores {tuple(scores.shape)} not finite")
        p50, p99 = serve_times(lambda: step(params, inp), device,
                               reps=50 if name == "serve_p99" else 3)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        flops = _xdfm_flops(cfg, n, cell.kind)
        log(f"[xdeepfm] {name} ({n:,} rows): p50 {p50:.4f} ms, p99 {p99:.4f} ms, "
            f"{n / p50 * 1e3:.4f} rows/s at p50; model_flops {flops:.6g}, "
            f"{flops / (p50 / 1e3) / PEAK_FP32_SIMT:.4%} of "
            f"{PEAK_FP32_SIMT / 1e12:.0f} TFLOP/s fp32; peak memory "
            f"{peak / 2**30:.4f} GiB")
        out[name] = p50
        if name == "serve_bulk" and device.type == "cuda":
            profile(f"xdeepfm/{name}", lambda: step(params, inp), device, top=6)
        del inp, scores
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


class PhaseClock:
    """Logs the wall time of each phase since the previous lap."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, label: str) -> None:
        now = time.perf_counter()
        log(f"[time] phase {label}: {now - self.t:.4f} s")
        self.t = now


def run(device, *, n_sgrs: int, n_unique: int, nt_w: int, seed: int,
        n_truth: int, dyn_records: int, dyn_nt_w: int, dyn_ids: int,
        lm_batch: int, lm_prompt: int, lm_gen: int, lm_smoke: bool = False,
        alpha0: float = 1.02, tenant_unique: int = 50_000,
        serve_batch: int = SERVE_BATCH) -> list[dict]:
    """Phases 0-22 on ``device``; returns the kernels records."""
    from repro_torch.configs import get_arch
    from repro_torch.core import WindowExecutor, windowize
    from repro_torch.kernels.build import load
    from repro_torch.kernels.butterfly.build import LIBRARY as BUTTERFLY
    from repro_torch.kernels.flash_attention.build import LIBRARY as FLASH
    from repro_torch.streams import bipartite_pa_stream, replay_dynamic

    if device.type == "cuda":
        # every source of both libraries compiles at once
        for what, info in zip(("K1, K2; K3 runs K1's kernel", "K4"),
                              load(BUTTERFLY, FLASH)):
            log(f"[setup] kernel library {info.path.name} ({what}): nvcc "
                + (f"{info.seconds:.4f} s, one process per source, all "
                   "started together" if info.seconds else
                   "skipped (built earlier from the same sources)"))
            if info.log:
                log(info.log.rstrip())
            for line in build_lines(info, k4_kernel_name if what == "K4"
                                    else butterfly_kernel_name):
                log(line)
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
    t0 = time.perf_counter()
    wins = replay_dynamic(stream.tau, stream.edge_i, stream.edge_j, nt_w=nt_w)
    mult = np.concatenate([w.mult for w in wins])
    log(f"[setup] multiset windows by replay_dynamic "
        f"({time.perf_counter() - t0:.4f} s): {len(wins)} windows of up to "
        f"{max(len(w.mult) for w in wins)} distinct edges; multiplicities up "
        f"to {int(mult.max())}, {np.mean(mult > 1):.4%} of the distinct edges "
        f"repeat")

    ex = WindowExecutor("pallas", device=device)
    clock = PhaseClock()
    kern1 = phase_kernel(wb, device, ex)
    clock.lap("1 kernel (K1)")
    replay, k1_launches, k1_routes = phase_replay(stream, wb, nt_w, alpha0,
                                                  device, ex, n_truth)
    clock.lap("2 replay")
    phase_stream(stream, nt_w, alpha0, device, replay)
    clock.lap("3 stream")
    seen: dict = {}
    k2_launches, k2_routes, multiset_counts = phase_multiset(
        stream, wins, nt_w, alpha0, device, seen)
    clock.lap("4 multiset")
    del wins
    kern2 = phase_kernel_k2(seen, device)
    clock.lap("1 kernel (K2)")
    del seen
    dyn_closed, dyn_oracle = phase_dynamic(
        device, n_records=dyn_records, nt_w=dyn_nt_w, n_ids=dyn_ids,
        seed=seed, alpha0=alpha0)
    clock.lap("5 dynamic")
    phase_tiers(wb, alpha0, device, replay.window_counts)
    clock.lap("6 tiers")
    kern3 = phase_k3(wb, replay.window_counts, device)
    clock.lap("7 K3")
    phase_profile(stream, wb, nt_w, alpha0, device, ex)
    clock.lap("8 profile")
    n11, r11 = phase_entries(stream, wb, nt_w, device, replay.window_counts,
                             dyn_closed, dyn_oracle)
    clock.lap("11 executor entries")
    fleets = phase_multistream(device, n_sgrs=n_sgrs // N_TENANTS,
                               n_unique=tenant_unique, nt_w=nt_w, seed=seed,
                               alpha0=alpha0)
    clock.lap("12 multi-tenant")
    phase_sampled(stream, wb, nt_w, device, replay.window_counts, alpha0)
    clock.lap("13 sampled")
    serving = phase_serving(device, fleets["tenants"], fleets, nt_w=nt_w,
                            alpha0=alpha0, batch=serve_batch)
    clock.lap("14 serving")
    phase_analysis(stream, wb, device, replay.window_counts)
    clock.lap("15 (a) analysis")
    k1_15, k2_15 = phase_sharded(stream, wb, nt_w, alpha0, device, replay,
                                 multiset_counts)
    clock.lap("15 (b) sharded executor")
    phase_ring(wb, device, replay.window_counts)
    clock.lap("15 (c) ring counter")
    k1_19 = phase_sgrapp_cells(device, seed, smoke=lm_smoke)
    clock.lap("19 sgrapp cells")
    # K1's and K2's launches on their paths, each with its routes as read
    # after its run: the replay, the entries, the fleets, the server and
    # the sharded executor for K1; the multiset stream, the fleets, the
    # server and the sharded executor for K2
    k1_launches += (n11 + fleets["K1"][0] + serving["K1"][0] + k1_15[0]
                    + k1_19[0])
    k1_routes = add_routes(k1_routes, r11, fleets["K1"][1], serving["K1"][1],
                           k1_15[1], k1_19[1])
    k2_launches += fleets["K2"][0] + serving["K2"][0] + k2_15[0]
    k2_routes = add_routes(k2_routes, fleets["K2"][1], serving["K2"][1],
                           k2_15[1])
    del stream, wb, ex, dyn_closed, dyn_oracle
    arch = get_arch(LM_ARCH)
    cfg = arch.smoke_config() if lm_smoke else arch.full_config()
    kern4 = phase_k4(device, seed, batch=lm_batch, seq=lm_prompt,
                     heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                     head_dim=cfg.head_dim, chunk=cfg.attn_chunk_q)
    mla_arch = get_arch("minicpm3-4b")
    mla = (mla_arch.smoke_config() if lm_smoke else mla_arch.full_config())
    kern4_mla = phase_k4_mla(
        device, seed, batch=lm_batch, seq=lm_prompt, heads=mla.n_heads,
        qk_dim=mla.mla.qk_nope_head_dim + mla.mla.qk_rope_head_dim,
        v_dim=mla.mla.v_head_dim, chunk=mla.attn_chunk_q)
    clock.lap("9 K4")
    served = phase_serve(device, seed, arch=LM_ARCH, smoke=lm_smoke,
                         batch=lm_batch, prompt=lm_prompt, gen=lm_gen)
    clock.lap("10 serve")
    # phases 16-18: the MLA and MoE archs; a CPU rehearsal serves their
    # smoke configs at the rehearsal's sizes
    k4_serve = {LM_ARCH: served}
    for number, (arch_id, depth, b, s_len, g) in enumerate(LM_CELLS, 16):
        if lm_smoke:
            depth, b, s_len, g = None, lm_batch, lm_prompt, lm_gen
        k4_serve[arch_id] = phase_serve(device, seed, arch=arch_id,
                                        smoke=lm_smoke, batch=b, prompt=s_len,
                                        gen=g, n_layers=depth)
        clock.lap(f"{number} serve {arch_id}")
    trained = phase_train(device, seed, smoke=lm_smoke)
    clock.lap("20 LM training")
    # phases 21-22 run none of K1-K4: their counts, set to 0 here, stay 0
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    kk.reset_launch_count()
    k4.reset_launch_count()
    phase_gnn(device, seed, smoke=lm_smoke)
    clock.lap("21 GNN training")
    phase_xdeepfm(device, seed, smoke=lm_smoke)
    clock.lap("22 xDeepFM")
    n_tpu = sum(kk.launch_count(k) for k in kk.KERNELS) + k4.launch_count()
    check(n_tpu == 0, f"phases 21-22 launched K1-K4 {n_tpu} times")
    log("[gnn] phases 21-22 launched none of K1-K4 (their counts stayed 0): "
        "segment sums, gathers and GEMMs are torch's own")
    k4_launches = {f"{a} (serve)": v["launches"] for a, v in k4_serve.items()}
    k4_launches[f"{LM_ARCH} (train, 3 steps)"] = trained["launches"]
    src = "src/repro_torch/kernels/butterfly/csrc/"
    ref = "src/repro/kernels/butterfly/butterfly_kernel.py:"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    k1_keys = keys + ("fp32_library_ms",)
    return [
        {"name": "butterfly_windows (K1: int8 wgmma tensor cores on u8 "
                 "operands fed by TMA, persistent triangle schedule, exact "
                 "integer sums)",
         "route": "cuda", "source": src + "butterfly_windows_wgmma.cu",
         "replaces": ref + "112", "launches": k1_launches,
         "routes": k1_routes,
         **{k: kern1[k] for k in k1_keys}},
        {"name": "butterfly_windows_multiset (K2: int8 wgmma tensor cores "
                 "on u8 limb planes of the multiplicities fed by TMA, "
                 "persistent triangle schedule, exact Grams and sums)",
         "route": "cuda",
         "source": src + "butterfly_windows_multiset_wgmma.cu",
         "replaces": ref + "191", "launches": k2_launches,
         "routes": k2_routes,
         **{k: kern2[k] for k in keys}},
        {"name": "butterfly_pairs (K3: K1's kernel at B = 1)",
         "route": "cuda", "source": src + "butterfly_windows_wgmma.cu",
         "replaces": ref + "43", "launches": kern3["launches"],
         "routes": kern3["routes"], **{k: kern3[k] for k in k1_keys}},
        {"name": "flash_attention (K4: bf16 wgmma tensor cores fed by TMA, "
                 "fp32 P as 3 bf16 limbs; float32 inputs on fp32 SIMT)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_wgmma.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_kernel.py:29",
         "launches": sum(k4_launches.values()),
         "launches_by_arch": k4_launches,
         **{k: kern4[k] for k in keys},
         "max_abs_err": max(kern4["max_abs_err"], kern4_mla["max_abs_err"],
                            *(v["max_abs_err"] for v in k4_serve.values())),
         "float32_simt_ms": kern4["float32_simt_ms"],
         "mla_shape": kern4_mla},
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sgrs", type=int, default=2_000_000)
    p.add_argument("--n-unique", type=int, default=400_000)
    p.add_argument("--nt-w", type=int, default=1600)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--truth-windows", type=int, default=8)
    p.add_argument("--dyn-records", type=int, default=60_000)
    p.add_argument("--dyn-nt-w", type=int, default=1500)
    p.add_argument("--dyn-ids", type=int, default=1024)
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
    kernels = run(torch.device("cuda"), n_sgrs=args.sgrs,
                  n_unique=args.n_unique, nt_w=args.nt_w, seed=args.seed,
                  n_truth=args.truth_windows, dyn_records=args.dyn_records,
                  dyn_nt_w=args.dyn_nt_w, dyn_ids=args.dyn_ids,
                  lm_batch=4, lm_prompt=4096, lm_gen=64)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.4f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
