"""Dry-run of the registry's cells on the production and tiny meshes (the
port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's jitted step for 512
placeholder host devices and reads XLA's memory and cost analyses.  The
port has no compiler to ask: it traces the cell's step once, as the
sharded code runs it, on a mesh of ``meta`` positions (shapes and dtypes,
no memory, no work) under the cost model of :mod:`.hlo_cost`, with the
inputs of ``abstract_inputs()`` placed on the positions by
``in_shardings``.  It never sets up a process group and never touches a
card, so it runs on a machine without one.

Per cell it prints and records, in ``<out>/<mesh>/<arch>__<shape>.json``:

  memory       the busiest position's (largest total): its shards of the
               inputs (``argument_size_bytes``), the outputs its ops made
               (``output_size_bytes``), its peak of live bytes during the
               step past those (``temp_size_bytes``); no generated code
  cost         the step's flops and bytes accessed over the whole mesh
  collectives  the bytes moved between positions over the whole mesh, by
               kind
  hlo          the cost model's per-device figures (the busiest position)
               with the mesh's totals beside them
  trace_s      the trace's wall time, in place of ``lower_s`` / ``compile_s``

A cell whose step raises is recorded as ``"error"`` with its message.  The
LMs' prefill, decode and train cells trace over the mesh
(``models.transformer.sharded``, ``.sharded_train``), K4 counted through
``note_kernel``; so do the GNNs' train cells (``models.gnn.sharded``: the
batch's whole ``meta`` arrays laid out over ``"flat"`` by the loss, one
microbatch, each layer's gathers and segment partials at every position;
their moves are ``sharded.predicted_moves``) and xDeepFM's train, serve
and retrieval cells (``models.recsys.sharded``: the tables' lookups
all-reduced over "model", the CIN and the MLP at every position on its
group's rows, one microbatch; their moves are that module's
``predicted_moves``).  A train step's state (the donated input) reaches it
placed by ``in_shardings`` as ``ShardedTensor`` leaves, and its backward's
work counts where its forward ran.  Tracing all of ``train_4k``'s
microbatches (forward, recompute and backward of each, every layer at
every position) would take many times a prefill's trace, so the trace
runs the first microbatch and the optimizer
(``train.loop.traced_microbatches``) and scales the microbatch's flops,
bytes, moves and kernels by the number of microbatches (the step's stage
marks; ``hlo_cost.CostModel.scale``): every microbatch has the same shapes
and does the same work.  The record says so under ``microbatches``; the
memory is the traced run's (one microbatch's peak is every one's).  So,
too, for the LMs' layers: the reference's trunk is one ``scan`` over
stacked layers of one shape, compiled once, and the trace runs the first
:data:`TRACED_LAYERS` of them (``train.loop.traced_layers``) and counts one
middle layer's forward, recompute and backward, flops, bytes, moves,
kernels, ops and live bytes, for each layer it does not run
(``sharded_train.SCALED_LAYER``, ``hlo_cost.CostModel.repeat``): the
record equals the trace of every layer field for field but ``trace_s``,
and says so under ``layers``.
A cell's donated inputs (decode's cache) reach the step placed by
``in_shardings``, as ``ShardedTensor`` leaves, as the step would receive
them from the prefill that filled them.  The cache's ``len`` has no value
on ``meta``: the trace takes one stand-in, the last slot (``max_len - 1``,
the step with the most positions to attend), and the record says so under
``cache_len``.

The reference's ``collective_bytes`` has no counterpart: it sums the
result bytes of the collectives in XLA's HLO text, which a torch step does
not have.  The record's ``collectives`` come from the moves the sharded
code reports to the cost model (``CostModel.collectives``), in the same
``{kind: bytes, "total": ...}`` form.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sgrapp \\
      --shape win_8k --mesh tiny --out experiments/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch sgrapp --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b \\
      --shape prefill_32k --mesh tiny
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm3-4b \\
      --shape decode_32k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch graphcast \\
      --mesh tiny_multipod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xdeepfm --mesh pod
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCHS, get_arch
from ..configs.registry import ShapeDtype
from ..distributed.sharding import Sharder, put_tree
from ..train.loop import traced_layers, traced_microbatches
from .hlo_cost import traced
from .mesh import make_production_mesh, make_tiny_mesh

__all__ = ["MESHES", "all_cells", "main", "make_meta_mesh", "run_cell"]

MESHES = ("pod", "multipod", "tiny", "tiny_multipod")
# the microbatches of a train step that a trace runs (scaled to all)
TRACED_MICROBATCHES = 1
# the layers of an LM's trunk that a train trace runs (one scaled to the
# rest); None runs every layer
TRACED_LAYERS = 3


def make_meta_mesh(kind: str):
    """The mesh ``kind`` (one of :data:`MESHES`) of ``meta`` positions."""
    multi = kind.endswith("multipod")
    if kind.startswith("tiny"):
        return make_tiny_mesh(multi_pod=multi, devices=["meta"] * 8)
    return make_production_mesh(multi_pod=multi,
                                devices=["meta"] * (512 if multi else 256))


def _leaves(tree, shardings) -> list:
    """(leaf, its sharding) pairs of two trees of one structure, in
    order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], shardings[k])]
    if isinstance(tree, (list, tuple)):
        return [x for a, s in zip(tree, shardings) for x in _leaves(a, s)]
    return [(tree, shardings)]


def _materialize(tree):
    """``ShapeDtype`` leaves -> empty ``meta`` tensors, in the same tree."""
    if isinstance(tree, ShapeDtype):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(_materialize(v) for v in tree))
    return type(tree)(_materialize(v) for v in tree)


def _argument_bytes(inputs, in_sh, n: int) -> list[int]:
    """Each position's bytes of the inputs' shards, as ``in_shardings``
    places them (split as GSPMD splits an array whose rows do not
    divide)."""
    per = [0] * n
    for x, sharding in _leaves(inputs, in_sh):
        for p, shard in enumerate(sharding.fitted(x.shape).place(x)):
            per[p] += shard.nbytes
    return per


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: str,
             *, force: bool = False) -> dict:
    os.makedirs(os.path.join(out_dir, mesh_kind), exist_ok=True)
    out_path = os.path.join(out_dir, mesh_kind, f"{arch_id}__{shape_name}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    arch = get_arch(arch_id)
    cfg = arch.full_config()
    cell = arch.cells(cfg)[shape_name]
    rec = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
        "kind": cell.kind, "model_flops": cell.model_flops, "status": None,
    }
    if cell.skip:
        rec["status"] = "skipped"
        rec["reason"] = cell.skip
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[dryrun] {arch_id}/{shape_name}@{mesh_kind}: SKIPPED ({cell.skip})")
        return rec

    t0 = time.perf_counter()
    try:
        mesh = make_meta_mesh(mesh_kind)
        shard = Sharder.for_mesh(mesh)
        step = cell.make_step(shard)
        abstract = cell.abstract_inputs()
        in_sh = cell.in_shardings(shard)
        inputs = _materialize(abstract)
        args = _argument_bytes(inputs, in_sh, mesh.size)
        inputs = tuple(put_tree(x, in_sh[i]) if i in cell.donate else x
                       for i, x in enumerate(inputs))
        n_micro = getattr(step, "n_microbatches", 1)
        runs = min(n_micro, TRACED_MICROBATCHES)
        with traced(mesh.size) as model, traced_microbatches(runs), \
                traced_layers(TRACED_LAYERS) as scaled:
            out = step(*inputs)
        t_trace = time.perf_counter() - t0
        if cell.kind == "train":
            model.scale("microbatches", "optimizer", n_micro / runs)
            rec["microbatches"] = {
                "n_microbatches": n_micro, "traced": runs,
                "scaled_by": n_micro / runs,
                "why": "each microbatch has the same shapes and work: the "
                       "traced ones' flops, bytes, moves and kernels are "
                       "scaled to all; the memory is the traced run's"}
        if scaled:
            rec["layers"] = {
                **scaled, "scaled_by": scaled["n_layers"] - scaled["traced"]
                + 1,
                "why": "the trunk's layers have the same shapes and work, as "
                       "the reference's one scan over stacked layers: a "
                       "middle layer's forward, recompute and backward, "
                       "its live bytes included, are counted for each layer "
                       "not traced"}
        summary = model.summary()
        if cell.kind == "decode":
            rec["cache_len"] = {
                "stand_in": out[1]["len"] - 1,
                "why": "len has no value on meta: the last slot, max_len - "
                       "1, the step with the most positions to attend"}
        rec.update(
            status="ok",
            trace_s=round(t_trace, 4),
            n_devices=mesh.size,
            memory=model.memory(args, out),
            cost={"flops": summary["mesh"]["flops"],
                  "bytes accessed": summary["mesh"]["bytes"]},
            collectives=summary["mesh"]["collectives"],
            hlo=summary,
        )
        print(f"[dryrun] {arch_id}/{shape_name}@{mesh_kind}: OK "
              f"(trace {t_trace:.1f}s on {mesh.size} meta positions)")
        print(f"  memory_analysis: {rec['memory']}")
        print(f"  cost_analysis: flops={rec['cost']['flops']} "
              f"bytes accessed={rec['cost']['bytes accessed']}")
        print(f"  collectives: {rec['collectives']}")
    except Exception as e:  # record failures, as the reference's does
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch_id}/{shape_name}@{mesh_kind}: FAILED {rec['error'][:200]}")
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch_id, arch in ARCHS.items():
        cfg = arch.full_config()
        for shape_name in arch.cells(cfg):
            out.append((arch_id, shape_name))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=list(MESHES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    else:
        if not args.arch:
            raise SystemExit("--arch required (or --all)")
        if args.shape:
            cells = [(args.arch, args.shape)]
        else:
            cells = [(args.arch, s) for a, s in all_cells() if a == args.arch]

    ok = err = skip = 0
    for arch_id, shape_name in cells:
        rec = run_cell(arch_id, shape_name, args.mesh, args.out, force=args.force)
        ok += rec["status"] == "ok"
        err += rec["status"] == "error"
        skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {ok} ok, {skip} skipped, {err} failed")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
