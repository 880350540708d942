"""Training launcher, on the card unless ``--device cpu``.

Resolves ``--arch`` through the registry, restores the latest checkpoint
when ``--ckpt`` holds one, then runs the arch's train cell (the
microbatched train step) with asynchronous checkpoints, as the reference's
launcher (``repro.launch.train``) does:

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --steps 10 --device cpu

A checkpoint holds the reference's tree, ``(params, AdamWState(step, m,
v))`` with every layer leaf stacked on ``[L]``, so a checkpoint written by
either package's launcher restores in the other.  The parameters are drawn
from a torch generator seeded with ``--seed``, so they differ from the
reference's threefry draws; the batches are the reference's
(:func:`synth_batch`).  Only the LM family trains here: GNN and recsys
wait for ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..configs.registry import ShapeDtype
from ..device import resolve_device
from ..distributed.sharding import Sharder
from ..models.transformer import init_lm_params
from ..models.transformer.convert import named_to_reference, reference_to_named
from ..train.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from ..train.fault import StragglerPolicy
from ..train.optimizer import AdamWState, adamw_init
from ..train.train_state import TrainState

__all__ = ["synth_batch", "state_to_reference", "main"]

# the reference's archs whose family the port does not train yet
_WAITING = {"graphsage-reddit": "gnn", "graphcast": "gnn", "dimenet": "gnn",
            "equiformer-v2": "gnn", "xdeepfm": "recsys"}


def synth_batch(abstract, rng: np.random.Generator, device) -> dict:
    """Random concrete inputs for a batch spec tree of :class:`ShapeDtype`,
    with the reference's draws: integers in ``{0, 1}``, booleans all true,
    floats standard normal (float32 rounded to the dtype)."""
    def mk(s: ShapeDtype) -> torch.Tensor:
        if s.dtype == torch.bool:
            return torch.ones(s.shape, dtype=torch.bool, device=device)
        if not s.dtype.is_floating_point:
            return torch.as_tensor(rng.integers(0, 2, size=s.shape),
                                   device=device).to(s.dtype)
        return torch.as_tensor(rng.normal(size=s.shape).astype(np.float32),
                               device=device).to(s.dtype)
    return {k: mk(v) for k, v in abstract.items()}


def state_to_reference(state: TrainState) -> tuple:
    """``(params, AdamWState(step, m, v))`` in the reference's layout, numpy
    leaves: the tree a checkpoint holds."""
    cfg = state.params.cfg
    opt = state.opt
    return (named_to_reference(dict(state.params.named_parameters()), cfg),
            AdamWState(opt.step.detach().cpu().numpy(),
                       named_to_reference(opt.m, cfg),
                       named_to_reference(opt.v, cfg)))


def _template(tree):
    """A tree of :class:`ShapeDtype` -> the same tree of empty tensors of
    the leaves' dtypes (what ``restore_checkpoint`` reads of a template)."""
    if isinstance(tree, dict):
        return {k: _template(v) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_template(v) for v in tree))
    return torch.empty(0, dtype=tree.dtype)


def _restore(ckpt_dir: str, state: TrainState, state_abs: TrainState,
             device) -> tuple[TrainState, int]:
    template = (_template(state_abs.params), _template(state_abs.opt))
    (params, opt), extra = restore_checkpoint(ckpt_dir, template,
                                              device=device)
    cfg = state.params.cfg
    named = dict(state.params.named_parameters())
    with torch.no_grad():
        for name, t in reference_to_named(params, cfg, device).items():
            named[name].copy_(t)
    opt = AdamWState(opt.step.to(torch.int32),
                     reference_to_named(opt.m, cfg, device),
                     reference_to_named(opt.v, cfg, device))
    return TrainState(state.params, opt, state.rng), int(extra.get("step", 0))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="train shape (defaults to first train cell)")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt_every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch in _WAITING:
        raise SystemExit(f"training the {_WAITING[args.arch]} family "
                         f"({args.arch}) is not ported yet (ROADMAP Queue 1 "
                         "item 4)")
    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if arch.family != "lm":
        raise SystemExit(f"train launcher does not drive family {arch.family}")
    cfg = arch.smoke_config() if args.smoke else arch.full_config()
    cells = arch.cells(cfg)
    train_cells = {k: c for k, c in cells.items() if c.kind == "train"}
    if not train_cells:
        raise SystemExit(f"{args.arch} has no train cells")
    shape_name = args.shape or next(iter(train_cells))
    cell = train_cells[shape_name]
    if cell.config is not None:
        cfg = cell.config

    step = cell.make_step(Sharder(None))  # one device; pods pass a mesh
    policy = StragglerPolicy(checkpoint_every_steps=args.ckpt_every)

    rng = np.random.default_rng(args.seed)
    state_abs, batch_abs = cell.abstract_inputs()
    # smoke shapes: shrink the global batch dims so a small device can step
    if args.smoke:
        batch_abs = {k: ShapeDtype((min(s.shape[0], 64),) + s.shape[1:],
                                   s.dtype) for k, s in batch_abs.items()}

    params = init_lm_params(cfg, seed=args.seed, device=device)
    state = TrainState(params, adamw_init(params), args.seed)

    start = 0
    ckpt = AsyncCheckpointer(args.ckpt) if args.ckpt else None
    if args.ckpt and latest_step(args.ckpt) is not None:
        state, start = _restore(args.ckpt, state, state_abs, device)
        print(f"[train] restored step {start}", flush=True)

    t0 = time.perf_counter()
    metrics: dict = {}
    for i in range(start, args.steps):
        batch = synth_batch(batch_abs, rng, device)
        state, metrics = step(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"[train] step {i} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        if ckpt and (i + 1) % policy.checkpoint_every_steps == 0:
            ckpt.save(i + 1, state_to_reference(state), extra={"step": i + 1})
    if ckpt:
        ckpt.wait()
    dt = time.perf_counter() - t0
    print(f"[train] done: {args.steps - start} steps in {dt:.1f}s", flush=True)
    return {"start": start, "state": state, "metrics": metrics}


if __name__ == "__main__":
    main()
