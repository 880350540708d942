"""Training launcher, on the card unless ``--device cpu``.

Resolves ``--arch`` through the registry, restores the latest checkpoint
when ``--ckpt`` holds one, then runs the arch's train cell (the
microbatched train step) with asynchronous checkpoints, as the reference's
launcher (``repro.launch.train``) does:

    PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \\
        --smoke --steps 10 --device cpu

Every family with a train cell trains: the LMs, the GNNs and xDeepFM
(``--arch graphsage-reddit``, ``graphcast``, ``dimenet``,
``equiformer-v2``, ``xdeepfm``).  A checkpoint holds the reference's tree,
``(params, AdamWState(step, m, v))`` with every layer leaf stacked on
``[L]`` (a GNN's or xDeepFM's parameters are that tree already), so a
checkpoint written by either package's launcher restores in the other.
The parameters are drawn from a torch generator seeded with ``--seed``, so
they differ from the reference's threefry draws; the batches are the
reference's (:func:`synth_batch`).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch import nn

from ..arrays import tensor_to_numpy
from ..configs import get_arch, registry
from ..configs.registry import ShapeDtype
from ..device import resolve_device
from ..distributed.sharding import Sharder
from ..models.recsys import init_xdeepfm
from ..models.transformer import init_lm_params
from ..models.transformer.convert import named_to_reference, reference_to_named
from ..train.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    tree_map,
)
from ..train.fault import StragglerPolicy
from ..train.optimizer import AdamWState, adamw_init, leaves_as_tree, param_leaves
from ..train.train_state import TrainState

__all__ = ["synth_batch", "state_to_reference", "main"]


def synth_batch(abstract, rng: np.random.Generator, device) -> dict:
    """Random concrete inputs for a batch spec dict of :class:`ShapeDtype`,
    with the reference's draws in its order (``jax.tree.map``'s: keys
    sorted): integers in ``{0, 1}``, booleans all true, floats standard
    normal (float32 rounded to the dtype)."""
    def mk(s: ShapeDtype) -> torch.Tensor:
        if s.dtype == torch.bool:
            return torch.ones(s.shape, dtype=torch.bool, device=device)
        if not s.dtype.is_floating_point:
            return torch.as_tensor(rng.integers(0, 2, size=s.shape),
                                   device=device).to(s.dtype)
        return torch.as_tensor(rng.normal(size=s.shape).astype(np.float32),
                               device=device).to(s.dtype)
    return {k: mk(abstract[k]) for k in sorted(abstract)}


def state_to_reference(state: TrainState) -> tuple:
    """``(params, AdamWState(step, m, v))`` in the reference's layout, numpy
    leaves: the tree a checkpoint holds.  An LM's parameters are a module
    (its layers stacked on ``[L]`` here); a GNN's or xDeepFM's are the
    reference's tree already, and their moments (keyed by leaf name) are
    put back in its structure."""
    opt = state.opt
    step = opt.step.detach().cpu().numpy()
    if isinstance(state.params, nn.Module):
        cfg = state.params.cfg
        return (named_to_reference(dict(state.params.named_parameters()), cfg),
                AdamWState(step, named_to_reference(opt.m, cfg),
                           named_to_reference(opt.v, cfg)))
    like = state.params
    return (tree_map(tensor_to_numpy, like),
            AdamWState(step, tree_map(tensor_to_numpy, leaves_as_tree(opt.m, like)),
                       tree_map(tensor_to_numpy, leaves_as_tree(opt.v, like))))


def _template(tree):
    """A tree of :class:`ShapeDtype` -> the same tree of empty tensors of
    the leaves' dtypes (what ``restore_checkpoint`` reads of a template)."""
    return tree_map(lambda s: torch.empty(0, dtype=s.dtype), tree)


def _restore(ckpt_dir: str, state: TrainState, state_abs: TrainState,
             device) -> tuple[TrainState, int]:
    """The checkpoint's parameters copied into ``state``'s in place, and its
    moments and step as the optimizer state."""
    template = (_template(state_abs.params), _template(state_abs.opt))
    (params, opt), extra = restore_checkpoint(ckpt_dir, template,
                                              device=device)
    if isinstance(state.params, nn.Module):
        cfg = state.params.cfg
        src = reference_to_named(params, cfg, device)
        m = reference_to_named(opt.m, cfg, device)
        v = reference_to_named(opt.v, cfg, device)
    else:
        src, m, v = (param_leaves(t) for t in (params, opt.m, opt.v))
    with torch.no_grad():
        for name, p in param_leaves(state.params).items():
            p.copy_(src[name])
    opt = AdamWState(opt.step.to(torch.int32), m, v)
    return TrainState(state.params, opt, state.rng), int(extra.get("step", 0))


def init_params(arch, cfg, seed: int, device):
    """Fresh parameters of ``arch``'s family: an LM module, or a GNN's or
    xDeepFM's tree, drawn from a generator seeded with ``seed``."""
    if arch.family == "lm":
        return init_lm_params(cfg, seed=seed, device=device)
    if arch.family == "gnn":
        return registry._GNN_INIT[registry.GNN_KEY[arch.arch_id]](cfg, seed=seed,
                                                          device=device)
    if arch.family == "recsys":
        return init_xdeepfm(cfg, seed=seed, device=device)
    raise SystemExit(f"train launcher does not drive family {arch.family}")


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

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
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

    params = init_params(arch, cfg, args.seed, device)
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
