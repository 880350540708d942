"""Arch x shape cell registry (the port of ``repro.configs.registry``):
``--arch <id>`` in the launchers resolves through :data:`ARCHS`, and an
arch's cells are what a benchmark or a smoke run iterates.

A :class:`Cell` packages a step factory bound to a
:class:`~repro_torch.distributed.Sharder`, abstract input specs (trees of
:class:`ShapeDtype` records, allocating nothing), matching logical-axis
specs and the analytic ``model_flops``.  ``skip`` marks the cells the
reference defines but does not run (``long_500k`` on full-attention
archs).  The port has the LM and ``sgrapp`` families; GNN and recsys wait
for ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.sharding import Sharder
from ..models.transformer import LMConfig, decode_step, lm_loss, prefill
from ..models.transformer.model import (
    cache_shapes,
    cache_specs,
    lm_param_specs,
    param_shapes,
)
from ..train.loop import make_train_step
from ..train.optimizer import AdamWState
from ..train.train_state import TrainState
from .shapes import LM_SHAPES

__all__ = ["Arch", "ARCHS", "Cell", "ShapeDtype", "get_arch", "list_cells",
           "lm_cells", "register", "sd", "sgrapp_cells", "window_counter",
           "STACK_BYTES"]

F32, I32, BOOL = torch.float32, torch.int32, torch.bool

# the uint8 stack one chunk of an sgrapp window cell builds at once
STACK_BYTES = 1 << 32


@dataclass(frozen=True)
class ShapeDtype:
    """An abstract array: a shape and a torch dtype, no storage (the
    reference's ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def sd(shape, dtype=F32) -> ShapeDtype:
    return ShapeDtype(tuple(shape), dtype)


@dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str                                   # train|prefill|decode|serve|retrieval|stream
    make_step: Callable[..., Callable]
    abstract_inputs: Callable[[], tuple]
    logical_specs: Callable[[], tuple]          # mirrors abstract_inputs, leaves=tuples
    model_flops: float = 0.0
    skip: str | None = None
    make_concrete_inputs: Callable[..., tuple] | None = None  # smoke path
    donate: tuple = ()                          # donated arg indices (state/cache aliasing)
    logical_out_specs: Callable[[], Any] | None = None
    config: Any = None                          # per-cell (shape-adapted) config

    @property
    def name(self) -> str:
        return f"{self.arch_id}/{self.shape_name}"

    @staticmethod
    def _resolve(shard: Sharder, tree):
        if isinstance(tree, tuple) and all(a is None or isinstance(a, str)
                                           for a in tree):
            return shard.named(*tree)
        if isinstance(tree, dict):
            return {k: Cell._resolve(shard, v) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
            return type(tree)(*(Cell._resolve(shard, v) for v in tree))
        return type(tree)(Cell._resolve(shard, v) for v in tree)

    def in_shardings(self, shard: Sharder):
        if shard.mesh is None:
            return None
        return self._resolve(shard, self.logical_specs())

    def out_shardings(self, shard: Sharder):
        if shard.mesh is None or self.logical_out_specs is None:
            return None
        return self._resolve(shard, self.logical_out_specs())


@dataclass
class Arch:
    arch_id: str
    family: str
    full_config: Callable[[], Any]
    smoke_config: Callable[[], Any]
    cells: Callable[[Any], dict]                # config -> {shape: Cell}
    notes: str = ""


ARCHS: dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    ARCHS[arch.arch_id] = arch
    return arch


def get_arch(arch_id: str) -> Arch:
    return ARCHS[arch_id]


def list_cells(arch_id: str, *, smoke: bool = False) -> dict:
    a = get_arch(arch_id)
    cfg = a.smoke_config() if smoke else a.full_config()
    return a.cells(cfg)


def _no_mesh(shard: Sharder) -> None:
    if shard.mesh is not None:
        raise NotImplementedError(
            "an LM step over a mesh is not ported yet (ROADMAP Queue 1 item 3)")


# ===========================================================================
# LM family
# ===========================================================================

def _abstract(tree):
    """``(shape, dtype)`` pairs -> :class:`ShapeDtype` records."""
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    return sd(*tree)


def _lm_state_shapes(cfg: LMConfig) -> TrainState:
    p = _abstract(param_shapes(cfg))

    def moments(t):
        if isinstance(t, dict):
            return {k: moments(v) for k, v in t.items()}
        return sd(t.shape, F32)
    return TrainState(p, AdamWState(sd((), I32), moments(p), moments(p)),
                      sd((2,), torch.uint32))


def _lm_state_specs(cfg: LMConfig) -> TrainState:
    ps = lm_param_specs(cfg)
    return TrainState(ps, AdamWState((), lm_param_specs(cfg),
                                     lm_param_specs(cfg)), ())


def _lm_flops(cfg: LMConfig, tokens: int, kind: str) -> float:
    n = cfg.active_param_count()
    return (6.0 if kind == "train" else 2.0) * n * tokens


def lm_cells(cfg: LMConfig, *, n_microbatches: int = 8,
             sub_quadratic: bool = False) -> dict:
    cells = {}
    for shape_name, (S, B, kind) in LM_SHAPES.items():
        skip = None
        if shape_name == "long_500k" and not sub_quadratic:
            skip = "full-attention arch: 500k decode requires sub-quadratic attention (DESIGN.md)"

        if kind == "train":
            def make_step(shard, cfg=cfg, nm=n_microbatches):
                loss = lambda p, b: lm_loss(p, b, cfg, shard)
                return make_train_step(loss, n_microbatches=nm)

            def abstract_inputs(cfg=cfg, S=S, B=B):
                return (_lm_state_shapes(cfg),
                        {"tokens": sd((B, S), I32), "labels": sd((B, S), I32)})

            def logical_specs(cfg=cfg):
                return (_lm_state_specs(cfg),
                        {"tokens": ("batch", None), "labels": ("batch", None)})

            out_specs = None
            flops = _lm_flops(cfg, S * B, "train")
        elif kind == "prefill":
            def make_step(shard, cfg=cfg, S=S):
                _no_mesh(shard)
                return lambda p, toks: prefill(p, toks, cfg, S)

            def abstract_inputs(cfg=cfg, S=S, B=B):
                return (_abstract(param_shapes(cfg)), sd((B, S), I32))

            def logical_specs(cfg=cfg):
                return (lm_param_specs(cfg), ("batch", None))

            def out_specs(cfg=cfg):
                # (last-token logits, KV cache): the cache leaves the step
                # sharded (seq over 'model'), never replicated
                return (("batch", "model"), cache_specs(cfg))

            flops = _lm_flops(cfg, S * B, "prefill")
        else:  # decode
            def make_step(shard, cfg=cfg):
                _no_mesh(shard)
                return lambda p, cache, toks: decode_step(p, cache, toks, cfg)

            def abstract_inputs(cfg=cfg, S=S, B=B):
                return (_abstract(param_shapes(cfg)),
                        _abstract(cache_shapes(cfg, B, S)), sd((B,), I32))

            def logical_specs(cfg=cfg):
                return (lm_param_specs(cfg), cache_specs(cfg), (None,))

            def out_specs(cfg=cfg):
                return (("batch", "model"), cache_specs(cfg))

            flops = _lm_flops(cfg, B, "decode")

        donate = (0,) if kind == "train" else ((1,) if kind == "decode" else ())
        cells[shape_name] = Cell(
            cfg.name, shape_name, kind, make_step, abstract_inputs,
            logical_specs, flops, skip, donate=donate,
            logical_out_specs=out_specs)
    return cells


# ===========================================================================
# sGrapp (the paper's workload as cells)
# ===========================================================================

def window_counter(n_i: int, n_j: int, device=None) -> Callable:
    """``(edge_i, edge_j, valid) [W, cap] -> [W]`` float32 exact window
    counts on ``device`` (default ``cuda``): each chunk of windows whose
    uint8 stack fits :data:`STACK_BYTES` is scattered oriented
    (``ops.oriented_biadjacency``) and counted by one launch of K1
    (``ops.butterfly_count_pallas_windows``; its plain version on the
    CPU)."""
    from ..kernels.butterfly.ops import (
        butterfly_count_pallas_windows,
        oriented_biadjacency,
    )
    dev = resolve_device(device)
    per = max(1, STACK_BYTES // max(1, n_i * n_j))

    def counts(edge_i, edge_j, valid) -> torch.Tensor:
        ei, ej, v = (torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x for x in (edge_i, edge_j, valid))
        ei, ej, v = ei.to(dev), ej.to(dev), v.to(dev, torch.bool)
        out = []
        for w0 in range(0, ei.shape[0], per):
            adj = oriented_biadjacency(ei[w0:w0 + per], ej[w0:w0 + per],
                                       v[w0:w0 + per], n_i, n_j)
            out.append(butterfly_count_pallas_windows(adj))
            del adj
        return torch.cat(out) if out else torch.zeros(0, device=dev)
    return counts


def sgrapp_cells(cfg: dict) -> dict:
    """cfg: ``{"name": ..., "shapes": {...}}`` (see ``sgrapp_paper.py``).
    A cell's ``make_step(shard, device=None)`` counts on ``device`` without
    a mesh (:func:`window_counter`) and over ``shard.mesh`` with one
    (``core.distributed.make_distributed_window_counter``)."""
    from ..core.sgrapp import sgrapp_x_estimate

    cells = {}
    for shape_name, (W, cap, n_i, n_j) in cfg["shapes"].items():
        if shape_name.startswith("win"):
            def make_step(shard, device=None, n_i=n_i, n_j=n_j):
                if shard.mesh is not None:
                    from ..core.distributed import make_distributed_window_counter
                    return make_distributed_window_counter(
                        n_i, n_j, shard.mesh,
                        window_axis=shard.data_axes if len(shard.data_axes) > 1
                        else shard.data_axes[0],
                        gram_axis=shard.model_axis)
                return window_counter(n_i, n_j, device)

            def abstract_inputs(W=W, cap=cap):
                return (sd((W, cap), I32), sd((W, cap), I32), sd((W, cap), BOOL))

            def logical_specs():
                return (("batch", None), ("batch", None), ("batch", None))
        else:  # estimator: counts + sGrapp-x scan
            def make_step(shard, device=None, n_i=n_i, n_j=n_j):
                # as the reference's, the scan counts each window whole
                # whatever the mesh
                counter = window_counter(n_i, n_j, device)

                def step(ei, ej, v, cum_edges, truths, tmask, alpha0):
                    counts = counter(ei, ej, v)
                    return sgrapp_x_estimate(counts, cum_edges, alpha0, truths,
                                             tmask, device=counts.device)
                return step

            def abstract_inputs(W=W, cap=cap):
                return (sd((W, cap), I32), sd((W, cap), I32), sd((W, cap), BOOL),
                        sd((W,)), sd((W,)), sd((W,), BOOL), sd((), F32))

            def logical_specs():
                return (("batch", None), ("batch", None), ("batch", None),
                        (None,), (None,), (None,), ())

        # Gram flops: W * n_i^2 * n_j MACs (upper triangle halves it)
        flops = W * n_i * n_i * n_j
        cells[shape_name] = Cell(cfg["name"], shape_name, "stream", make_step,
                                 abstract_inputs, logical_specs, flops)
    return cells
