"""Arch x shape cell registry (the port of ``repro.configs.registry``):
``--arch <id>`` in the launchers resolves through :data:`ARCHS`, and an
arch's cells are what a benchmark or a smoke run iterates.

A :class:`Cell` packages a step factory bound to a
:class:`~repro_torch.distributed.Sharder`, abstract input specs (trees of
:class:`ShapeDtype` records, allocating nothing), matching logical-axis
specs and the analytic ``model_flops``.  ``skip`` marks the cells the
reference defines but does not run (``long_500k`` on full-attention
archs).  The port has every family of the reference: the LMs, the GNNs
(``gnn_cells``), xDeepFM (``xdeepfm_cells``) and ``sgrapp``.  Abstract
parameter trees come from each model's ``init_*`` on the ``meta`` device,
which allocates nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.sharding import Sharder
from ..models.gnn import (
    dimenet_loss,
    eqv2_loss,
    graphcast_loss,
    init_dimenet,
    init_eqv2,
    init_graphcast,
    init_sage,
    sage_loss,
)
from ..models.recsys import XDeepFMConfig, init_xdeepfm
from ..models.recsys.xdeepfm import (
    xdeepfm_forward,
    xdeepfm_loss,
    xdeepfm_param_specs,
    xdeepfm_score_candidates,
)
from ..models.transformer import LMConfig, decode_step, lm_loss, prefill
from ..models.transformer.model import (
    cache_shapes,
    cache_specs,
    lm_param_specs,
    param_shapes,
)
from ..train.checkpoint import tree_map
from ..train.loop import make_train_step
from ..train.optimizer import AdamWState
from ..train.train_state import TrainState
from .shapes import (
    EQV2_EDGE_BUDGET,
    GNN_ROUND_BUDGET,
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    TRIPLET_BUDGET,
    pad_to,
)

__all__ = ["Arch", "ARCHS", "Cell", "ShapeDtype", "get_arch", "list_cells",
           "GNN_KEY", "gnn_cells", "lm_cells", "register", "sd", "sgrapp_cells",
           "window_counter", "xdeepfm_cells", "STACK_BYTES"]

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


def _no_mesh(shard: Sharder, what: str = "an LM step") -> None:
    if shard.mesh is not None:
        raise NotImplementedError(
            f"{what} over a mesh is not ported yet (ROADMAP Queue 1 item 3)")


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
# GNN family
# ===========================================================================

def _param_shapes(init_fn, cfg):
    """The tree ``init_fn`` draws, as :class:`ShapeDtype` records (drawn on
    ``meta``: nothing allocated)."""
    return tree_map(lambda t: sd(t.shape, t.dtype), init_fn(cfg, device="meta"))


def _train_state_shapes(init_fn, cfg) -> TrainState:
    """``TrainState(params, AdamWState(step, m, v), key)`` as the reference's
    ``jax.eval_shape`` gives it: float32 moments, an int32 step and a
    ``uint32[2]`` PRNG key."""
    p = _param_shapes(init_fn, cfg)
    moments = tree_map(lambda s: sd(s.shape, F32), p)
    return TrainState(p, AdamWState(sd((), I32), moments, moments),
                      sd((2,), torch.uint32))


def _gnn_batch(arch: str, cfg, shp) -> tuple[dict, dict]:
    """(abstract batch, logical specs) for one GNN shape.

    Node/edge/triplet arrays shard over 'flat' (every mesh axis).
    Web-scale full-batch shapes run as host-scheduled cluster rounds where
    budgeted (GNN_ROUND_BUDGET / EQV2_EDGE_BUDGET).
    """
    N, E = shp.n_nodes_pad, shp.n_edges_pad
    rb = GNN_ROUND_BUDGET.get(arch, {}).get(shp.name)
    if rb is not None:
        N, E = min(N, rb[0]), min(E, rb[1])
    base = {
        "edge_src": sd((E,), I32), "edge_dst": sd((E,), I32),
        "edge_mask": sd((E,), BOOL),
    }
    spec = {
        "edge_src": ("flat",), "edge_dst": ("flat",), "edge_mask": ("flat",),
    }
    if arch == "graphsage":
        base |= {"x": sd((N, cfg.d_in)), "labels": sd((N,), I32),
                 "label_mask": sd((N,))}
        spec |= {"x": ("flat", None), "labels": ("flat",), "label_mask": ("flat",)}
    elif arch == "graphcast":
        base |= {"x": sd((N, cfg.d_in)), "edge_feat": sd((E, cfg.d_edge_in)),
                 "target": sd((N, cfg.d_out))}
        spec |= {"x": ("flat", None), "edge_feat": ("flat", None),
                 "target": ("flat", None)}
    elif arch == "dimenet":
        T = pad_to(E * TRIPLET_BUDGET[shp.name])
        base |= {"pos": sd((N, 3)), "z": sd((N, 1)),
                 "t_in": sd((T,), I32), "t_out": sd((T,), I32),
                 "triplet_mask": sd((T,), BOOL)}
        spec |= {"pos": ("flat", None), "z": ("flat", None),
                 "t_in": ("flat",), "t_out": ("flat",),
                 "triplet_mask": ("flat",)}
        if shp.batched:
            base |= {"graph_id": sd((N,), I32), "target": sd((shp.n_graphs, 1))}
            spec |= {"graph_id": ("flat",), "target": (None, None)}
        else:
            base |= {"target": sd((N, 1))}
            spec |= {"target": ("flat", None)}
    elif arch == "equiformer":
        budget = EQV2_EDGE_BUDGET[shp.name]
        Ep = E if budget is None else min(E, pad_to(budget))
        # web-scale full-batch runs as host-scheduled cluster rounds
        # (Cluster-GCN style): the device step sees one node block + halo
        Np = N if budget is None else min(N, 524_288)
        nc = cfg.n_coeff
        base = {
            "edge_src": sd((Ep,), I32), "edge_dst": sd((Ep,), I32),
            "edge_mask": sd((Ep,), BOOL),
            "x": sd((Np, cfg.d_in)), "wigner": sd((Ep, nc, nc)),
            "labels": sd((Np,), I32), "label_mask": sd((Np,)),
        }
        spec = {
            "edge_src": ("flat",), "edge_dst": ("flat",), "edge_mask": ("flat",),
            "x": ("flat", None), "wigner": ("flat", None, None),
            "labels": ("flat",), "label_mask": ("flat",),
        }
    return base, spec


_GNN_LOSS = {
    "graphsage": sage_loss, "graphcast": graphcast_loss,
    "dimenet": dimenet_loss, "equiformer": eqv2_loss,
}
_GNN_INIT = {
    "graphsage": init_sage, "graphcast": init_graphcast,
    "dimenet": init_dimenet, "equiformer": init_eqv2,
}
# each GNN arch's key in _GNN_INIT / _GNN_LOSS (its configs module's)
GNN_KEY = {"graphsage-reddit": "graphsage", "graphcast": "graphcast",
           "dimenet": "dimenet", "equiformer-v2": "equiformer"}


def _gnn_flops(arch: str, cfg, shp) -> float:
    N, E = shp.n_nodes_pad, shp.n_edges_pad
    rb = GNN_ROUND_BUDGET.get(arch, {}).get(shp.name)
    if rb is not None:
        N, E = min(N, rb[0]), min(E, rb[1])
    if arch == "graphsage":
        per_layer = 2 * (N * cfg.d_hidden * cfg.d_hidden * 2 + E * cfg.d_hidden)
        return 3 * cfg.n_layers * per_layer
    if arch == "graphcast":
        d = cfg.d_hidden
        per_layer = 2 * (E * (3 * d * d + d * d) + N * (2 * d * d + d * d))
        return 3 * cfg.n_layers * per_layer
    if arch == "dimenet":
        d = cfg.d_hidden
        T = E * TRIPLET_BUDGET[shp.name]
        per_block = 2 * (T * cfg.n_bilinear * d * d + E * d * d * 4)
        return 3 * cfg.n_blocks * per_block
    if arch == "equiformer":
        d = cfg.d_hidden
        nc = cfg.n_coeff
        budget = EQV2_EDGE_BUDGET[shp.name]
        Ep = E if budget is None else min(E, pad_to(budget))
        Np = N if budget is None else min(N, 524_288)
        per_layer = 2 * (2 * Ep * nc * nc * d + 2 * Ep * nc * d * d + Np * 4 * d * d)
        return 3 * cfg.n_layers * per_layer
    return 0.0


def gnn_cells(arch: str, base_cfg) -> dict:
    """One ``train`` cell per GNN shape.  A cell's ``make_step(shard)`` is
    the train step of the arch's loss (one microbatch; without a mesh)."""
    import dataclasses

    cells = {}
    for shape_name, shp in GNN_SHAPES.items():
        # input width follows the shape's d_feat (DimeNet reads positions,
        # not node features, so it has no d_in)
        cfg = base_cfg
        if hasattr(base_cfg, "d_in"):
            cfg = dataclasses.replace(base_cfg, d_in=shp.d_feat)
        loss_fn = _GNN_LOSS[arch]
        init_fn = _GNN_INIT[arch]

        def make_step(shard, cfg=cfg, loss_fn=loss_fn):
            _no_mesh(shard, "a GNN step")
            loss = lambda p, b: loss_fn(p, b, cfg, shard)  # noqa: E731
            return make_train_step(loss, n_microbatches=1)

        def abstract_inputs(cfg=cfg, shp=shp, arch=arch, init_fn=init_fn):
            batch, _ = _gnn_batch(arch, cfg, shp)
            return (_train_state_shapes(init_fn, cfg), batch)

        def logical_specs(cfg=cfg, shp=shp, arch=arch, init_fn=init_fn):
            _, spec = _gnn_batch(arch, cfg, shp)
            # GNN weights replicate: every param leaf fully replicated
            state_spec = tree_map(lambda s: (None,) * len(s.shape),
                                  _train_state_shapes(init_fn, cfg))
            return (state_spec, spec)

        cells[shape_name] = Cell(
            cfg.name, shape_name, "train", make_step, abstract_inputs,
            logical_specs, _gnn_flops(arch, cfg, shp), donate=(0,), config=cfg)
    return cells


# ===========================================================================
# recsys family (xDeepFM)
# ===========================================================================

def _xdfm_flops(cfg: XDeepFMConfig, batch: int, kind: str) -> float:
    m, d = cfg.n_sparse, cfg.embed_dim
    h_prev, cin = m, 0
    for h in cfg.cin_layers:
        cin += 2 * batch * h * h_prev * m * d
        h_prev = h
    dims = [m * d, *cfg.mlp_dims, 1]
    mlp = sum(2 * batch * a * b for a, b in zip(dims[:-1], dims[1:]))
    return (3.0 if kind == "train" else 1.0) * (cin + mlp)


def _xdfm_state_specs(cfg: XDeepFMConfig) -> TrainState:
    return TrainState(xdeepfm_param_specs(cfg),
                      AdamWState((), xdeepfm_param_specs(cfg),
                                 xdeepfm_param_specs(cfg)), ())


def xdeepfm_cells(cfg: XDeepFMConfig) -> dict:
    """``train_batch`` (a train step), ``serve_p99`` / ``serve_bulk``
    (``xdeepfm_forward``) and ``retrieval_cand``
    (``xdeepfm_score_candidates``); serving and retrieval run without
    autograd.  Without a mesh only."""
    cells = {}
    for shape_name, (B, kind) in RECSYS_SHAPES.items():
        if kind == "train":
            def make_step(shard, cfg=cfg):
                _no_mesh(shard, "an xDeepFM step")
                loss = lambda p, b: xdeepfm_loss(p, b, cfg, shard)  # noqa: E731
                return make_train_step(loss, n_microbatches=1)

            def abstract_inputs(cfg=cfg, B=B):
                return (_train_state_shapes(init_xdeepfm, cfg),
                        {"ids": sd((B, cfg.n_sparse), I32), "clicks": sd((B,))})

            def logical_specs(cfg=cfg):
                return (_xdfm_state_specs(cfg),
                        {"ids": ("batch", None), "clicks": ("batch",)})
        elif kind == "serve":
            def make_step(shard, cfg=cfg):
                _no_mesh(shard, "an xDeepFM step")
                return torch.no_grad()(
                    lambda p, b: xdeepfm_forward(p, b, cfg, shard))

            def abstract_inputs(cfg=cfg, B=B):
                return (_param_shapes(init_xdeepfm, cfg),
                        {"ids": sd((B, cfg.n_sparse), I32)})

            def logical_specs(cfg=cfg):
                return (xdeepfm_param_specs(cfg), {"ids": ("batch", None)})
        else:  # retrieval
            n_user = 19
            n_item = cfg.n_sparse - n_user
            Bp = pad_to(B)

            def make_step(shard, cfg=cfg):
                _no_mesh(shard, "an xDeepFM step")
                return torch.no_grad()(
                    lambda p, b: xdeepfm_score_candidates(p, b, cfg, shard))

            def abstract_inputs(cfg=cfg, Bp=Bp, n_user=n_user, n_item=n_item):
                return (_param_shapes(init_xdeepfm, cfg),
                        {"user_ids": sd((n_user,), I32),
                         "cand_ids": sd((Bp, n_item), I32)})

            def logical_specs(cfg=cfg):
                return (xdeepfm_param_specs(cfg),
                        {"user_ids": (None,), "cand_ids": ("batch", None)})

        cells[shape_name] = Cell(
            cfg.name, shape_name, kind, make_step, abstract_inputs,
            logical_specs, _xdfm_flops(cfg, B, kind),
            donate=(0,) if kind == "train" else ())
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
