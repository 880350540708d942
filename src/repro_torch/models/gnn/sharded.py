"""The GNNs' train loss over a mesh: the program the reference's GSPMD makes
of each GNN loss with a ``Sharder`` on a mesh, run in one process position
by position and differentiable in each position's shards of the
parameters.

The reference's layout (``configs.registry._gnn_batch``): every node, edge
and triplet array is split in blocks over ``"flat"`` (every mesh axis), as
GSPMD splits it (``ceil(n / k)`` a block, the last short or empty where
``k`` does not divide ``n``); the parameters are replicated.  Each layer
begins with ``shard.act(..., "flat", ...)``, so a gather such as
``h[src]`` reads rows that other positions hold, and a segment op over
``dst``, ``t_out`` or ``graph_id`` makes a partial per position.  The port
does what GSPMD does there (no halo exchange: that is
``models.gnn.halo_loss``'s partitioned layout):

* a gather all-gathers the feature over ``"flat"`` (``collectives.
  all_gather``) and indexes the whole at each position, once for all the
  indices that read it;
* a segment op reduces its position's edges over every segment and brings
  the partials together (``graphs.segment.*_mesh``): a sum
  reduce-scattered to the segments' blocks, or all-reduced where its
  result is replicated (DimeNet's per-graph readout); a mean its sum and
  its count; a softmax its maximum by ``pmax`` and its denominator by
  ``psum``;
* the loss: each position's float32 numerator (and mask sum) added at the
  mesh's first position in position order, as ``halo_ce_loss`` adds them,
  one scalar.

Every move is ``sharding.send``, so the backward moves each gradient back
by the dual collective, at its forward's positions (``observe.tag_node``).

The four archs' math is written once, in their modules, against the graph
ops :class:`Whole` (one device, the unsharded forward) and :class:`OnMesh`
(a value per position, a :class:`PerPos`): ``map`` runs a function of
local tensors (at each position, on its device, for ``OnMesh``),
``gather`` and the ``segment_*`` ops are the only places the two differ.
The checkpointed layers recompute in full on a mesh (no early stop), so
that every move inside a layer is made twice, once in the forward and
once in the recompute; :func:`predicted_moves` counts them so.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ...device import on_device
from ...distributed.collectives import all_gather, each_position
from ...distributed.observe import at_position
from ...distributed.sharding import NamedSharding, ShardedTensor, send, \
    shard_bounds, to_device
from ...graphs.segment import (
    segment_mean,
    segment_mean_mesh,
    segment_softmax,
    segment_softmax_mesh,
    segment_sum,
    segment_sum_mesh,
)
from ...train.checkpoint import tree_flatten, tree_map
from ..common import cross_entropy, layer_slices, token_nll

__all__ = ["OnMesh", "PerPos", "Whole", "graph_ops", "predicted_moves"]


class PerPos(list):
    """One value per mesh position, in position order, each on its
    position's device (an :class:`OnMesh` value)."""


class Whole:
    """The graph ops of the unsharded forward: plain tensors on one
    device."""

    mesh = None

    def map(self, fn, *args):
        return fn(*args)

    def gather(self, x, *idx):
        """``x[i]`` for each index tensor ``i`` (a tuple for several)."""
        out = tuple(x[i] for i in idx)
        return out if len(out) > 1 else out[0]

    def segment_sum(self, data, seg, n: int, mask=None, *, to="blocks"):
        return segment_sum(data, seg, n, mask)

    def segment_mean(self, data, seg, n: int, mask=None):
        return segment_mean(data, seg, n, mask)

    def segment_softmax(self, logits, seg, n: int, mask=None):
        return segment_softmax(logits, seg, n, mask)

    def block(self, x):
        return x

    def layers(self, params, key: str) -> list:
        return layer_slices(params[key])

    def checkpoint(self, fn, *args):
        return checkpoint(fn, *args, use_reentrant=False)

    def cross_entropy(self, logits, labels, mask=None):
        return cross_entropy(logits, labels, mask=mask)

    def mse(self, pred, target, mask=None):
        err = (pred - target).float() ** 2
        if mask is None:
            return err.mean()
        m = mask[:, None].float()
        return (err * m).sum() / torch.clamp_min(m.sum() * err.shape[-1], 1.0)

    def result(self, x, replicated: bool = False):
        return x


class OnMesh:
    """The graph ops over ``shard.mesh``: every value a :class:`PerPos`,
    node, edge and triplet values in their ``"flat"`` blocks (see the
    module docstring)."""

    def __init__(self, shard):
        self.shard = shard
        self.mesh = shard.mesh
        self.axes = shard.spec("flat")[0]
        self.devs = self.mesh.devices.ravel()
        self.n = self.mesh.size

    def map(self, fn, *args):
        """``fn`` at each position on its device, a :class:`PerPos`
        argument taken at the position, any other as it is; a function
        that returns a tuple gives a tuple of :class:`PerPos`."""
        out = each_position(self.mesh, fn, *(
            a if isinstance(a, PerPos) else [a] * self.n for a in args))
        if out and isinstance(out[0], tuple):
            return tuple(PerPos(v) for v in zip(*out))
        return PerPos(out)

    def params(self, tree) -> PerPos:
        """Each position's tree of a replicated parameter tree: its shard
        of each ``ShardedTensor`` leaf, or a whole tensor on its device
        (autograd sums the positions' gradients into it)."""
        def at(p):
            return tree_map(lambda t: t.shards[p] if isinstance(
                t, ShardedTensor) else to_device(t, self.devs[p]), tree)
        return PerPos(at(p) for p in range(self.n))

    def batch(self, batch: dict, replicated=()) -> dict:
        """Each leaf in its ``"flat"`` blocks (``Sharder.act``, split
        unevenly where its rows do not divide), or whole at every position
        for the keys in ``replicated``; leaves already so laid out do not
        move."""
        out = {}
        for k, x in batch.items():
            nd = len(x.shape)
            spec = (None,) * nd if k in replicated else \
                ("flat",) + (None,) * (nd - 1)
            out[k] = PerPos(self.shard.act(x, *spec).shards)
        return out

    def gather(self, x: PerPos, *idx):
        """``x`` all-gathered over ``"flat"`` once, indexed at each
        position by each of ``idx`` (a tuple for several)."""
        whole = PerPos(all_gather(x, self.mesh, self.axes, 0))
        out = tuple(self.map(lambda w, i: w[i], whole, ix) for ix in idx)
        return out if len(out) > 1 else out[0]

    def segment_sum(self, data, seg, n: int, mask=None, *, to="blocks"):
        return PerPos(segment_sum_mesh(data, seg, n, self.mesh, self.axes,
                                       mask, to=to))

    def segment_mean(self, data, seg, n: int, mask=None):
        return PerPos(segment_mean_mesh(data, seg, n, self.mesh, self.axes,
                                        mask))

    def segment_softmax(self, logits, seg, n: int, mask=None):
        return PerPos(segment_softmax_mesh(logits, seg, n, self.mesh,
                                           self.axes, mask))

    def block(self, x: PerPos) -> PerPos:
        """Each position's block of the rows of a value every position
        holds whole (a view)."""
        bounds = shard_bounds(x[0].shape[0], self.n)
        return PerPos(t[a:b] for t, (a, b) in zip(x, bounds))

    def layers(self, params: PerPos, key: str) -> list:
        """The stacked leaves under ``key`` sliced per layer: a
        :class:`PerPos` of each position's slice, for each layer."""
        per = [layer_slices(tree[key]) for tree in params]
        return [PerPos(lp) for lp in zip(*per)]

    def checkpoint(self, fn, *args):
        with set_checkpoint_early_stop(False):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)

    def _at_first(self, nums: PerPos, dens) -> torch.Tensor:
        """``sum(nums) / max(sum(dens), 1)`` at the mesh's first position,
        each position's terms added there in position order (a number
        ``dens`` is the count itself)."""
        dev = self.devs[0]
        with on_device(dev), at_position(0):
            total = count = None
            for p in range(self.n):
                t = send(nums[p], p, 0, "all-reduce", dev)
                total = t if total is None else total + t
                if isinstance(dens, PerPos):
                    c = send(dens[p], p, 0, "all-reduce", dev)
                    count = c if count is None else count + c
            if isinstance(dens, PerPos):
                return total / torch.clamp_min(count, 1.0)
            return total / dens

    def cross_entropy(self, logits, labels, mask=None):
        nll = self.map(lambda lg, lab: token_nll(lg, lab), logits, labels)
        if mask is None:
            return self._at_first(self.map(torch.sum, nll),
                                  float(sum(t.numel() for t in nll)))
        return self._at_first(
            self.map(lambda x, m: (x * m.float()).sum(), nll, mask),
            self.map(lambda m: m.float().sum(), mask))

    def mse(self, pred, target, mask=None):
        err = self.map(lambda a, b: (a - b).float() ** 2, pred, target)
        if mask is None:
            return self._at_first(self.map(torch.sum, err),
                                  float(sum(t.numel() for t in err)))
        return self._at_first(
            self.map(lambda e, m: (e * m[:, None].float()).sum(), err, mask),
            self.map(lambda e, m: m.float().sum() * e.shape[-1], err, mask))

    def result(self, x: PerPos, replicated: bool = False) -> ShardedTensor:
        """A value in its ``"flat"`` blocks (or, ``replicated``, whole at
        every position) as one ``ShardedTensor``."""
        if replicated:
            return ShardedTensor(NamedSharding(self.mesh, ()),
                                 tuple(x[0].shape), tuple(x))
        shape = (sum(t.shape[0] for t in x), *x[0].shape[1:])
        spec = NamedSharding(self.mesh, (self.axes,)).fitted(shape)
        return ShardedTensor(spec, shape, tuple(x))


def graph_ops(shard, params, batch: dict, replicated=()):
    """``(ops, params, batch)`` for a loss: :class:`Whole` and the
    arguments as they are without a mesh; on one, :class:`OnMesh` with
    each position's parameters and the batch in its blocks."""
    if shard is None or shard.mesh is None:
        return Whole(), params, batch
    g = OnMesh(shard)
    return g, g.params(params), g.batch(batch, replicated)


# -- the moves of one step ------------------------------------------------------

def _batch_shapes(arch: str, cfg, shape) -> dict:
    """A batch's leaf shapes: of ``shape`` itself (leaves with a
    ``.shape``), or of a registry shape (a ``GNNShape`` or its name) laid
    out as the cell's abstract batch."""
    from ...configs.registry import _gnn_batch
    from ...configs.shapes import GNN_SHAPES

    if isinstance(shape, str):
        shape = GNN_SHAPES[shape]
    if hasattr(shape, "n_nodes_pad"):
        shape = _gnn_batch(arch, cfg, shape)[0]
    return {k: tuple(v.shape) for k, v in shape.items()}


def predicted_moves(arch: str, cfg, shape, mesh) -> dict:
    """The all-gather, reduce-scatter and all-reduce bytes (received,
    summed over the positions) of one train step of GNN ``arch`` (an arch
    id or its registry key) at ``cfg`` over ``mesh``, on a batch of
    ``shape`` (the batch, or a registry shape), forward and backward, as
    the layout implies them.  With ``k + 1`` positions in the one
    ``"flat"`` group:

    * a gather of a tensor of ``b`` bytes: ``k b`` all-gathered, and as
      much reduce-scattered back in the backward where it takes a
      gradient;
    * a segment sum over ``n`` segments of ``w`` bytes each:
      ``(k + 1) n w - w n_0`` reduce-scattered (each partial to the first
      position, each block back; ``n_0`` the first block's rows), the
      same all-gathered in the backward where it takes a gradient; a
      mean's count the same with ``w = 4``, and an all-reduce ``2 k n w``
      each way;
    * a checkpointed layer's moves twice in the forward (the recompute)
      and once in the backward;
    * the loss: each position's float32 numerator and mask sum sent to
      the first position, the numerator's gradient back;
    * the optimizer: each parameter's float32 gradient all-reduced over
      its replicas (``2 k`` times its bytes) and the global norm's
      squares (``2 k`` times 4 bytes).
    """
    from ...configs.registry import _GNN_INIT, GNN_KEY

    key = GNN_KEY.get(arch, arch)
    sizes = _batch_shapes(key, cfg, shape)
    n_pos = mesh.size
    k = n_pos - 1
    got = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}

    def first_rows(n: int) -> int:
        a, b = shard_bounds(n, n_pos)[0]
        return b - a

    def gather(nbytes: int, grad: bool, times: int = 1) -> None:
        got["all-gather"] += times * k * nbytes
        if grad:
            got["reduce-scatter"] += k * nbytes

    def scatter(n: int, width: int, grad: bool, times: int = 1) -> None:
        moved = (k + 1) * n * width - first_rows(n) * width
        got["reduce-scatter"] += times * moved
        if grad:
            got["all-gather"] += moved

    def reduce(nbytes: int, grad: bool, times: int = 1) -> None:
        got["all-reduce"] += times * 2 * k * nbytes
        if grad:
            got["all-reduce"] += 2 * k * nbytes

    f32 = 4
    n = sizes["x"][0] if "x" in sizes else sizes["pos"][0]
    e = sizes["edge_src"][0]
    if key == "graphsage":
        for _ in range(cfg.n_layers):
            gather(n * cfg.d_hidden * f32, True)
            scatter(n, cfg.d_hidden * f32, True)
            scatter(n, f32, False)
    elif key == "graphcast":
        d = cfg.d_hidden
        for _ in range(cfg.n_layers):
            gather(n * d * f32, True, 2)
            scatter(n, d * f32, True, 2)
    elif key == "dimenet":
        d = cfg.d_hidden
        gather(n * 3 * f32, False)          # pos, for vec
        gather(n * d * f32, True)           # h, for the edge embedding
        gather(e * 3 * f32, False)          # vec, for the angles
        gather(e * f32, False)              # dist, for the triplets' basis
        for _ in range(cfg.n_blocks):
            gather(e * d * f32, True, 2)    # m[t_in]
            scatter(e, d * f32, True, 2)    # onto the edges by t_out
            scatter(n, d * f32, True, 2)    # onto the nodes by dst
        if "graph_id" in sizes:
            reduce(sizes["target"][0] * cfg.d_out * f32, True)
    elif key == "equiformer":
        isz = 2 if cfg.dtype == "bfloat16" else f32
        width = cfg.n_coeff * cfg.d_hidden * isz
        rows = n + (1 if "edge_mask" in sizes else 0)
        for _ in range(cfg.n_layers):
            gather(n * width, True, 2)
            got["all-reduce"] += 2 * 2 * k * rows * cfg.n_heads * f32  # pmax
            reduce(rows * cfg.n_heads * f32, True, 2)                   # psum
            scatter(n, width, True, 2)
    else:
        raise ValueError(f"unknown GNN arch {arch!r}")
    # the loss: numerators there and their gradients back, mask sums there
    masked = "label_mask" in sizes and (
        key in ("graphsage", "graphcast")
        or (key == "equiformer" and "labels" in sizes))
    got["all-reduce"] += 2 * k * f32 + (k * f32 if masked else 0)
    # the optimizer: the replicas' gradients and the global norm
    n_params = sum(t.numel() for t in tree_flatten(
        _GNN_INIT[key](cfg, device="meta"))[0])
    got["all-reduce"] += 2 * k * f32 * n_params + 2 * k * f32
    return got
