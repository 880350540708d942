"""Sharding context threaded through model code (the port of
``repro.distributed.sharding``).

Models never name a concrete mesh: they call ``shard.act(x, *axes)`` with
*logical* axis names, and the :class:`Sharder` resolves them to mesh axes,
or does nothing without a mesh, which is how the port runs on one device.

Logical axes:
  "batch"  -> all data-parallel mesh axes (("pod", "data") on a multi-pod mesh)
  "model"  -> the tensor-parallel mesh axis
  "seq"    -> the sequence dim; "model" when sequence parallelism is on
  "data"   -> the data-parallel axes, as "batch"
  "flat"   -> every mesh axis (the GNN arrays' maximal 1-D partition)
  None     -> a replicated dim

On a mesh a global tensor is a :class:`ShardedTensor`: one shard per mesh
position, each on its position's device.  :meth:`Sharder.params` resolves a
tree of logical specs to a tree of :class:`NamedSharding` (the registry's
``Cell.in_shardings`` and the dry-run place a cell's inputs by them) and
:meth:`Sharder.place` puts a parameter tree by them.  :meth:`Sharder.act`
is ``with_sharding_constraint``: it lays a tensor out as the logical axes
say, moving the pieces each position lacks from the positions that hold
them and reporting every move to the observer (``distributed.observe``).
Parameters must divide over their axes, as jax requires of an input;
activations may not, and then split as GSPMD pads them: ``ceil(n / k)``
a shard, the last shards short or empty (``NamedSharding(uneven=True)``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from dataclasses import dataclass

import torch

from ..launch.mesh import Mesh
from .observe import at_position, note_move, tag_node

NO_SHARD = None

__all__ = ["DuplicateSpecError", "NamedSharding", "ShardedTensor", "Sharder",
           "NO_SHARD", "batch_partition_axes", "put_tree", "reshard", "send",
           "shard_bounds", "to_device"]

# axis names that are data-parallel, as the reference resolves them
_DATA_AXES = ("pod", "data", "replica")


def batch_partition_axes(mesh: Mesh) -> tuple:
    """Mesh axes a batch / window dimension shards over: the data-parallel
    axes when the mesh names any (:meth:`Sharder.for_mesh`'s resolution:
    "pod" / "data" / "replica"), every mesh axis otherwise (a 1-D mesh of
    any axis name is fully data-parallel)."""
    axes = tuple(a for a in mesh.axis_names if a in _DATA_AXES)
    return axes if axes else tuple(mesh.axis_names)


def shard_bounds(n: int, k: int) -> list[tuple[int, int]]:
    """``[start, stop)`` of each of ``k`` shards of a dim of ``n``:
    ``ceil(n / k)`` a shard, the last shards short or empty (the even
    split where ``k`` divides ``n``)."""
    c = -(-n // k)
    return [(min(i * c, n), min((i + 1) * c, n)) for i in range(k)]


class DuplicateSpecError(Exception):
    """A spec that maps one mesh axis to more than one dim (the counterpart
    of jax's ``DuplicateSpecError``, which ``jax.sharding.NamedSharding``
    raises at construction)."""

    def __init__(self, message: str, mesh=None, spec=None):
        super().__init__(message)
        self.message, self.mesh, self.spec = message, mesh, spec


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec, the counterpart of
    ``jax.sharding.NamedSharding``: ``spec[d]`` is the mesh axis (or tuple
    of axes, the first major) that dim ``d`` splits over, or None where it
    is replicated; dims past the spec are replicated.  A split dim must
    divide by its axes' size unless ``uneven``, the split GSPMD gives an
    activation: ``ceil(n / k)`` a shard, the last shards short or
    empty.  As jax's, it refuses at construction a spec that names an axis
    the mesh lacks (``ValueError``) or maps one axis to more than one dim
    (:class:`DuplicateSpecError`)."""
    mesh: Mesh
    spec: tuple
    uneven: bool = False

    def __post_init__(self):
        counts: dict = {}
        for a in self.spec:
            for name in () if a is None else (a,) if isinstance(a, str) \
                    else tuple(a):
                if name not in self.mesh.axis_names:
                    raise ValueError(f"mesh has no axis {name!r}: "
                                     f"{self.mesh.axis_names}")
                counts[name] = counts.get(name, 0) + 1
        twice = [name for name, c in counts.items() if c > 1]
        if twice:
            raise DuplicateSpecError(
                "A single NamedSharding spec specification can map every "
                f"mesh axis to at most one positional dimension, but "
                f"{self.spec} has duplicate entries for {twice}",
                self.mesh, self.spec)

    def _dim_axes(self, ndim: int) -> list[tuple]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more dims than a "
                             f"{ndim}-d array")
        return [() if a is None else (a,) if isinstance(a, str) else tuple(a)
                for a in tuple(self.spec) + (None,) * (ndim - len(self.spec))]

    def divides(self, shape) -> bool:
        """Whether every split dim of ``shape`` divides by its axes' size."""
        sizes = self.mesh.shape
        return all(n % math.prod(sizes[a] for a in axes) == 0
                   for n, axes in zip(shape, self._dim_axes(len(shape))))

    def fitted(self, shape) -> "NamedSharding":
        """This sharding for an activation of ``shape``: itself where every
        split dim divides, else its ``uneven`` form."""
        return self if self.divides(shape) else dataclasses.replace(
            self, uneven=True)

    def shard_shape(self, shape) -> tuple:
        """The shape each position holds of a global ``shape`` (under
        ``uneven``, the largest: ``ceil(n / k)``); a split dim must divide
        by its axes' size otherwise, as jax requires of an input."""
        sizes = self.mesh.shape
        out = []
        for n, axes in zip(shape, self._dim_axes(len(shape))):
            k = math.prod(sizes[a] for a in axes)
            if n % k and not self.uneven:
                raise ValueError(f"dim of size {n} does not divide over "
                                 f"{axes} ({k} shards)")
            out.append(-(-n // k))
        return tuple(out)

    def shard_slices(self, position: int, shape) -> tuple:
        """Position ``position``'s slice of each dim of a global ``shape``:
        the shard index of a dim split over ``(a, b)`` is ``i_a * size_b +
        i_b`` (the first axis major)."""
        sizes, at = self.mesh.shape, self.mesh.position_index(position)
        self.shard_shape(shape)     # raises where a split does not divide
        out = []
        for n, axes in zip(shape, self._dim_axes(len(shape))):
            k = 0
            for a in axes:
                k = k * sizes[a] + at[a]
            lo, hi = shard_bounds(n, math.prod(sizes[a] for a in axes))[k]
            out.append(slice(lo, hi))
        return tuple(out)

    def place(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x``'s shards, one per position in flat order, each on its
        position's device (a view where the device is ``x``'s own)."""
        devs = self.mesh.devices.ravel()
        return [x[self.shard_slices(p, x.shape)].to(devs[p])
                for p in range(self.mesh.size)]

    def put(self, x: torch.Tensor) -> "ShardedTensor":
        """``x`` placed (:meth:`place`) as one :class:`ShardedTensor`, the
        counterpart of ``jax.device_put(x, sharding)``."""
        return ShardedTensor(self, tuple(x.shape), tuple(self.place(x)))


@dataclass(frozen=True, eq=False)
class ShardedTensor:
    """A global tensor as the positions of a mesh hold it, the counterpart
    of a ``jax.Array`` placed with a ``NamedSharding``: ``shards[p]``, on
    position ``p``'s device, is ``sharding.shard_slices(p, shape)`` of it.
    A leaf of a tree (``train.checkpoint`` saves its gathered value)."""
    sharding: NamedSharding
    shape: tuple
    shards: tuple

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def holders(self) -> list[list[int]]:
        """The positions that hold each distinct block, in position order:
        more than one where a dim is replicated over an axis."""
        blocks: dict = {}
        for p in range(len(self.shards)):
            key = tuple((s.start, s.stop) for s in
                        self.sharding.shard_slices(p, self.shape))
            blocks.setdefault(key, []).append(p)
        return list(blocks.values())

    def gather(self, device="cpu") -> torch.Tensor:
        """The global tensor on ``device``, each distinct slice copied
        once from the first position that holds it."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for p, shard in enumerate(self.shards):
            idx = self.sharding.shard_slices(p, self.shape)
            key = tuple((s.start, s.stop) for s in idx)
            if key not in seen:
                seen.add(key)
                out[idx] = shard.to(device)
        return out


def put_tree(tree, shardings):
    """``tree``'s tensors placed by ``shardings``, a tree of one structure
    (dicts, lists, tuples and named tuples) whose leaves are
    :class:`NamedSharding` or None: each tensor under a sharding as a
    :class:`ShardedTensor` (:meth:`NamedSharding.put`), anything else
    as it is.  The counterpart of ``jax.device_put(tree, shardings)``."""
    if isinstance(tree, dict):
        return {k: put_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(type(tree), "_fields"):
        return type(tree)(*(put_tree(v, s) for v, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(put_tree(v, s) for v, s in zip(tree, shardings))
    if isinstance(tree, torch.Tensor) and shardings is not None:
        return shardings.put(tree)
    return tree


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``: itself where it lies there (no op at all, which
    keeps a traced step's op count down), else a copy."""
    return t if t.device == device else t.to(device)


# the collective that carries a move's gradient back: XLA's transpose of
# each kind
DUAL = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
        "all-reduce": "all-reduce", "all-to-all": "all-to-all",
        "collective-permute": "collective-permute"}


class _Send(torch.autograd.Function):
    """A move between positions under autograd: forward ``to_device``,
    backward the gradient moved back, noted as the dual collective."""

    @staticmethod
    def forward(ctx, t, src, dst, kind, device):
        ctx.back = (dst, src, DUAL[kind], t.device)
        return to_device(t, device)

    @staticmethod
    def backward(ctx, grad):
        dst, src, kind, device = ctx.back
        note_move(kind, dst, src, grad.nbytes)
        return to_device(grad, device), None, None, None, None


def send(t: torch.Tensor, src: int, dst: int, kind: str,
         device: torch.device) -> torch.Tensor:
    """``t``, position ``src``'s, as position ``dst`` receives it in a
    collective of ``kind``: on ``device`` (:func:`to_device`), the move
    reported (``observe.note_move``) where the positions differ.  Where
    ``t`` takes a gradient the move is differentiable and its backward
    moves the gradient back from ``dst`` to ``src``, reported under the
    dual kind (:data:`DUAL`: an all-gather's gradient goes back by a
    reduce-scatter); its autograd node runs at ``dst`` and hands the
    gradient on at ``src`` (``observe.tag_node``)."""
    if src == dst:
        return to_device(t, device)
    note_move(kind, src, dst, t.nbytes)
    if not (t.requires_grad and torch.is_grad_enabled()):
        return to_device(t, device)
    out = _Send.apply(t, src, dst, kind, device)
    tag_node(out.grad_fn, dst, src)
    return out


def _move_kind(src: NamedSharding, dst: NamedSharding, ndim: int) -> str:
    """XLA's name for the collective that takes ``src``'s layout to
    ``dst``'s: an all-to-all where a mesh axis moves from one dim to
    another, an all-gather where a split is dropped, an all-to-all for any
    other re-split."""
    s_axes, d_axes = src._dim_axes(ndim), dst._dim_axes(ndim)
    for a in src.mesh.axis_names:
        s_dims = {i for i, axes in enumerate(s_axes) if a in axes}
        d_dims = {i for i, axes in enumerate(d_axes) if a in axes}
        if s_dims and d_dims and s_dims != d_dims:
            return "all-to-all"
    if any(set(s) - set(d) for s, d in zip(s_axes, d_axes)):
        return "all-gather"
    return "all-to-all"


def _overlap(a: slice, b: slice) -> slice | None:
    lo, hi = max(a.start, b.start), min(a.stop, b.stop)
    return slice(lo, hi) if lo < hi else None


def reshard(x, target: NamedSharding) -> ShardedTensor:
    """``x`` laid out by ``target``: a :class:`ShardedTensor`, or a tensor
    that every position holds whole (each takes its slice; nothing moves).

    Each position keeps what it holds; a piece it lacks comes from the
    position that holds it (the lowest on the same device, else the
    lowest), is reported to the observer as one move of the kind
    :func:`_move_kind` names, and is assembled at the position (inside
    ``observe.at_position``): a view where its own shard covers the target
    slice, else a concatenation along the one dim the pieces tile, else a
    copy into an empty shard."""
    mesh = target.mesh
    devs = mesh.devices.ravel()
    if isinstance(x, torch.Tensor):
        return ShardedTensor(target, tuple(x.shape), tuple(
            to_device(x[target.shard_slices(p, x.shape)], devs[p])
            for p in range(mesh.size)))
    if x.sharding.mesh is not mesh:
        raise ValueError("resharding across meshes is not supported")
    shape, ndim = x.shape, len(x.shape)
    src = x.sharding
    have = [src.shard_slices(p, shape) for p in range(mesh.size)]
    if all(have[p] == target.shard_slices(p, shape) for p in range(mesh.size)):
        return ShardedTensor(target, shape, x.shards)
    kind = _move_kind(src, target, ndim)
    # the distinct source blocks: per dim its distinct intervals, and per
    # block the positions that hold it
    holders: dict = {}
    for p, idx in enumerate(have):
        holders.setdefault(tuple((s.start, s.stop) for s in idx), []).append(p)
    intervals = [sorted({key[d] for key in holders}) for d in range(ndim)]
    shards = []
    for p in range(mesh.size):
        want = target.shard_slices(p, shape)
        mine = have[p]
        rel = tuple(slice(w.start - m.start, w.stop - m.start)
                    for w, m in zip(want, mine))
        with at_position(p):
            if any(w.start == w.stop for w in want):
                shards.append(x.shards[p].new_empty(
                    tuple(w.stop - w.start for w in want)))
                continue
            if all(m.start <= w.start and w.stop <= m.stop
                   for w, m in zip(want, mine)):
                shards.append(x.shards[p][rel])
                continue
            per_dim = [[(lo, hi) for lo, hi in intervals[d]
                        if _overlap(slice(lo, hi), want[d])]
                       for d in range(ndim)]
            pieces = []
            for key in itertools.product(*per_dim):
                if key not in holders:
                    continue
                qs = holders[key]
                q = p if p in qs else next(
                    (r for r in qs if devs[r] == devs[p]), qs[0])
                cut = tuple(_overlap(slice(*k), w) or slice(w.start, w.start)
                            for k, w in zip(key, want))
                piece = x.shards[q][tuple(slice(c.start - k[0], c.stop - k[0])
                                          for c, k in zip(cut, key))]
                pieces.append((cut, send(piece, q if piece.numel() else p, p,
                                         kind, devs[p])))
            shards.append(_assemble(pieces, want, x.dtype, devs[p]))
    return ShardedTensor(target, shape, tuple(shards))


def _assemble(pieces, want: tuple, dtype, device) -> torch.Tensor:
    """The block ``want`` from ``(slices, tensor)`` pieces that tile it."""
    size = tuple(w.stop - w.start for w in want)
    varying = [d for d in range(len(want))
               if any(c[d] != want[d] for c, _ in pieces)]
    if len(varying) == 1:
        d = varying[0]
        parts = sorted(pieces, key=lambda cp: cp[0][d].start)
        return torch.cat([t for _, t in parts], dim=d)
    out = torch.empty(size, dtype=dtype, device=device)
    for cut, t in pieces:
        out[tuple(slice(c.start - w.start, c.stop - w.start)
                  for c, w in zip(cut, want))] = t
    return out


def _map_specs(fn, spec_tree):
    """``fn`` on each logical spec (a tuple of axis names) of a tree of
    dicts, lists and tuples of them."""
    if isinstance(spec_tree, tuple) and all(a is None or isinstance(a, str)
                                            for a in spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    return type(spec_tree)(_map_specs(fn, v) for v in spec_tree)


@dataclass
class Sharder:
    mesh: Mesh | None = None
    data_axes: tuple = ("data",)
    model_axis: str | None = "model"
    seq_parallel: bool = False
    # gradient-compression hook (the reference's collectives wrap DP sums)
    grad_compression: str | None = None

    @classmethod
    def for_mesh(cls, mesh: Mesh | None, *, seq_parallel: bool = False,
                 grad_compression: str | None = None) -> "Sharder":
        if mesh is None:
            return cls(None)
        names = mesh.axis_names
        data_axes = tuple(a for a in names if a in _DATA_AXES)
        model_axis = "model" if "model" in names else None
        return cls(mesh, data_axes, model_axis, seq_parallel, grad_compression)

    # -- logical resolution ---------------------------------------------------
    def _resolve(self, axis: str | None):
        if axis is None:
            return None
        if axis in ("batch", "data"):
            return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]
        if axis == "model":
            return self.model_axis
        if axis == "seq":
            return self.model_axis if self.seq_parallel else None
        if axis == "flat":
            axes = tuple(self.data_axes) + ((self.model_axis,) if self.model_axis else ())
            return axes if len(axes) > 1 else (axes[0] if axes else None)
        raise ValueError(f"unknown logical axis {axis!r}")

    def spec(self, *axes) -> tuple:
        """The mesh axes of each logical axis (the reference's
        ``PartitionSpec``, as a tuple)."""
        return tuple(self._resolve(a) for a in axes)

    def named(self, *axes) -> NamedSharding | None:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(*axes))

    # -- activation constraint --------------------------------------------------
    def act(self, x, *axes):
        """``x`` laid out by the logical ``axes`` (the reference's
        ``with_sharding_constraint``): ``x`` itself without a mesh; on one,
        a :class:`ShardedTensor` by :meth:`named` (split unevenly where a
        dim does not divide) from a ShardedTensor or from a tensor every
        position holds whole, the moves reported (:func:`reshard`)."""
        if self.mesh is None:
            return x
        return reshard(x, self.named(*axes).fitted(x.shape))

    # -- parameter sharding resolution -------------------------------------------
    def params(self, spec_tree, param_tree):
        """The tree of :class:`NamedSharding` of a tree of logical specs
        (tuples are its leaves, as the reference's ``jax.tree.map`` takes
        them); without a mesh a tree of ``None`` shaped like
        ``param_tree`` (dicts, lists and tuples walked, anything else a
        leaf)."""
        if self.mesh is not None:
            return _map_specs(lambda axes: self.named(*axes), spec_tree)

        def nones(x):
            if isinstance(x, dict):
                return {k: nones(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)) and not hasattr(type(x), "_fields"):
                return type(x)(nones(v) for v in x)
            if isinstance(x, tuple):
                return type(x)(*(nones(v) for v in x))
            return None
        return nones(param_tree)

    def place(self, spec_tree, param_tree):
        """``param_tree``'s tensors placed by :meth:`params` of
        ``spec_tree`` (one structure): a tree of :class:`ShardedTensor`, on
        a mesh; ``param_tree`` itself without one."""
        if self.mesh is None:
            return param_tree

        def put(spec, x):
            if isinstance(spec, tuple) and all(a is None or isinstance(a, str)
                                               for a in spec):
                return self.named(*spec).put(x)
            if isinstance(spec, dict):
                return {k: put(v, x[k]) for k, v in spec.items()}
            return type(spec)(put(v, t) for v, t in zip(spec, x))
        return put(spec_tree, param_tree)
