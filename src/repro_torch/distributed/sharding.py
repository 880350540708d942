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

The port shards windows over a mesh (``core.distributed``, the executor's
``devices=`` / ``mesh=``) but not yet an LM's parameters and activations.
On a mesh :meth:`Sharder.named` gives a :class:`NamedSharding` (which the
registry's ``Cell.in_shardings`` and the dry-run use to place a cell's
inputs), while :meth:`Sharder.act` and :meth:`Sharder.params` raise
``NotImplementedError`` (ROADMAP Queue 1 item 3) rather than return
something that is quietly unsharded.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..launch.mesh import Mesh

NO_SHARD = None

__all__ = ["NamedSharding", "ShardedTensor", "Sharder", "NO_SHARD",
           "batch_partition_axes"]

# axis names that are data-parallel, as the reference resolves them
_DATA_AXES = ("pod", "data", "replica")
_LM_ON_A_MESH = ("sharding an LM's parameters and activations over a mesh "
                 "is not ported yet (ROADMAP Queue 1 item 3)")


def batch_partition_axes(mesh: Mesh) -> tuple:
    """Mesh axes a batch / window dimension shards over: the data-parallel
    axes when the mesh names any (:meth:`Sharder.for_mesh`'s resolution:
    "pod" / "data" / "replica"), every mesh axis otherwise (a 1-D mesh of
    any axis name is fully data-parallel)."""
    axes = tuple(a for a in mesh.axis_names if a in _DATA_AXES)
    return axes if axes else tuple(mesh.axis_names)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec, the counterpart of
    ``jax.sharding.NamedSharding``: ``spec[d]`` is the mesh axis (or tuple
    of axes, the first major) that dim ``d`` splits over, or None where it
    is replicated; dims past the spec are replicated."""
    mesh: Mesh
    spec: tuple

    def _dim_axes(self, ndim: int) -> list[tuple]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more dims than a "
                             f"{ndim}-d array")
        out = []
        for a in tuple(self.spec) + (None,) * (ndim - len(self.spec)):
            axes = () if a is None else ((a,) if isinstance(a, str)
                                         else tuple(a))
            for name in axes:
                if name not in self.mesh.axis_names:
                    raise ValueError(f"mesh has no axis {name!r}: "
                                     f"{self.mesh.axis_names}")
            out.append(axes)
        return out

    def shard_shape(self, shape) -> tuple:
        """The shape each position holds of a global ``shape``; a split dim
        must divide by its axes' size, as jax requires of an input."""
        sizes = self.mesh.shape
        out = []
        for n, axes in zip(shape, self._dim_axes(len(shape))):
            k = math.prod(sizes[a] for a in axes)
            if n % k:
                raise ValueError(f"dim of size {n} does not divide over "
                                 f"{axes} ({k} shards)")
            out.append(n // k)
        return tuple(out)

    def shard_slices(self, position: int, shape) -> tuple:
        """Position ``position``'s slice of each dim of a global ``shape``:
        the shard index of a dim split over ``(a, b)`` is ``i_a * size_b +
        i_b`` (the first axis major)."""
        sizes, at = self.mesh.shape, self.mesh.position_index(position)
        out = []
        for n, m, axes in zip(shape, self.shard_shape(shape),
                              self._dim_axes(len(shape))):
            k = 0
            for a in axes:
                k = k * sizes[a] + at[a]
            out.append(slice(k * m, (k + 1) * m))
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
        if self.mesh is None:
            return x
        raise NotImplementedError(_LM_ON_A_MESH)

    # -- parameter sharding resolution -------------------------------------------
    def params(self, spec_tree, param_tree):
        """A tree of ``None`` shaped like ``param_tree`` (dicts, lists and
        tuples walked, anything else a leaf) without a mesh."""
        if self.mesh is not None:
            raise NotImplementedError(_LM_ON_A_MESH)

        def nones(x):
            if isinstance(x, dict):
                return {k: nones(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)) and not hasattr(type(x), "_fields"):
                return type(x)(nones(v) for v in x)
            if isinstance(x, tuple):
                return type(x)(*(nones(v) for v in x))
            return None
        return nones(param_tree)
