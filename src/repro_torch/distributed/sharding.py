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
``devices=`` / ``mesh=``) but not yet an LM's parameters and activations:
on a mesh :meth:`Sharder.named`, :meth:`Sharder.act` and
:meth:`Sharder.params` raise ``NotImplementedError`` (ROADMAP Queue 1
item 3) rather than return something that is quietly unsharded.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..launch.mesh import Mesh

NO_SHARD = None

__all__ = ["Sharder", "NO_SHARD", "batch_partition_axes"]

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

    def named(self, *axes):
        if self.mesh is None:
            return None
        raise NotImplementedError(_LM_ON_A_MESH)

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
