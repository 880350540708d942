"""Which mesh axes a window (batch) dimension shards over.

The port's copy of the data-axis resolution of
``repro.distributed.sharding`` (``Sharder.for_mesh``): a batch shards over
the mesh's data-parallel axes ("pod", "data", "replica"), or over every
axis of a mesh that names none.  The reference's ``Sharder`` also shards
LM parameters and activations, which the port does not shard yet.
"""
from __future__ import annotations

from ..launch.mesh import Mesh

__all__ = ["batch_partition_axes"]

# axis names that are data-parallel, as the reference resolves them
_DATA_AXES = ("pod", "data", "replica")


def batch_partition_axes(mesh: Mesh) -> tuple:
    """Mesh axes a batch / window dimension shards over: the data-parallel
    axes when the mesh names any, every mesh axis otherwise (a 1-D mesh of
    any axis name is fully data-parallel)."""
    axes = tuple(a for a in mesh.axis_names if a in _DATA_AXES)
    return axes if axes else tuple(mesh.axis_names)
