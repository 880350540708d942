"""Device meshes of the port: the counterpart of a ``jax.sharding.Mesh``.

A :class:`Mesh` is an n-d grid of ``torch.device``s with named axes.  It
holds no state on the devices: the port's sharded code runs in one process
and moves each shard's tensors to its device itself.  One device may appear
more than once in a grid (``[cpu] * 4``, ``[cuda:0] * 2``), the port's
counterpart of XLA's forced host device count: the CPU tests and a machine
with one card run N shards that way, one after another.  Sharded code
therefore keys a shard by its index in the grid (its *position*, a flat
row-major index), never by its device.  A grid of ``meta`` devices is a
mesh of placeholders, on which the dry-run (``launch.dryrun``) traces a
step without memory or work.

``make_window_mesh`` builds the executor's 1-D window mesh, as the
reference's.  ``make_production_mesh`` and ``make_tiny_mesh`` have the
reference's shapes and axis names; the dry-run builds them of ``meta``
positions, ``chip_smoke.py`` of the cards present, repeated.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import canonical_device

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "make_tiny_mesh",
           "make_window_mesh"]


class Mesh:
    """An n-d grid of devices with one name per axis.

    ``devices`` is a numpy object array of ``torch.device``s,
    ``axis_names`` a tuple of names and ``shape`` the ordered mapping from
    axis name to size, as a ``jax.sharding.Mesh`` has them."""

    def __init__(self, devices, axis_names):
        src = np.asarray(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx, dev in np.ndenumerate(src):
            grid[idx] = canonical_device(dev)
        names = tuple(axis_names)
        if grid.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"{grid.ndim}-d device grid needs as many distinct "
                             f"axis names, got {names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def _line(self, grid: np.ndarray, axis: str, at: dict) -> list:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        idx = tuple(slice(None) if a == axis else int(at.get(a, 0))
                    for a in self.axis_names)
        return list(grid[idx])

    def _positions(self) -> np.ndarray:
        return np.arange(self.size).reshape(self.devices.shape)

    def axis_devices(self, axis: str, **at) -> list[torch.device]:
        """The devices along ``axis`` with every other axis at index ``at``
        (default 0): one line of the grid."""
        return self._line(self.devices, axis, at)

    def axis_positions(self, axis: str, **at) -> list[int]:
        """The positions of :meth:`axis_devices`' line."""
        return [int(p) for p in self._line(self._positions(), axis, at)]

    def shard_devices(self, axes) -> list[torch.device]:
        """The devices a dim split over ``axes`` (one name or a tuple) lands
        on, shard by shard: the grid with ``axes`` leading, in the order
        given (the first axis major), at index 0 of every other axis (a
        replica).  The order in which ``shard_map`` splits a dim over
        ``PartitionSpec(axes)``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"mesh has no axis {a!r}: {self.axis_names}")
        rest = [a for a in self.axis_names if a not in axes]
        order = [self.axis_names.index(a) for a in (*axes, *rest)]
        grid = self.devices.transpose(order)
        return list(grid[(Ellipsis,) + (0,) * len(rest)].ravel()) if rest \
            else list(grid.ravel())

    def position_index(self, position: int) -> dict:
        """Axis name -> index of flat position ``position``."""
        idx = np.unravel_index(int(position), self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def _cards() -> list[torch.device]:
    """Every CUDA card, in index order; raises when there is none rather
    than meshing nothing."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device is available; name the devices to shard over "
            "the CPU, e.g. devices=['cpu'] * 2")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def make_mesh(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major), every card by
    default; the counterpart of the reference's ``make_mesh_compat``.  The
    sequence must hold exactly ``prod(shape)`` devices and may repeat
    one."""
    shape = tuple(int(s) for s in shape)
    devs = _cards() if devices is None else list(devices)
    if len(devs) != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} devices, "
                         f"got {len(devs)}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axes)


def make_window_mesh(devices=None, *, axis: str = "data") -> Mesh:
    """1-D data-parallel mesh for the executor's window sharding.

    ``devices`` is an int N (the first N cards; raises outside ``[1,
    torch.cuda.device_count()]`` and without a card), an explicit device
    sequence (may repeat a device; empty raises) or None for every card.
    The axis is named "data", so
    ``distributed.sharding.batch_partition_axes`` resolves it as
    data-parallel."""
    if devices is None:
        devs = _cards()
    elif isinstance(devices, (int, np.integer)) and not isinstance(devices,
                                                                   bool):
        n = torch.cuda.device_count()
        if int(devices) < 1:
            raise ValueError(f"devices={devices} outside [1, {n}] available")
        cards = _cards()
        if int(devices) > len(cards):
            raise ValueError(f"devices={devices} outside [1, {n}] available")
        devs = cards[:int(devices)]
    else:
        devs = list(devices)
        if not devs:
            raise ValueError("empty device sequence")
    return make_mesh((len(devs),), (axis,), devs)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16 x 16 = 256 positions ("data", "model"); ``multi_pod`` prepends a
    2-way "pod" axis (512), as the reference's.  ``devices`` is a sequence
    of exactly that many devices (it may repeat one; ``["meta"] * 256`` is
    the dry-run's placeholder mesh); the default, every card, raises
    unless their count is exact."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_tiny_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's reduced mesh of 8 positions: (2, 4) ("data",
    "model"), or (2, 2, 2) ("pod", "data", "model"); ``devices`` as
    :func:`make_production_mesh` takes them."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)
