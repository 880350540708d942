"""Collectives of the port over a list of devices in one process.

``ring_pair_count`` is the blocked-Gram ring of the distributed butterfly
counter (``repro.distributed.collectives.ring_pair_count``).  The
reference runs it inside ``shard_map``: every device holds one row-block
of a biadjacency, the blocks circulate by ``collective_permute`` and a
``psum`` adds the devices' partials.  The port runs the same schedule in one
process over a list of devices: each step moves every block to the next
device (``.to(device, non_blocking=True)``; a no-op where the next device is
the same one) and queues each device's partial on that device, so distinct
cards work concurrently; the final sum on the first device stands for the
``psum``.  :func:`all_to_all` is ``lax.all_to_all`` (``split_axis=0``,
``concat_axis=0``) over such a list, the halo exchange's collective.  Both
run each position's work inside ``observe.at_position`` and report every
move between positions (``observe.note_move``), so that an observer (the
dry-run's cost model) can tell positions that share a device apart.

:func:`compress_grads` and :func:`decompress_grads` are the reference's
gradient compression (bf16, or int8 with a per-tensor scale), and
:func:`psum_mean_compressed` its data-parallel mean around them.  The
reference's ``psum`` over a named axis runs inside ``shard_map`` on one
tree per device; the port takes one tree per mesh position, reduces each
group of positions along the axis at the group's first position and places
the mean back on every member, as the halo losses
(``models.gnn.halo_loss``) sum over their devices.

:func:`all_gather`, :func:`psum`, :func:`pmax`, :func:`reduce_scatter`
and :func:`resplit` are the collectives of the sharded LM trunk
(``models.transformer.sharded``) over the groups of one mesh axis, on one
tensor per position: each member's piece is concatenated in group order,
summed (or maxed) at the group's first position in group order, or split
anew, and every move between positions is reported under XLA's name.
:func:`row_split_lookup` is the vocabulary-parallel lookup built on
:func:`psum`, the LM's embedding's and xDeepFM's tables'.
Each move is ``sharding.send``: under autograd the gradients go back by
the dual collective (an all-gather's by a reduce-scatter and the other
way round, an all-reduce's and an all-to-all's by their own kind),
reported as they move.  An axis may be a tuple of axes: over every axis
of the mesh (the GNNs' "flat", ``models.gnn.sharded``) the one group is
the whole mesh in position order, so that member ``i``'s block of a
reduce-scatter is the ``i``-th block of an uneven "flat" split.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import numpy as np
import torch

from ..device import on_device
from ..launch.mesh import Mesh
from ..train.checkpoint import tree_flatten, tree_map, tree_unflatten
from .observe import at_position, note_move
from .sharding import send, shard_bounds

__all__ = ["all_gather", "all_to_all", "axis_groups", "compress_grads",
           "decompress_grads", "each_position", "pmax", "psum",
           "psum_mean_compressed", "reduce_scatter", "resplit",
           "ring_pair_count", "row_split_lookup"]


def compress_grads(tree, method: str | None) -> tuple:
    """``(compressed tree, scales)``, the reference's ``compress_grads``:
    ``None`` gives ``tree`` itself and no scales, ``"bf16"`` every leaf cast
    to bfloat16 and no scales, ``"int8"`` every leaf divided by its
    per-tensor scale ``max(max|g|, 1e-9) / 127`` (a 0-d tensor of the
    leaf's dtype) and cast to int8 (toward zero, as XLA converts), with the
    tree of those scales.  The scale is taken as a product with ``1 / 127``,
    as XLA compiles the reference's ``/ 127.0``, so that it equals the
    compiled reference's bit for bit (a quotient differs in the last bit of
    a few float32 scales).  A tensor is a tree of one leaf."""
    if method is None:
        return tree, None
    if method == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), tree), None
    if method == "int8":
        leaves, treedef = tree_flatten(tree)
        scales = [torch.clamp_min(g.abs().amax(), 1e-9) * (1.0 / 127.0)
                  for g in leaves]
        qs = [(g / s).to(torch.int8) for g, s in zip(leaves, scales)]
        return tree_unflatten(treedef, qs), tree_unflatten(treedef, scales)
    raise ValueError(f"unknown compression {method!r}")


def decompress_grads(tree, scales, method: str | None,
                     dtype: torch.dtype = torch.float32):
    """The inverse of :func:`compress_grads` (the reference's
    ``decompress_grads``): leaves cast to ``dtype``, and for int8 times
    their scales."""
    if method is None:
        return tree
    if method == "bf16":
        return tree_map(lambda g: g.to(dtype), tree)
    if method == "int8":
        leaves, treedef = tree_flatten(tree)
        s_leaves, _ = tree_flatten(scales)
        return tree_unflatten(treedef, [g.to(dtype) * s for g, s in
                                        zip(leaves, s_leaves)])
    raise ValueError(f"unknown compression {method!r}")


def axis_groups(mesh: Mesh, axes) -> np.ndarray:
    """``[n_groups, group_size]`` positions: each row the positions that
    share every index but those of ``axes`` (one name or a tuple), in
    ``Mesh.shard_devices``' order (the first axis major); rows by the other
    axes' indices, row-major.  Where ``axes`` is None or empty (a mesh
    without that axis) every position is a group of its own."""
    if axes is None or axes == ():
        return np.arange(mesh.size).reshape(-1, 1)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in mesh.axis_names:
            raise ValueError(f"mesh has no axis {a!r}: {mesh.axis_names}")
    names = mesh.axis_names
    rest = [a for a in names if a not in axes]
    order = [names.index(a) for a in (*rest, *axes)]
    size = math.prod(mesh.shape[a] for a in axes)
    return np.arange(mesh.size).reshape(mesh.devices.shape).transpose(
        order).reshape(-1, size)


def each_position(mesh: Mesh, fn: Callable, *lists) -> list:
    """``fn(*(l[p] for l in lists))`` at each position ``p`` of ``mesh``
    in order, on its device and inside ``observe.at_position(p)``."""
    devs = mesh.devices.ravel()
    out = []
    for p in range(mesh.size):
        with on_device(devs[p]), at_position(p):
            out.append(fn(*(x[p] for x in lists)))
    return out


def all_gather(pieces: Sequence[torch.Tensor], mesh: Mesh, axis,
               dim: int) -> list[torch.Tensor]:
    """``pieces[p]`` is mesh position ``p``'s block of a tensor split along
    ``dim`` over ``axis`` (one name, a tuple, or None for no split); each
    member of a group (:func:`axis_groups`) gets the group's blocks
    concatenated along ``dim`` in group order, assembled on its own device.
    Each block from another member is an ``all-gather`` move."""
    devs = mesh.devices.ravel()
    out: list = [None] * mesh.size
    for group in axis_groups(mesh, axis):
        for p in (int(q) for q in group):
            with at_position(p):
                out[p] = pieces[p] if len(group) == 1 else torch.cat(
                    [send(pieces[int(q)], int(q), p, "all-gather", devs[p])
                     for q in group], dim=dim)
    return out


def _group_sum(pieces, group, kind: str, devs, op=torch.add) -> torch.Tensor:
    """``op`` (a sum by default) of the group's pieces at its first
    position, in group order; each other member's piece is a ``kind`` move
    to it."""
    home = int(group[0])
    with on_device(devs[home]), at_position(home):
        acc = pieces[home]
        for q in (int(r) for r in group[1:]):
            acc = op(acc, send(pieces[q], q, home, kind, devs[home]))
    return acc


def _all_reduce(pieces, mesh: Mesh, axis, op) -> list:
    devs = mesh.devices.ravel()
    out: list = [None] * mesh.size
    for group in axis_groups(mesh, axis):
        total = _group_sum(pieces, group, "all-reduce", devs, op)
        home = int(group[0])
        for p in (int(q) for q in group):
            out[p] = send(total, home, p, "all-reduce", devs[p])
    return out


def psum(pieces: Sequence[torch.Tensor], mesh: Mesh, axis) -> list:
    """The all-reduce sum over ``axis``: each group's pieces summed at its
    first position in group order (in their dtype), the sum placed back on
    every member's device (members on one device share one tensor).  Each
    piece to the first position and each sum back is an ``all-reduce``
    move."""
    return _all_reduce(pieces, mesh, axis, torch.add)


def pmax(pieces: Sequence[torch.Tensor], mesh: Mesh, axis) -> list:
    """The all-reduce max over ``axis``, elementwise, moved as
    :func:`psum` moves its sum (each move an ``all-reduce``); a max is
    exact, so the group's order does not change it."""
    return _all_reduce(pieces, mesh, axis, torch.maximum)


def row_split_lookup(blocks: Sequence[torch.Tensor],
                     rows: Sequence[torch.Tensor], mesh: Mesh, axis) -> list:
    """The lookup GSPMD makes of a row gather from a table whose rows split
    evenly over ``axis`` (``blocks[p]`` position ``p``'s block, member
    ``i`` of its group holding the ``i``-th): each position looks up its
    global row ids ``rows[p]`` (any shape) in its own block, zero where an
    id lies outside it, and an all-reduce over ``axis`` (:func:`psum`)
    adds the members' lookups, exactly one of them non-zero, so that each
    gets ``table[rows[p]]``.  Under autograd each block takes the
    gradient of its own rows only (the ``where`` zeroes the others')."""
    col = [0] * mesh.size
    for group in axis_groups(mesh, axis):
        for i, p in enumerate(group):
            col[int(p)] = i

    def lookup(p, t, r):
        local = r - col[p] * t.shape[0]
        inside = (local >= 0) & (local < t.shape[0])
        # an id outside the block reads some row, which the where zeroes;
        # taken modulo the block rather than clamped to its ends, so that
        # the backward's scatter (which adds those zeros too) does not
        # pile most of a position's ids onto one row, where the card's
        # sort-based scatter sums a row's duplicates one after another
        got = t[local % t.shape[0]]
        return torch.where(inside[..., None], got, got.new_zeros(()))
    return psum(each_position(mesh, lookup, range(mesh.size), blocks, rows),
                mesh, axis)


def reduce_scatter(pieces: Sequence[torch.Tensor], mesh: Mesh, axis,
                   dim: int) -> list:
    """The sum over ``axis`` split along ``dim``: each group's pieces summed
    at its first position in group order, member ``i`` of the group getting
    block ``i`` of the sum (``ceil(n / k)`` a block, the last short or
    empty) on its device.  Each piece to the first position and each block
    back is a ``reduce-scatter`` move."""
    devs = mesh.devices.ravel()
    out: list = [None] * mesh.size
    for group in axis_groups(mesh, axis):
        total = _group_sum(pieces, group, "reduce-scatter", devs)
        home = int(group[0])
        bounds = shard_bounds(total.shape[dim], len(group))
        for i, p in enumerate(int(q) for q in group):
            block = total.narrow(dim, bounds[i][0], bounds[i][1] - bounds[i][0])
            out[p] = send(block, home, p, "reduce-scatter", devs[p])
    return out


def resplit(pieces: Sequence[torch.Tensor], mesh: Mesh, axis, dim: int,
            sizes: Sequence[int]) -> list:
    """Split a tensor anew along ``dim`` within each group along ``axis``:
    the members' pieces are its consecutive blocks in group order, and
    member ``i`` gets the ``sizes[i]`` elements from ``sum(sizes[:i])`` on,
    assembled on its device from the blocks that overlap them.  Nothing
    moves where every piece already has its size; otherwise each part
    taken from another member is an ``all-to-all`` move."""
    devs = mesh.devices.ravel()
    out: list = [None] * mesh.size
    for group in axis_groups(mesh, axis):
        members = [int(q) for q in group]
        have = [pieces[q].shape[dim] for q in members]
        if list(have) == list(sizes):
            for q in members:
                out[q] = pieces[q]
            continue
        starts = np.cumsum([0] + have)
        lo = 0
        for i, p in enumerate(members):
            hi = lo + sizes[i]
            parts = []
            with at_position(p):
                for j, q in enumerate(members):
                    a, b = max(lo, starts[j]), min(hi, starts[j + 1])
                    if a >= b:
                        continue
                    part = pieces[q].narrow(dim, int(a - starts[j]), int(b - a))
                    parts.append(send(part, q, p, "all-to-all", devs[p]))
                if len(parts) == 1:
                    out[p] = parts[0]
                elif parts:
                    out[p] = torch.cat(parts, dim=dim)
                else:
                    shape = list(pieces[p].shape)
                    shape[dim] = 0
                    out[p] = pieces[p].new_empty(shape)
            lo = hi
    return out


def psum_mean_compressed(trees: Sequence, mesh: Mesh, axis_name,
                         method: str | None = None) -> list:
    """The data-parallel mean with optional on-the-wire compression, the
    reference's ``psum_mean_compressed`` over ``mesh`` in one process.

    ``trees[p]`` is mesh position ``p``'s tree (flat row-major, its leaves
    on ``mesh.devices.flat[p]``); every tree has one structure.
    ``axis_name`` is a mesh axis or a tuple of them; the positions that
    differ only along it form a group (:func:`axis_groups`).  Leaf by
    leaf, each member compresses its leaf (:func:`compress_grads`), the
    compressed leaf moves to the group's first position, which casts it to
    float32 and sums in group order, divides by the group's size and, for
    int8, multiplies by the group's largest scale (the reference's
    ``pmax``); the mean then moves to each member's device.  Returns one
    tree of float32 means per position, in position order; members on one
    device share one tensor.  Every move between positions is reported as
    an ``all-reduce`` (``observe.note_move``)."""
    if len(trees) != mesh.size:
        raise ValueError(f"{len(trees)} trees for a mesh of {mesh.size} "
                         "positions")
    groups = axis_groups(mesh, axis_name)
    flat = [tree_flatten(t) for t in trees]
    treedef = flat[0][1]
    if any(str(d) != str(treedef) for _, d in flat):
        raise ValueError("the positions' trees differ in structure")
    devs = mesh.devices.ravel()
    out = [[None] * treedef.n_leaves for _ in range(mesh.size)]
    for group in groups:
        home = int(group[0])
        dev = devs[home]
        for i in range(treedef.n_leaves):
            acc = smax = None
            for p in (int(q) for q in group):
                with at_position(p):
                    q, s = compress_grads(flat[p][0][i], method)
                if p != home:
                    note_move("all-reduce", p, home, q.nbytes + (
                        0 if s is None else s.nbytes))
                with on_device(dev), at_position(home):
                    if acc is None:
                        acc = q.to(dev, torch.float32, copy=True)
                    else:
                        acc.add_(q.to(dev))
                    if s is not None:
                        s = s.to(dev)
                        smax = s if smax is None else torch.maximum(smax, s)
            with on_device(dev), at_position(home):
                acc.div_(len(group))
                if smax is not None:
                    acc.mul_(smax)
            for p in (int(q) for q in group):
                if p != home:
                    note_move("all-reduce", home, p, acc.nbytes)
                out[p][i] = acc.to(devs[p])
    return [tree_unflatten(treedef, leaves) for leaves in out]


def ring_pair_count(blocks: Sequence[torch.Tensor],
                    devices: Sequence[torch.device], pair_fn: Callable,
                    *, half_ring: bool = False,
                    wire_dtype: torch.dtype | None = None,
                    positions: Sequence[int] | None = None) -> torch.Tensor:
    """Blocked-Gram ring over ``devices``: ``blocks[k]`` is device k's
    row-block (on ``devices[k]``).  At step ``s`` device ``me`` holds the
    block of ``their = (me - s) % n`` and adds ``pair_fn(mine, theirs, me,
    their, symmetric)``; the devices' totals are summed on ``devices[0]``
    in device order.

    ``half_ring=True`` visits each unordered block pair once: ``n // 2 +
    1`` steps, and at even ``n`` the antipodal pair (step ``n / 2``) is
    counted only by its lower index.  ``wire_dtype`` (int8 for 0/1 blocks)
    is the dtype the blocks travel in; each partial is computed in the
    block's own dtype.  ``positions`` names the ring's mesh positions
    (default ``0 .. n - 1``): each step's moves are reported as a
    ``collective-permute``, the sum on the first as an ``all-reduce`` (it
    stands for the reference's ``psum``)."""
    n = len(blocks)
    if n == 0 or len(devices) != n:
        raise ValueError(f"{n} blocks need as many devices, got "
                         f"{len(devices)}")
    pos = list(range(n)) if positions is None else list(positions)
    if len(pos) != n:
        raise ValueError(f"{n} blocks need as many positions, got {len(pos)}")
    steps = n // 2 + 1 if half_ring else n
    wire = []
    for k, b in enumerate(blocks):
        with at_position(pos[k]):
            wire.append(b if wire_dtype is None else b.to(wire_dtype))
    totals: list[torch.Tensor | None] = [None] * n
    for s in range(steps):
        if s:
            # the collective permute: device i receives device i - 1's block
            for i in range(n):
                note_move("collective-permute", pos[(i - 1) % n], pos[i],
                          wire[(i - 1) % n].nbytes)
            wire = [wire[(i - 1) % n].to(devices[i], non_blocking=True)
                    for i in range(n)]
        for me in range(n):
            their = (me - s) % n
            if half_ring and not (s < (n + 1) // 2 or me < their):
                continue
            with on_device(devices[me]), at_position(pos[me]):
                part = pair_fn(blocks[me], wire[me].to(blocks[me].dtype), me,
                               their, half_ring)
                totals[me] = part if totals[me] is None else totals[me] + part
    home = devices[0]
    with at_position(pos[0]):
        total = totals[0]
        for k, t in enumerate(totals[1:], 1):
            note_move("all-reduce", pos[k], pos[0], t.nbytes)
            total = total + t.to(home)
    return total


def all_to_all(sends: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> list[torch.Tensor]:
    """``sends[o]`` ``[n, ...]`` lies on ``devices[o]``; device ``d``
    receives ``sends[o][d]`` from each ``o``, moved with
    ``.to(devices[d])`` (a no-op where both are one device), stacked in
    device order: ``[n, ...]`` on ``devices[d]``.  Autograd flows through
    the moves.  Each chunk is reported as an ``all-to-all`` move from
    position ``o`` to ``d`` (the list's order), its own chunk included, as
    XLA counts the op's result."""
    n = len(sends)
    if len(devices) != n or any(s.shape[0] != n for s in sends):
        raise ValueError(f"{n} sends of leading dim {[s.shape[0] for s in sends]} "
                         f"over {len(devices)} devices")
    out = []
    for d in range(n):
        for o in range(n):
            note_move("all-to-all", o, d, sends[o][d].nbytes)
        with at_position(d):
            out.append(torch.stack([sends[o][d].to(devices[d],
                                                   non_blocking=True)
                                    for o in range(n)]))
    return out
