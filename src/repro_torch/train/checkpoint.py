"""Fault-tolerant checkpointing: atomic, CRC-checked, async.

The port's copy of ``repro.train.checkpoint``, writing the same layout, so a
checkpoint directory written by either package restores in the other::

    <dir>/step_<N>/
      manifest.json   step, tree structure, array metadata, extra state
      arrays.npz      flat leaf arrays (host numpy), arr_0 ... arr_{n-1}

The reference flattens with ``jax.tree.flatten`` and pairs the stored leaves
with a template's by position and count only.  :func:`tree_flatten` here
gives the same leaf order without JAX: dict keys sorted, lists and tuples in
order, ``None`` an empty node that yields no leaf, anything else a leaf.

Atomicity: written to ``<dir>/.tmp_step_<N>`` then ``os.rename``'d; both
files are fsynced before the rename and the parent directory after it, so a
SIGKILL at any point leaves either the previous step or a complete new one.
Integrity: the manifest records a CRC32 of ``arrays.npz``;
:func:`verify_checkpoint` checks it and :func:`restore_latest_valid` walks
steps newest-first past any truncated, bit-flipped or corrupt step.
``save_checkpoint`` traverses the ``disk_full`` and ``pre_checkpoint_rename``
fault points (:mod:`repro_torch.streams.faults`); :func:`gc_tmp_dirs` sweeps
the stale ``.tmp_step_*`` dirs a crash between them leaves.  Restore returns
numpy leaves (``host=True``, at the template's dtypes, 64-bit widths kept)
or torch tensors on ``device`` (default ``cuda``).  A bf16 leaf is stored
as the 2-byte records of its bits (``|V2``), which is how ``np.savez``
stores the reference's bf16 leaves.  ``AsyncCheckpointer``
runs saves on a worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any
from zlib import crc32

import numpy as np
import torch

from ..arrays import BF16_BITS, tensor_from_numpy, tensor_to_numpy
from ..device import resolve_device
from .fault import fault_point

__all__ = [
    "TreeDef",
    "tree_flatten",
    "tree_unflatten",
    "tree_map",
    "save_checkpoint",
    "restore_checkpoint",
    "restore_latest_valid",
    "verify_checkpoint",
    "valid_steps",
    "latest_step",
    "gc_tmp_dirs",
    "CheckpointCorruption",
    "AsyncCheckpointer",
]


class CheckpointCorruption(ValueError):
    """A step directory failed verification (missing file, bad JSON, CRC
    mismatch, leaf-count drift)."""


# -- a flatten with jax.tree's leaf order -------------------------------------


class TreeDef:
    """The structure :func:`tree_flatten` took apart: ``kind`` is ``leaf``,
    ``none``, ``dict`` (``meta`` = the sorted keys), ``list``, ``tuple`` or
    ``namedtuple`` (``meta`` = its class).  ``str()`` reads as jax's
    ``PyTreeDef`` string of the same tree."""

    __slots__ = ("kind", "meta", "children", "n_leaves")

    def __init__(self, kind: str, meta=None, children=()):
        self.kind = kind
        self.meta = meta
        self.children = tuple(children)
        self.n_leaves = (1 if kind == "leaf" else
                         sum(c.n_leaves for c in self.children))

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}" for k, v in
                                   zip(self.meta, inner)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        if self.kind == "tuple":
            return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") \
                + ")"
        return f"CustomNode(namedtuple[{self.meta.__name__}], [" \
            + ", ".join(inner) + "])"

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"

    __repr__ = __str__


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree.flatten``'s order."""
    leaves: list = []

    def walk(x) -> TreeDef:
        if x is None:
            return TreeDef("none")
        if isinstance(x, dict):
            keys = sorted(x)
            return TreeDef("dict", tuple(keys), [walk(x[k]) for k in keys])
        if _is_namedtuple(x):
            return TreeDef("namedtuple", type(x), [walk(v) for v in x])
        if isinstance(x, (list, tuple)):
            return TreeDef("list" if isinstance(x, list) else "tuple", None,
                           [walk(v) for v in x])
        leaves.append(x)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Inverse of :func:`tree_flatten`: ``treedef`` filled with ``leaves``
    (exactly ``treedef.n_leaves`` of them)."""
    def build(d: TreeDef):
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        kids = [build(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.meta, kids))
        if d.kind == "list":
            return kids
        if d.kind == "tuple":
            return tuple(kids)
        return d.meta(*kids)

    leaves = list(leaves)
    if len(leaves) != treedef.n_leaves:
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{treedef.n_leaves}")
    it = iter(leaves)
    return build(treedef)


def tree_map(fn, tree) -> Any:
    """``fn`` applied to each leaf of ``tree`` (:func:`tree_flatten`'s
    leaves), the structure kept: ``jax.tree.map`` over one tree."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return tensor_to_numpy(x)
    return np.asarray(x)


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return BF16_BITS
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


# -- the on-disk format ------------------------------------------------------


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = crc32(chunk, crc)
    return crc


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: dict | None = None) -> str:
    """Write ``tree``'s leaves and ``extra`` as step ``step`` atomically;
    returns the step's directory."""
    fault_point("disk_full")
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, treedef = tree_flatten(tree)
    host = [_to_host(x) for x in leaves]
    arrays_path = os.path.join(tmp, "arrays.npz")
    with open(arrays_path, "wb") as f:
        np.savez(f, *host)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "treedef": str(treedef),
        "n_leaves": len(host),
        "shapes": [list(a.shape) for a in host],
        "dtypes": [str(a.dtype) for a in host],
        "crc32_arrays": f"{_file_crc32(arrays_path):08x}",
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    fault_point("pre_checkpoint_rename")
    os.rename(tmp, final)
    # fsync the parent dir so the rename itself survives a power cut
    dfd = os.open(ckpt_dir, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return final


def valid_steps(ckpt_dir: str) -> list[int]:
    """Every step under ``ckpt_dir``, ascending: existence only; use
    :func:`verify_checkpoint` for integrity."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def gc_tmp_dirs(ckpt_dir: str) -> list[str]:
    """Remove stale ``.tmp_step_*`` dirs (a crash between tmp-write and
    rename leaves one).  Returns the paths removed."""
    if not os.path.isdir(ckpt_dir):
        return []
    removed = []
    for d in os.listdir(ckpt_dir):
        if d.startswith(".tmp_step_"):
            path = os.path.join(ckpt_dir, d)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def verify_checkpoint(ckpt_dir: str, step: int) -> dict:
    """Integrity-check one step; returns its manifest or raises
    :class:`CheckpointCorruption`.  A checkpoint without ``crc32_arrays``
    is verified structurally (files parse and load, and the leaf count
    matches the manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruption(f"{path}: unreadable manifest: {e}") from e
    arrays_path = os.path.join(path, "arrays.npz")
    want_crc = manifest.get("crc32_arrays")
    if want_crc is not None:
        try:
            got = f"{_file_crc32(arrays_path):08x}"
        except OSError as e:
            raise CheckpointCorruption(f"{path}: unreadable arrays: {e}") from e
        if got != want_crc:
            raise CheckpointCorruption(
                f"{path}: arrays.npz CRC mismatch "
                f"(manifest {want_crc}, file {got})")
    try:
        with np.load(arrays_path) as data:
            n = len(data.files)
    except (OSError, ValueError) as e:
        raise CheckpointCorruption(f"{path}: arrays.npz unloadable: {e}") from e
    if n != manifest.get("n_leaves"):
        raise CheckpointCorruption(
            f"{path}: {n} arrays vs manifest n_leaves="
            f"{manifest.get('n_leaves')}")
    return manifest


def restore_checkpoint(ckpt_dir: str, template: Any, *,
                       step: int | None = None, device=None,
                       host: bool = False) -> tuple[Any, dict]:
    """Restore into the structure of ``template``; returns ``(tree,
    extra)``.  The stored leaves pair with the template's by position.

    ``host=True`` returns numpy leaves cast to the template's dtypes (the
    streaming engines' ``state_dict`` is host state with 64-bit leaves);
    otherwise each leaf is a torch tensor on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        loaded = [data[k] for k in data.files]
    t_leaves, treedef = tree_flatten(template)
    if len(loaded) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(loaded)} leaves, template expects "
            f"{len(t_leaves)}")
    if host:
        if device is not None:
            raise ValueError("host=True is mutually exclusive with device=")
        placed = [np.asarray(h, dtype=_np_dtype(t))
                  for h, t in zip(loaded, t_leaves)]
    else:
        dev = resolve_device(device)
        placed = [tensor_from_numpy(np.asarray(h, dtype=_np_dtype(t)), dev)
                  for h, t in zip(loaded, t_leaves)]
    return tree_unflatten(treedef, placed), manifest["extra"]


def restore_latest_valid(ckpt_dir: str, template: Any, *, device=None,
                         host: bool = False
                         ) -> tuple[Any, dict, int, list[int]]:
    """Restore the newest step that passes :func:`verify_checkpoint` *and*
    loads against ``template``, skipping corrupt ones newest-first.

    Returns ``(state, extra, step, skipped)`` where ``skipped`` lists the
    corrupt steps passed over.  Raises ``FileNotFoundError`` when no step
    exists and :class:`CheckpointCorruption` when steps exist but none
    loads.
    """
    steps = valid_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    skipped: list[int] = []
    last_err: Exception | None = None
    for step in reversed(steps):
        try:
            verify_checkpoint(ckpt_dir, step)
            state, extra = restore_checkpoint(
                ckpt_dir, template, step=step, device=device, host=host)
            return state, extra, step, skipped
        except (CheckpointCorruption, OSError, ValueError) as e:
            skipped.append(step)
            last_err = e
    raise CheckpointCorruption(
        f"no valid checkpoint under {ckpt_dir}: all of {steps} failed "
        f"(last error: {last_err})")


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one save in flight:
    a new save waits for the previous one (one host copy outstanding), and
    a failed save raises on the next :meth:`wait` or :meth:`save`."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> None:
        self.wait()
        leaves, treedef = tree_flatten(tree)
        host = tree_unflatten(treedef, [_to_host(x) for x in leaves])

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host, extra=extra)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        for s in valid_steps(self.ckpt_dir)[: -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
