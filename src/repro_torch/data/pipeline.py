"""Host data pipeline: batching, background prefetch, device put (the port
of ``repro.data.pipeline``).

The training loop consumes an iterator of batches already on the device;
a single background thread keeps ``depth`` batches in flight so host
batch assembly overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["Prefetcher", "shard_batch", "token_batches"]


def shard_batch(batch, shardings=None, *, device=None):
    """A host batch (a dict or list tree of arrays) as tensors on ``device``
    (default ``cuda``; raises without a card unless ``device="cpu"``).

    With ``shardings`` (a tree of the batch's structure whose leaves are
    ``distributed.NamedSharding`` or None; a dict of shardings may name
    only some of the batch's keys, a leaf it does not name counting as
    None) each leaf is placed by its sharding as a ``ShardedTensor``
    (``NamedSharding.put``: each position's slice on its device, split as
    GSPMD splits it where its rows do not divide: ``NamedSharding.fitted``,
    as the GNNs' node, edge and triplet arrays over ``"flat"``), the
    counterpart of the reference's ``jax.device_put``; a None leaf is a
    whole tensor on the first device of the shardings' mesh.  It places
    every leaf, so it takes no ``device=``."""
    from ..distributed.sharding import NamedSharding

    if shardings is None:
        dev = resolve_device(device)

        def put(x):
            if isinstance(x, dict):
                return {k: put(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(put(v) for v in x)
            return torch.as_tensor(np.asarray(x), device=dev)
        return put(batch)
    if device is not None:
        raise ValueError("shardings= places every leaf; pass no device=")

    def meshes(s):
        if isinstance(s, NamedSharding):
            return [s.mesh]
        if isinstance(s, dict):
            return [m for v in s.values() for m in meshes(v)]
        if isinstance(s, (list, tuple)):
            return [m for v in s for m in meshes(v)]
        return []
    found = meshes(shardings)
    if not found:
        raise ValueError("shardings names no NamedSharding")
    home = found[0].devices.flat[0]

    def place(x, s):
        if isinstance(x, dict):
            return {k: place(v, s.get(k) if isinstance(s, dict) else s)
                    for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            each = s if isinstance(s, (list, tuple)) else [s] * len(x)
            return type(x)(place(v, t) for v, t in zip(x, each))
        t = torch.as_tensor(np.asarray(x))
        return t.to(home) if s is None else s.fitted(t.shape).put(t)
    return place(batch, shardings)


class Prefetcher:
    """Background-thread prefetch of an iterator (bounded queue)."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Callable | None = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Exception | None = None

        def work():
            try:
                for item in it:
                    self._q.put(transform(item) if transform else item)
            except Exception as e:  # surfaced on next __next__
                self._err = e
            finally:
                self._q.put(self._DONE)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def token_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                  copy_p: float = 0.5) -> Iterator[dict]:
    """Synthetic next-token batches with learnable copy structure (the
    examples' and tests' data source), numpy int32 ``tokens`` and
    ``labels`` ``[batch, seq]``: the reference's draws, so a seed gives its
    batches bit for bit."""
    rng = np.random.default_rng(seed)
    while True:
        base = rng.integers(0, vocab, size=(batch, seq + 1))
        copy = rng.random((batch, seq + 1)) < copy_p
        for t in range(1, seq + 1):
            base[:, t] = np.where(copy[:, t], base[:, t - 1], base[:, t])
        yield {"tokens": base[:, :-1].astype(np.int32),
               "labels": base[:, 1:].astype(np.int32)}
