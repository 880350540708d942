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
    ``shardings`` must be None: placing a batch over a mesh waits for LM
    sharding (ROADMAP Queue 1 item 3)."""
    if shardings is not None:
        raise NotImplementedError(
            "sharding a batch over a mesh is not ported yet (ROADMAP Queue 1 "
            "item 3); pass shardings=None")
    dev = resolve_device(device)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return torch.as_tensor(np.asarray(x), device=dev)
    return put(batch)


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
