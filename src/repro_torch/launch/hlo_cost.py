"""Per-position cost model of a traced step (the port's counterpart of
``repro.launch.hlo_cost``).

The reference parses XLA's optimized HLO text, where a step is one program
per device with loop trip counts, and sums each instruction's cost.  A
torch step has no such text: it is Python that dispatches aten ops one at a
time, on devices a mesh may share.  So the port observes the step while
it runs (on ``meta`` positions in the dry-run: shapes and dtypes, no
memory, no work).  A :class:`CostModel` is a ``TorchDispatchMode`` that
sees every aten op, and an observer (``distributed.observe``) that the
sharded code tells which mesh position is at work, which moves cross
positions and which kernel launches a dispatch cannot see.  Per position
it sums:

  flops        ``2 M N K`` per matmul, by ``torch.utils.flop_counter``'s
               formulas (``mm``, ``bmm``, ``addmm``, convolutions, SDPA), as
               ``analyze_hlo`` counts dots, and the same for ``matmul`` and
               ``einsum``, which reach the mode whole under
               ``inference_mode``; plus each unseen kernel's
               operations as its bound reckons them (K1 on ``meta``: the
               strict upper triangle of each window's Gram)
  bytes        operands plus results of every op; views and allocations
               (``empty``) move nothing and count nothing
  collectives  the bytes each position receives, by kind (XLA's names)
  live bytes   each storage an op makes (not a view, not in place) is live
               at the position that made it from its creation until it is
               released; the peak of each position, past its arguments,
               kept as storages come and go (no log of them: per live
               storage its size and the peak between its creation and the
               next live one's, so that a step's outputs can be left out
               of the peak afterwards)

A backward's ops count at the position whose forward made their autograd
nodes (``distributed.observe`` tags them while an observer watches).  A
step that marks its stages (``observe.note_stage``) leaves a snapshot of
the counts at each mark, so that the work between two marks can be scaled
(:meth:`CostModel.scale`: the train step's one traced microbatch to all of
them), and the work since the last mark can be counted again as if it ran
more times in a row (``observe.note_repeat``, :meth:`CostModel.repeat`:
one traced layer of the LMs' trunk for the layers not traced), its live
bytes included: each repetition starts where the one before ended, rises
as the traced one rose and leaves what it left.

Work outside any position is the mesh's first position's (position 0),
where the port gathers results.  Per device means the busiest position;
the mesh's totals come beside it.  ``analyze_hlo``'s
``promoted_f32_bytes`` / ``promoted_f32_loop_bytes`` (copies XLA's CPU
backend inserts around bf16 dots) and ``n_computations`` (HLO
computations) have no counterpart in a torch step and are left out.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..distributed.observe import current_position, observing
from ..distributed.sharding import ShardedTensor

__all__ = ["CostModel", "traced"]

_aten = torch.ops.aten
# ops that only allocate: no bytes move
_ALLOCATIONS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
                _aten.new_empty, _aten.new_empty_strided}


def _matmul_flops(a, b, *args, out_val=None, **kwargs) -> float:
    """``2 K`` per output element of ``torch.matmul``."""
    return 2.0 * out_val.numel() * a.shape[-1]


def _einsum_flops(equation, operands, *args, out_val=None, **kwargs) -> float:
    """``2`` per point of the index space of a two-operand ``einsum`` (each
    index's size once; an ellipsis' dims as the output's), ``0`` for
    one operand."""
    if len(operands) < 2:
        return 0.0
    sizes: dict = {}
    for spec, t in zip(equation.replace(" ", "").split("->")[0].split(","),
                       operands):
        letters = spec.replace("...", "")
        lead = t.dim() - len(letters)
        sizes.update(zip(letters, t.shape[lead:] if "..." in spec
                         else t.shape))
        if "..." in spec:
            sizes["..."] = math.prod(t.shape[:lead])
    return 2.0 * math.prod(sizes.values())


# composite ops that reach the dispatch whole under ``inference_mode``
# (serving's steps run under it), where the mode does not see their
# decomposition into ``mm`` / ``bmm``
_COMPOSITE_FLOPS = {_aten.matmul: _matmul_flops, _aten.einsum: _einsum_flops}


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(x, out: list) -> list:
    """The tensors in ``x`` (a tensor, a ``ShardedTensor``'s shards, or
    lists, tuples and dicts of them), appended to ``out`` in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, ShardedTensor):
        out.extend(x.shards)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


class CostModel(TorchDispatchMode):
    """Flops, bytes, collectives and live bytes per mesh position of what
    runs inside ``with traced(n) as model`` (see the module docstring)."""

    def __init__(self, n_positions: int):
        super().__init__()
        self.n = int(n_positions)
        self.flops = [0.0] * self.n
        self.bytes = [0.0] * self.n
        self.received = [defaultdict(int) for _ in range(self.n)]
        self.kernels: dict[str, dict] = {}
        self.n_ops = 0
        self._refs: dict[int, weakref.ref] = {}
        self._mutable: dict = {}
        # live bytes: per position the live storages in the order they were
        # made, a doubly linked list of [prev, next, bytes, top, key, p]
        # where ``top`` is the position's peak from that storage's creation
        # until the next live one's (a freed storage's span joins its
        # predecessor's); the head, bytes 0, spans the time before them
        self.live = [0] * self.n
        self._heads = [[None, None, 0, 0, None, p] for p in range(self.n)]
        self._tails = list(self._heads)
        self._owner: dict[int, list] = {}
        # each position's peak since the last stage mark
        self._top = [0] * self.n
        self._last_stage: str | None = None
        self.stages: dict[str, dict] = {}

    # -- where work happens ----------------------------------------------------
    def _position(self) -> int:
        p = current_position()
        p = 0 if p is None else p
        if not 0 <= p < self.n:
            raise ValueError(f"position {p} outside a mesh of {self.n}")
        return p

    # -- observer protocol (distributed.observe) -------------------------------
    def move(self, kind: str, src: int, dst: int, nbytes: int) -> None:
        self.received[dst][kind] += nbytes

    def kernel(self, name: str, flops: float, nbytes: int) -> None:
        p = self._position()
        self.flops[p] += flops
        self.bytes[p] += nbytes
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0})
        k["launches"] += 1
        k["flops"] += flops

    def stage(self, name: str) -> None:
        """Keep the counts as they stand at the start of stage ``name``."""
        self.stages[name] = self._counts()
        self._top = list(self.live)
        self._last_stage = name

    def repeat(self, since: str, times: int) -> None:
        """Count the work done since the mark of stage ``since`` (the last
        mark) ``times`` more times, as if it ran again that many times in a
        row from here: flops, bytes, moves, kernels and ops, and the live
        bytes (each repetition rises above its start as the traced one rose
        above the mark and ends as much above its start as the traced one
        ended above the mark)."""
        if since != self._last_stage:
            raise ValueError(f"stage {since!r} is not the last mark")
        self.stages["_repeat"] = self._counts()
        self.scale(since, "_repeat", 1 + times)
        del self.stages["_repeat"]
        if times <= 0:
            return
        start = self.stages[since]["live"]
        for p in range(self.n):
            rise = self._top[p] - start[p]
            step = self.live[p] - start[p]
            top = self.live[p] + rise + max(0, (times - 1) * step)
            tail = self._tails[p]
            tail[3] = max(tail[3], top)
            self._top[p] = max(self._top[p], top)
            self.live[p] += times * step

    def _counts(self) -> dict:
        return {"flops": list(self.flops), "bytes": list(self.bytes),
                "received": [dict(r) for r in self.received],
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "n_ops": self.n_ops, "live": list(self.live)}

    def scale(self, start: str, stop: str, factor: float) -> None:
        """Count the work done between the marks of stages ``start`` and
        ``stop`` ``factor`` times in all (flops, bytes, moves, kernels and
        ops; not the live bytes)."""
        a, b = self.stages[start], self.stages[stop]
        more = factor - 1
        for p in range(self.n):
            self.flops[p] += more * (b["flops"][p] - a["flops"][p])
            self.bytes[p] += more * (b["bytes"][p] - a["bytes"][p])
            for kind, n in b["received"][p].items():
                self.received[p][kind] += round(
                    more * (n - a["received"][p].get(kind, 0)))
        for name, k in b["kernels"].items():
            was = a["kernels"].get(name, {"launches": 0, "flops": 0.0})
            mine = self.kernels[name]
            mine["launches"] += round(more * (k["launches"] - was["launches"]))
            mine["flops"] += more * (k["flops"] - was["flops"])
        self.n_ops += round(more * (b["n_ops"] - a["n_ops"]))

    # -- live bytes ---------------------------------------------------------------
    def _made(self, t: torch.Tensor, p: int) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._owner:
            return
        n = st.nbytes()
        live = self.live[p] = self.live[p] + n
        if live > self._top[p]:
            self._top[p] = live
        tail = self._tails[p]
        node = [tail, None, n, live, key, p]
        tail[1] = self._tails[p] = self._owner[key] = node
        self._refs[key] = weakref.ref(st, lambda _, key=key: self._released(key))

    def _released(self, key: int) -> None:
        self._refs.pop(key, None)
        node = self._owner.pop(key, None)
        if node is None:
            return
        prev, nxt, n, top, _, p = node
        self.live[p] -= n
        if top > prev[3]:
            prev[3] = top
        prev[1] = nxt
        if nxt is None:
            self._tails[p] = prev
        else:
            nxt[0] = prev

    def peaks(self, exclude: set = frozenset()) -> list[int]:
        """Each position's peak of live bytes, not counting the storages
        keyed in ``exclude`` (a step's outputs, live to the end): the
        largest span peak less the excluded bytes made by then."""
        out = []
        for head in self._heads:
            peak, gone, node = head[3], 0, head[1]
            while node is not None:
                if node[4] in exclude:
                    gone += node[2]
                peak = max(peak, node[3] - gone)
                node = node[1]
            out.append(peak)
        return out

    # -- the dispatch ---------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        p = self._position()
        self.n_ops += 1
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        in_keys = {_storage_key(t) for t in ins}
        fresh = [t for t in outs if _storage_key(t) not in in_keys]
        packet = func.overloadpacket
        formula = flop_registry.get(packet) or _COMPOSITE_FLOPS.get(packet)
        if formula is not None:
            self.flops[p] += float(formula(*args, **kwargs, out_val=out))
        mutable = self._mutable.get(func)
        if mutable is None:
            mutable = self._mutable[func] = func._schema.is_mutable
        if (fresh or mutable) and packet not in _ALLOCATIONS:
            self.bytes[p] += sum(t.nbytes for t in ins) + sum(
                t.nbytes for t in outs)
        for t in fresh:
            self._made(t, p)
        return out

    # -- summaries -------------------------------------------------------------------
    def collectives(self, p: int | None = None) -> dict:
        """Bytes received by kind at position ``p`` (the mesh's total
        without ``p``), with their ``total``."""
        got: dict[str, int] = defaultdict(int)
        for q, by_kind in enumerate(self.received):
            if p is None or q == p:
                for k, v in by_kind.items():
                    got[k] += v
        out = dict(sorted(got.items()))
        out["total"] = sum(got.values())
        return out

    def busiest(self) -> int:
        """The position with the most flops (then bytes, then the lowest)."""
        return max(range(self.n), key=lambda q: (self.flops[q], self.bytes[q],
                                                 -q))

    def summary(self) -> dict:
        """``analyze_hlo``'s keys for the busiest position, and the
        mesh's totals."""
        p = self.busiest()
        return {
            "flops": self.flops[p],
            "bytes": self.bytes[p],
            "collectives": self.collectives(p),
            "busiest_position": p,
            "positions": self.n,
            "n_ops": self.n_ops,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "mesh": {"flops": sum(self.flops), "bytes": sum(self.bytes),
                     "collectives": self.collectives()},
        }

    def memory(self, argument_bytes, outputs) -> dict:
        """Per-position memory of the step: ``argument_bytes[p]`` (its
        shards of the inputs), the bytes of ``outputs`` (tensors) whose
        storage position ``p``'s ops made, and its peak of live bytes
        other than those outputs.  Returns the figures of the position
        whose total is largest, with that position."""
        out_bytes = [0] * self.n
        out_keys = set()
        for t in _tensors(outputs, []):
            key = _storage_key(t)
            node = self._owner.get(key)
            if node is not None and key not in out_keys:
                out_keys.add(key)
                out_bytes[node[5]] += node[2]
        temp = self.peaks(out_keys)
        totals = [argument_bytes[q] + out_bytes[q] + temp[q]
                  for q in range(self.n)]
        p = max(range(self.n), key=lambda q: (totals[q], -q))
        return {"argument_size_bytes": int(argument_bytes[p]),
                "output_size_bytes": int(out_bytes[p]),
                "temp_size_bytes": int(temp[p]),
                "generated_code_size_bytes": None,
                "position": p}


@contextlib.contextmanager
def traced(n_positions: int):
    """Observe what runs inside on a mesh of ``n_positions``: every aten op
    and every note of ``distributed.observe``."""
    model = CostModel(n_positions)
    with observing(model), model:
        yield model
