"""Host oracle for the dynamic wire format: naive sequential replay (the
port's numpy copy of ``repro.streams.oracle``).

:func:`replay_dynamic` re-implements the engine's semantics — adaptive
window closes (Algorithm 3), delete resolution against the open window,
the ``on_missing_delete`` policy, and both duplicate policies — as the
dumbest possible program: one Python loop over records with a dict ledger.
No vectorization, no segmented cumsums, no shared code with the engine's
windowizer.  That independence is the point: the differential tests and
``chip_smoke.py`` replay the same dynamic stream through both
implementations and demand identical windows, so a bug in the engine's
clever path has to be mirrored by an identical bug in this loop to slip
through.

Semantics mirrored (see :mod:`repro_torch.streams.state` for the engine
side):

* A window closes when the ``nt_w + 1``-th unique timestamp arrives; its
  ``end_tau`` is the last record's timestamp inside it.
* A delete retracts one multiplicity of its edge from the *open* window's
  ledger.  If the edge's net multiplicity is already zero the delete
  either raises (``on_missing_delete="raise"``) or becomes a no-op record
  (``"ignore"`` — the clamped-at-zero walk).
* ``n_sgrs`` (the window's ``|E_k|`` contribution) is the net delta sum:
  inserts minus applied deletes, ignored deletes contributing zero.
* At window close the ledger resolves to the unique surviving edges
  (net > 0) in packed-key order with their net multiplicities — a fully
  retracted window resolves to zero edges but still closes.
* The trailing window survives :func:`replay_dynamic`'s end-of-stream iff
  it has records and either filled its quota or ``drop_partial=False``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.butterfly import count_butterflies_multiset_np, count_butterflies_np
from .wire import OP_DELETE, OP_INSERT, normalize_records

__all__ = ["OracleWindow", "replay_dynamic", "oracle_window_counts",
           "OP_INSERT", "OP_DELETE"]


@dataclass
class OracleWindow:
    """One closed window as the oracle sees it.

    edges  : int64 [m, 2]  unique surviving edges, packed-key order
    mult   : int64 [m]     net multiplicity of each surviving edge
    n_sgrs : int           net delta sum (the window's |E_k| contribution)
    end_tau: float         timestamp of the window's last record
    """

    edges: np.ndarray
    mult: np.ndarray
    n_sgrs: int
    end_tau: float


def replay_dynamic(tau, edge_i, edge_j, op=None, *, nt_w: int,
                   on_missing_delete: str = "raise",
                   drop_partial: bool = True) -> list[OracleWindow]:
    """Naively replay a dynamic ``(op, tau, i, j)`` stream into its closed
    windows.  ``op=None`` means all inserts (the static wire format).
    Raises ``ValueError`` on decreasing timestamps or (under ``"raise"``)
    on a delete of an absent edge — same contracts as the engine."""
    if nt_w <= 0:
        raise ValueError("nt_w must be positive")
    if on_missing_delete not in ("raise", "ignore"):
        raise ValueError(
            "on_missing_delete must be 'raise' or 'ignore', got "
            f"{on_missing_delete!r}")
    # shared wire normalization (shape/dtype/op-range) — the oracle stays
    # independent of the engine's *windowizer*, not of the wire schema
    rb = normalize_records(tau, edge_i, edge_j, op=op)
    tau, ei, ej = rb.tau, rb.edge_i, rb.edge_j
    ops = (np.zeros(rb.n, dtype=np.int64) if rb.op is None else rb.op)

    windows: list[OracleWindow] = []
    ledger: dict[tuple[int, int], int] = {}
    net_sum = 0
    n_records = 0
    uniq = 0
    prev_tau: float | None = None
    end_tau = 0.0

    def close() -> None:
        nonlocal net_sum, n_records
        items = sorted(k for k, v in ledger.items() if v > 0)
        edges = (np.array(items, dtype=np.int64) if items
                 else np.zeros((0, 2), dtype=np.int64))
        mult = np.array([ledger[k] for k in items], dtype=np.int64)
        windows.append(OracleWindow(edges, mult, net_sum, end_tau))
        ledger.clear()
        net_sum = 0
        n_records = 0

    for t, i, j, o in zip(tau, ei, ej, ops):
        t, i, j, o = float(t), int(i), int(j), int(o)
        if prev_tau is not None and t < prev_tau:
            raise ValueError("timestamps must be non-decreasing")
        if prev_tau is None or t != prev_tau:
            if uniq == nt_w:     # this record opens the next window
                close()
                uniq = 0
            uniq += 1
        prev_tau = t
        end_tau = t
        n_records += 1
        key = (i, j)
        if o == OP_DELETE:
            if ledger.get(key, 0) <= 0:
                if on_missing_delete == "raise":
                    raise ValueError(
                        f"delete of edge ({i}, {j}) targets an edge absent "
                        "from its window")
                continue     # ignored: a no-op record
            ledger[key] -= 1
            net_sum -= 1
        else:  # OP_INSERT — normalize_records already rejected other codes
            ledger[key] = ledger.get(key, 0) + 1
            net_sum += 1

    if n_records and (uniq >= nt_w or not drop_partial):
        close()
    return windows


def oracle_window_counts(windows: list[OracleWindow],
                         dup_policy: str = "distinct") -> np.ndarray:
    """Exact per-window butterfly counts of an oracle replay under a
    duplicate policy — ``distinct`` counts the surviving edge *set*,
    ``multiset`` weighs each butterfly by its edges' net multiplicities."""
    out = np.zeros(len(windows), dtype=np.float64)
    for k, w in enumerate(windows):
        if w.edges.shape[0] == 0:
            continue
        if dup_policy == "multiset":
            out[k] = count_butterflies_multiset_np(w.edges, w.mult)
        else:
            out[k] = count_butterflies_np(w.edges)
    return out
