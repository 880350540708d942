"""The one wire schema for stream records: ``(op, stream_id, tau, i, j)``.

The port's copy of the record schema of ``repro.streams.wire``: the engine's
``push()`` and the stream generators normalize through
:func:`normalize_records`, with the same dtypes, shape checks and messages.

========== ======== =======================================================
column     dtype    meaning
========== ======== =======================================================
op         int64    0 = :data:`OP_INSERT`, 1 = :data:`OP_DELETE`; an
                    absent/``None`` lane means *all inserts* (an explicit
                    all-zero lane canonicalizes back to ``None``)
stream_id  int64    owning stream; a scalar tags the whole batch
tau        float64  event timestamp; finite and non-decreasing per stream
                    (enforced by the windowizer, not here)
i          int64    i-vertex (user) id, ``0 <= i < 2**32``
j          int64    j-vertex (item) id, ``0 <= j < 2**32``
========== ======== =======================================================

On the socket (:mod:`repro_torch.streams.server`) a batch is the JSON object
``{"tau": [...], "i": [...], "j": [...], "op": [...]?}``; ``stream_id``
never travels on the wire (the server derives it from the connection's
token).  :func:`records_from_json` / :func:`records_to_json` are that
mapping, and a push message's optional ``"seq"`` (a client-assigned,
1-based, contiguous per-tenant sequence number keying the write-ahead log
and duplicate detection) is validated by :func:`normalize_seq`.  The codec
is the reference's: the same objects, the same ``ValueError`` messages, and
float64 timestamps that round-trip through JSON exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "OP_INSERT",
    "OP_DELETE",
    "RecordBatch",
    "normalize_records",
    "as_columns",
    "WIRE_COLUMNS",
    "records_from_json",
    "records_to_json",
    "normalize_seq",
]

OP_INSERT = 0
OP_DELETE = 1

# canonical column order of the tagged dynamic wire format
WIRE_COLUMNS = ("op", "stream_id", "tau", "i", "j")


@dataclass(frozen=True)
class RecordBatch:
    """A normalized batch of wire records (see module doc for the schema).

    ``op`` is ``None`` for an all-insert batch (the static wire format);
    ``stream_id`` is a plain ``int`` when one tenant owns the whole batch,
    else an int64 array parallel to the other columns.
    """

    tau: np.ndarray
    edge_i: np.ndarray
    edge_j: np.ndarray
    op: np.ndarray | None = None
    stream_id: np.ndarray | int = 0

    @property
    def n(self) -> int:
        return int(self.tau.shape[0])

    @property
    def single_stream(self) -> bool:
        return np.ndim(self.stream_id) == 0


def normalize_records(tau, edge_i, edge_j, op=None, stream_id=0
                      ) -> RecordBatch:
    """Validate and canonicalize raw columns into a :class:`RecordBatch`.

    This is the shared normalization every record consumer used to hand-roll:
    scalars broadcast via ``atleast_1d``, dtypes pinned (float64 tau, int64
    ids/ops), equal-length 1-D shape checks, and the op lane restricted to
    ``{OP_INSERT, OP_DELETE}``.  An explicit all-insert op lane collapses to
    ``None`` so downstream fast paths key on one marker.  Raises
    ``ValueError`` on any violation — messages match the engines' historical
    contracts (``tests/test_streaming_engine.py`` / ``test_multistream.py``
    pin the substrings).
    """
    tau = np.atleast_1d(np.asarray(tau, dtype=np.float64))
    ei = np.atleast_1d(np.asarray(edge_i, dtype=np.int64))
    ej = np.atleast_1d(np.asarray(edge_j, dtype=np.int64))
    if not (tau.shape == ei.shape == ej.shape and tau.ndim == 1):
        raise ValueError("tau/edge_i/edge_j must be equal-length 1-D")
    opa = None
    if op is not None:
        opa = np.atleast_1d(np.asarray(op, dtype=np.int64))
        if opa.shape != tau.shape:
            raise ValueError("op must match tau/edge_i/edge_j in length")
        if opa.size and (opa.min() < OP_INSERT or opa.max() > OP_DELETE):
            raise ValueError(
                f"op must be {OP_INSERT} (insert) or {OP_DELETE} (delete)")
        if not opa.any():
            opa = None  # all-insert lane == static wire format
    if np.ndim(stream_id) == 0:
        sid: np.ndarray | int = int(stream_id)
    else:
        sid = np.atleast_1d(np.asarray(stream_id, dtype=np.int64))
        if sid.shape != tau.shape:
            raise ValueError(
                "stream_ids/tau/edge_i/edge_j must be equal-length 1-D")
    return RecordBatch(tau=tau, edge_i=ei, edge_j=ej, op=opa, stream_id=sid)


def as_columns(tau, edge_i, edge_j, op=None
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Canonical ``(tau, edge_i, edge_j, op)`` column tuple of a record
    batch — the return convention of stream *generators* (which always
    materialize an op lane, zeros for pure-insert streams, so their output
    slices uniformly).  Dtypes as the wire schema."""
    rb = normalize_records(tau, edge_i, edge_j, op=op)
    ops = (np.zeros(rb.n, dtype=np.int64) if rb.op is None
           else rb.op)
    return rb.tau, rb.edge_i, rb.edge_j, ops


def records_from_json(obj, *, stream_id: int = 0) -> RecordBatch:
    """Parse the socket framing's batch object (``{"tau": [...], "i": [...],
    "j": [...], "op": [...]?}``) into a normalized :class:`RecordBatch`
    owned by ``stream_id``.  Raises ``ValueError`` on a malformed object;
    the server turns that into a ``bad_records`` rejection."""
    if not isinstance(obj, dict):
        raise ValueError("records must be an object with tau/i/j columns")
    missing = [c for c in ("tau", "i", "j") if c not in obj]
    if missing:
        raise ValueError(f"records object missing columns {missing}")
    unknown = sorted(set(obj) - {"tau", "i", "j", "op"})
    if unknown:
        raise ValueError(f"records object has unknown columns {unknown}")
    try:
        return normalize_records(obj["tau"], obj["i"], obj["j"],
                                 op=obj.get("op"), stream_id=stream_id)
    except TypeError as e:  # ragged / non-numeric JSON payloads
        raise ValueError(f"records columns must be numeric arrays: {e}")


def normalize_seq(value) -> int | None:
    """Validate a push message's durability sequence number: a positive
    integer (1-based) or ``None`` (absent: the server assigns one).  Bools,
    floats, strings and non-positive values raise ``ValueError``; the
    server turns that into a ``bad_seq`` rejection."""
    if value is None:
        return None
    if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
        raise ValueError(
            f"seq must be a positive integer, got {type(value).__name__}")
    if value < 1:
        raise ValueError(f"seq must be >= 1, got {value}")
    return int(value)


def records_to_json(batch: RecordBatch) -> dict:
    """Inverse of :func:`records_from_json`: the JSON-serializable batch
    object a client puts on the socket.  ``stream_id`` is dropped: on the
    wire, tenancy comes from the connection's token."""
    obj = {
        "tau": [float(t) for t in batch.tau],
        "i": [int(v) for v in batch.edge_i],
        "j": [int(v) for v in batch.edge_j],
    }
    if batch.op is not None:
        obj["op"] = [int(o) for o in batch.op]
    return obj
