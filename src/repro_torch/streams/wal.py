"""Per-tenant write-ahead log: the serving front end's durability floor.

The port's copy of ``repro.streams.wal``; its files are byte-compatible
with the reference's, so a WAL written by either package's server replays
in the other.

A checkpoint makes acked records durable only up to the moment it was
written; the WAL covers the gap.  Every admitted push is appended here —
keyed by its monotonic per-tenant ``seq`` — and fsynced *before* the ack
leaves the server, so recovery is exact:

    restore newest valid checkpoint  (watermark W_s per tenant)
      + replay WAL records with seq > W_s, in seq order
    == the crash-free engine state, bit for bit

(The engines pin micro-batch-split / checkpoint-cut determinism, so replay
grouping does not matter; WAL payloads are ``records_to_json`` of the
already-normalized batch, and JSON float round-trips are exact.)

Layout and framing
------------------

::

    <root>/tenant_<s>/seg_<first_seq>.wal        # append-only segments

Each record is one length+checksum-framed NDJSON line::

    <payload_len> <crc32_hex> <payload>\\n

where ``payload`` is ``{"seq": N, "records": {...}}`` with no internal
newlines.  A torn tail (crash mid-write) fails the length or CRC check;
:meth:`TenantWAL.replay` stops at the first invalid frame and — with
``repair=True`` — truncates the segment back to its valid prefix so
post-recovery appends continue cleanly.  A bit flip anywhere in a frame is
caught by the CRC.

Write path (one coalesce cycle): ``append()`` buffers frames per tenant;
one ``sync()`` flushes + fsyncs every dirty segment — fsync is batched per
dispatch cycle, not per record, which is what keeps WAL-on throughput
within 2x of WAL-off.

GC: after a checkpoint at watermarks ``W``, segments whose records all have
``seq <= W_s`` are deleted (:meth:`FleetWAL.gc`); the server also GCs at
startup so a crashed process never leaks segments.
"""
from __future__ import annotations

import json
import os
from zlib import crc32

from ..train.fault import fault_point
from .wire import RecordBatch, records_from_json, records_to_json

__all__ = ["WALError", "WALCorruption", "TenantWAL", "FleetWAL"]


class WALError(OSError):
    """IO-level WAL failure (disk full, unwritable dir)."""


class WALCorruption(ValueError):
    """A frame failed its length/CRC check somewhere other than the tail
    of the newest segment — data loss that replay cannot repair silently."""


def _frame(payload: bytes) -> bytes:
    return b"%d %08x %s\n" % (len(payload), crc32(payload), payload)


def _parse_frame(line: bytes):
    """``(payload_bytes, ok)`` — ``ok`` False for torn/corrupt frames."""
    if not line.endswith(b"\n"):
        return None, False          # torn tail: no terminator
    try:
        length_b, crc_b, payload = line[:-1].split(b" ", 2)
        length = int(length_b)
        crc = int(crc_b, 16)
    except ValueError:
        return None, False
    if len(payload) != length or crc32(payload) != crc:
        return None, False
    return payload, True


class TenantWAL:
    """Append-only framed segment log of one tenant (see module doc)."""

    def __init__(self, root: str, stream_id: int, *,
                 segment_bytes: int = 4 << 20, fsync: bool = True):
        if segment_bytes < 1:
            raise ValueError("segment_bytes must be >= 1")
        self.stream_id = int(stream_id)
        self.dir = os.path.join(root, f"tenant_{self.stream_id:04d}")
        os.makedirs(self.dir, exist_ok=True)
        self.segment_bytes = int(segment_bytes)
        self.fsync = bool(fsync)
        self._fh = None                  # current segment file handle
        self._fh_path: str | None = None
        self._fh_size = 0
        self._dirty = False
        # (path, first_seq, last_seq) of sealed + current segments, for GC
        self._segments: list[list] = []
        self.appended = 0
        self.replayed = 0
        self.bytes_written = 0

    # -- write path ----------------------------------------------------------

    def _open_segment(self, first_seq: int) -> None:
        path = os.path.join(self.dir, f"seg_{first_seq:012d}.wal")
        self._fh = open(path, "ab")
        self._fh_path = path
        self._fh_size = self._fh.tell()
        self._segments.append([path, first_seq, first_seq - 1])

    def append(self, seq: int, rb: RecordBatch) -> None:
        """Buffer one record; not durable until :meth:`sync`.  Raises
        :class:`WALError` on IO failure (nothing is acked then)."""
        payload = json.dumps(
            {"seq": int(seq), "records": records_to_json(rb)},
            separators=(",", ":")).encode()
        frame = _frame(payload)
        try:
            fault_point("disk_full")   # injected ENOSPC -> WALError
            if self._fh is None or self._fh_size >= self.segment_bytes:
                if self._fh is not None:
                    self._sync_fh()      # seal the old segment durably
                    self._fh.close()
                    self._fh = None
                self._open_segment(int(seq))
            self._fh.write(frame)
        except OSError as e:
            raise WALError(f"WAL append failed for tenant "
                           f"{self.stream_id}: {e}") from e
        self._fh_size += len(frame)
        self._segments[-1][2] = int(seq)
        self._dirty = True
        self.appended += 1
        self.bytes_written += len(frame)

    def _sync_fh(self) -> None:
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def sync(self) -> bool:
        """Make every buffered append durable; returns True if anything
        was flushed.  Raises :class:`WALError` on failure."""
        if not self._dirty or self._fh is None:
            return False
        try:
            fault_point("disk_full")   # injected ENOSPC -> WALError
            self._sync_fh()
        except OSError as e:
            raise WALError(f"WAL sync failed for tenant "
                           f"{self.stream_id}: {e}") from e
        self._dirty = False
        return True

    # -- recovery ------------------------------------------------------------

    def _segment_paths(self) -> list[str]:
        names = sorted(n for n in os.listdir(self.dir)
                       if n.startswith("seg_") and n.endswith(".wal"))
        return [os.path.join(self.dir, n) for n in names]

    def replay(self, *, repair: bool = True):
        """Yield ``(seq, RecordBatch)`` for every valid record, in order.

        The first invalid frame of the *newest* segment is a torn tail:
        replay stops there and (with ``repair=True``) the segment is
        truncated to its valid prefix.  An invalid frame in an older
        segment raises :class:`WALCorruption` — records after it were
        acked and would be silently lost.  Rebuilds the in-memory segment
        index, so post-replay appends and GC see recovered state.
        """
        self._segments = []
        paths = self._segment_paths()
        for pi, path in enumerate(paths):
            newest = pi == len(paths) - 1
            valid_bytes = 0
            entry = None
            with open(path, "rb") as f:
                for line in f:
                    payload, ok = _parse_frame(line)
                    if not ok:
                        if not newest:
                            raise WALCorruption(
                                f"corrupt frame mid-WAL in {path} at byte "
                                f"{valid_bytes} (not the newest segment)")
                        break
                    obj = json.loads(payload)
                    seq = int(obj["seq"])
                    rb = records_from_json(obj["records"],
                                           stream_id=self.stream_id)
                    valid_bytes += len(line)
                    if entry is None:
                        entry = [path, seq, seq]
                        self._segments.append(entry)
                    entry[2] = seq
                    self.replayed += 1
                    yield seq, rb
            actual = os.path.getsize(path)
            if actual != valid_bytes and repair:
                with open(path, "ab") as f:
                    f.truncate(valid_bytes)
                    f.flush()
                    os.fsync(f.fileno())
            if entry is None and repair and valid_bytes == 0:
                os.unlink(path)          # fully-torn segment: drop it
        # appends resume in a fresh segment keyed by their first seq (the
        # truncated tail segment stays sealed), keeping first_seq naming
        # exact for GC

    # -- GC ------------------------------------------------------------------

    def gc(self, watermark: int) -> int:
        """Delete segments whose every record has ``seq <= watermark``
        (they are covered by the checkpoint).  Returns segments removed."""
        keep: list[list] = []
        removed = 0
        for entry in self._segments:
            path, first, last = entry
            if last <= watermark and path != self._fh_path:
                try:
                    os.unlink(path)
                    removed += 1
                except OSError:
                    keep.append(entry)
            else:
                keep.append(entry)
        self._segments = keep
        return removed

    @property
    def n_segments(self) -> int:
        return len(self._segments)

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._sync_fh()
            except OSError:
                pass
            self._fh.close()
            self._fh = None


class FleetWAL:
    """The serving front end's view: one :class:`TenantWAL` per stream,
    one batched ``sync()`` per coalesce cycle."""

    def __init__(self, root: str, n_streams: int, *,
                 segment_bytes: int = 4 << 20, fsync: bool = True):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.tenants = [TenantWAL(root, s, segment_bytes=segment_bytes,
                                  fsync=fsync)
                        for s in range(int(n_streams))]
        self.synced_batches = 0

    def append(self, stream_id: int, seq: int, rb: RecordBatch) -> None:
        self.tenants[stream_id].append(seq, rb)

    def sync(self) -> None:
        """One fsync pass over every dirty tenant segment — the batched
        group commit for the cycle."""
        any_flushed = False
        for t in self.tenants:
            any_flushed |= t.sync()
        if any_flushed:
            self.synced_batches += 1

    def replay(self, stream_id: int, *, repair: bool = True):
        return self.tenants[stream_id].replay(repair=repair)

    def gc(self, watermarks) -> int:
        return sum(t.gc(int(w)) for t, w in zip(self.tenants, watermarks))

    def stats(self) -> dict:
        return {
            "appended": sum(t.appended for t in self.tenants),
            "replayed": sum(t.replayed for t in self.tenants),
            "bytes": sum(t.bytes_written for t in self.tenants),
            "synced_batches": self.synced_batches,
            "segments": sum(t.n_segments for t in self.tenants),
        }

    def close(self) -> None:
        for t in self.tenants:
            t.close()
