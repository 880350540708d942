"""The port's write-ahead log (``repro_torch.streams.wal``) against the
reference's ``repro.streams.wal``.

Segments written by either package replay in the other record for record,
and the same appends give byte-identical segment files.  The port repairs a
torn tail as the reference does, refuses a corrupt frame in an older
segment, rotates and GCs segments against checkpoint watermarks, and turns
an injected ``disk_full`` into a ``WALError``.
"""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.streams import wal as jwal  # noqa: E402
from repro.streams import wire as jw  # noqa: E402
from repro_torch.streams import wal as twal  # noqa: E402
from repro_torch.streams import wire as tw  # noqa: E402
from repro_torch.streams.faults import (  # noqa: E402
    FaultPlan,
    clear_plan,
    install_plan,
)

PKGS = {"port": (twal, tw), "reference": (jwal, jw)}


def batch(wire, seed: int, n: int = 8, *, ops: bool = False):
    rng = np.random.default_rng(seed)
    tau = np.sort(rng.uniform(0, 100, n))
    i = rng.integers(0, 2**32, n)
    j = rng.integers(0, 2**32, n)
    op = rng.integers(0, 2, n) if ops else None
    return wire.normalize_records(tau, i, j, op=op, stream_id=1)


def assert_same(a, b):
    np.testing.assert_array_equal(a.tau, b.tau)
    np.testing.assert_array_equal(a.edge_i, b.edge_i)
    np.testing.assert_array_equal(a.edge_j, b.edge_j)
    assert (a.op is None) == (b.op is None)
    if a.op is not None:
        np.testing.assert_array_equal(a.op, b.op)


def write(pkg, root, n_streams=3, n_seq=12, segment_bytes=900):
    wal, wire = PKGS[pkg]
    fleet = wal.FleetWAL(str(root), n_streams, segment_bytes=segment_bytes)
    sent = {}
    for seq in range(1, n_seq + 1):
        for s in range(n_streams):
            rb = batch(wire, 100 * s + seq, n=5 + seq, ops=seq % 3 == 0)
            fleet.append(s, seq, rb)
            sent[(s, seq)] = rb
        fleet.sync()
    fleet.close()
    return sent


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_segments_replay_across_packages(tmp_path, writer, reader):
    sent = write(writer, tmp_path)
    wal, _ = PKGS[reader]
    fleet = wal.FleetWAL(str(tmp_path), 3, segment_bytes=900)
    for s in range(3):
        got = list(fleet.replay(s))
        assert [seq for seq, _ in got] == list(range(1, 13))
        for seq, rb in got:
            assert_same(rb, sent[(s, seq)])
    assert fleet.stats()["replayed"] == 36
    assert fleet.stats()["segments"] > 3      # rotation happened


def test_same_appends_write_identical_bytes(tmp_path):
    write("port", tmp_path / "t")
    write("reference", tmp_path / "j")
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                   for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "j")
        for d, _, fs in os.walk(tmp_path / "j") for f in fs)
    for rel in files:
        assert (tmp_path / "t" / rel).read_bytes() == \
            (tmp_path / "j" / rel).read_bytes(), rel


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("cut", [1, 7, "half"])
def test_torn_tail_is_repaired(tmp_path, writer, cut):
    """A frame torn mid-write at the tail of the newest segment: the port's
    replay stops before it, truncates the segment to its valid prefix, and
    later appends replay cleanly after it."""
    wal, wire = PKGS[writer]
    w = wal.TenantWAL(str(tmp_path), 0)
    sent = {seq: batch(wire, seq) for seq in range(1, 6)}
    for seq, rb in sent.items():
        w.append(seq, rb)
    w.sync()
    w.close()
    seg = os.path.join(w.dir, sorted(os.listdir(w.dir))[-1])
    size = os.path.getsize(seg)
    with open(seg, "rb") as f:
        last = f.read().splitlines(keepends=True)[-1]
    drop = len(last) // 2 if cut == "half" else cut
    with open(seg, "r+b") as f:
        f.truncate(size - drop)
    t = twal.TenantWAL(str(tmp_path), 0)
    got = list(t.replay())
    assert [seq for seq, _ in got] == [1, 2, 3, 4]
    assert os.path.getsize(seg) == size - len(last)
    t.append(5, tw.normalize_records(sent[5].tau, sent[5].edge_i,
                                     sent[5].edge_j))
    t.sync()
    t.close()
    again = list(jwal.TenantWAL(str(tmp_path), 0).replay(repair=False))
    assert [seq for seq, _ in again] == [1, 2, 3, 4, 5]
    for seq, rb in again:
        assert_same(rb, sent[seq])


def test_corrupt_frame_in_an_older_segment_raises(tmp_path):
    write("reference", tmp_path, n_streams=1)
    w = twal.TenantWAL(str(tmp_path), 0)
    oldest = os.path.join(w.dir, sorted(os.listdir(w.dir))[0])
    with open(oldest, "r+b") as f:
        f.seek(20)
        b = f.read(1)
        f.seek(20)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(twal.WALCorruption, match="not the newest segment"):
        list(w.replay())


def test_gc_removes_covered_segments_only(tmp_path):
    write("port", tmp_path, n_streams=2)
    fleet = twal.FleetWAL(str(tmp_path), 2, segment_bytes=900)
    for s in range(2):
        list(fleet.replay(s))
    before = fleet.stats()["segments"]
    assert fleet.gc([0, 0]) == 0
    removed = fleet.gc([6, 12])
    assert 0 < removed < before
    # what stays still replays every record past the watermark
    again = twal.FleetWAL(str(tmp_path), 2)
    assert [q for q, _ in again.replay(0)][-6:] == list(range(7, 13))
    assert list(again.replay(1)) == []


def test_disk_full_becomes_wal_error(tmp_path):
    w = twal.TenantWAL(str(tmp_path), 0)
    install_plan(FaultPlan({"disk_full": {"action": "disk_full", "at": 2}}))
    try:
        w.append(1, batch(tw, 1))
        with pytest.raises(twal.WALError, match="sync failed"):
            w.sync()
        w.append(2, batch(tw, 2))
        w.sync()
    finally:
        clear_plan()
    w.close()
    assert [q for q, _ in twal.TenantWAL(str(tmp_path), 0).replay()] == [1, 2]
