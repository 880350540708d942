"""The port's JSON wire codec against the reference's.

``records_from_json`` / ``records_to_json`` / ``normalize_seq`` of
``repro_torch.streams.wire`` must give the reference's objects on seeded
random batches (with and without an op lane), round-trip float64 timestamps
exactly through JSON text, and raise the same ``ValueError`` messages on
malformed input.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.streams import wire as jw  # noqa: E402
from repro_torch.streams import wire as tw  # noqa: E402


def random_batch(seed: int, n: int, with_op: bool):
    rng = np.random.default_rng(seed)
    tau = np.sort(rng.uniform(0, 1e6, n)) + rng.uniform(0, 1, n)
    ei = rng.integers(0, 2**32, n, dtype=np.int64)
    ej = rng.integers(0, 2**32, n, dtype=np.int64)
    op = rng.integers(0, 2, n) if with_op else None
    return tau, ei, ej, op


def assert_same_batch(a, b):
    np.testing.assert_array_equal(a.tau, b.tau)
    np.testing.assert_array_equal(a.edge_i, b.edge_i)
    np.testing.assert_array_equal(a.edge_j, b.edge_j)
    assert (a.op is None) == (b.op is None)
    if a.op is not None:
        np.testing.assert_array_equal(a.op, b.op)
    assert a.tau.dtype == b.tau.dtype and a.edge_i.dtype == b.edge_i.dtype
    assert a.stream_id == b.stream_id


def test_wire_columns_equal_the_reference():
    assert tw.WIRE_COLUMNS == jw.WIRE_COLUMNS


@pytest.mark.parametrize("seed,n,with_op", [
    (0, 1, False), (1, 37, False), (2, 500, True), (3, 64, True),
    (4, 2048, False)])
def test_codec_equals_the_reference(seed, n, with_op):
    tau, ei, ej, op = random_batch(seed, n, with_op)
    tb = tw.normalize_records(tau, ei, ej, op=op, stream_id=5)
    jb = jw.normalize_records(tau, ei, ej, op=op, stream_id=5)
    obj = tw.records_to_json(tb)
    assert obj == jw.records_to_json(jb)
    # through JSON text and back: float64 timestamps survive exactly
    text = json.dumps(obj, separators=(",", ":"))
    back = tw.records_from_json(json.loads(text), stream_id=5)
    assert_same_batch(back, tb)
    assert_same_batch(back, jw.records_from_json(json.loads(text),
                                                 stream_id=5))


@pytest.mark.parametrize("obj", [
    [1, 2, 3],
    {"tau": [1.0], "i": [1]},
    {"tau": [1.0], "i": [1], "j": [2], "w": [3]},
    {"tau": [1.0, 2.0], "i": [1], "j": [2]},
    {"tau": [1.0], "i": [1], "j": [2], "op": [2]},
    {"tau": [1.0], "i": [1], "j": [2], "op": [0, 1]},
    {"tau": [[1.0], [2.0, 3.0]], "i": [1, 2], "j": [2, 3]},
    {"tau": ["x"], "i": [1], "j": [2]},
    {"tau": [1.0], "i": [None], "j": [2]},
], ids=["not_object", "missing", "unknown", "ragged", "bad_op",
        "op_length", "nested", "string", "null"])
def test_malformed_records_raise_as_the_reference(obj):
    with pytest.raises(ValueError) as want:
        jw.records_from_json(obj)
    with pytest.raises(ValueError) as got:
        tw.records_from_json(obj)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", [None, 1, 7, np.int64(12), 2**40])
def test_normalize_seq_accepts_as_the_reference(value):
    assert tw.normalize_seq(value) == jw.normalize_seq(value)


@pytest.mark.parametrize("value", [0, -3, True, 1.0, "1", [1]])
def test_normalize_seq_rejects_as_the_reference(value):
    with pytest.raises(ValueError) as want:
        jw.normalize_seq(value)
    with pytest.raises(ValueError) as got:
        tw.normalize_seq(value)
    assert str(got.value) == str(want.value)
