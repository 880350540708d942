"""The port's host data pipeline against the reference's: ``Prefetcher``'s
order, transform and error, ``token_batches`` bit for bit, and
``shard_batch`` onto a device."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import token_batches as j_token_batches  # noqa: E402
from repro_torch.data import Prefetcher, shard_batch, token_batches  # noqa: E402


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetcher_keeps_order(depth):
    assert list(Prefetcher(iter(range(50)), depth=depth)) == list(range(50))


def test_prefetcher_applies_the_transform():
    got = list(Prefetcher(iter(range(10)), transform=lambda x: x * x))
    assert got == [x * x for x in range(10)]


def test_prefetcher_raises_the_workers_error_after_the_good_items():
    def items():
        yield 1
        yield 2
        raise KeyError("boom")

    it = Prefetcher(items())
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(KeyError, match="boom"):
        next(it)


@pytest.mark.parametrize("vocab,batch,seq,seed,copy_p", [
    (512, 4, 16, 0, 0.5), (50_000, 2, 33, 7, 0.0), (97, 3, 8, 123, 0.9)])
def test_token_batches_equal_the_reference_bit_for_bit(vocab, batch, seq,
                                                       seed, copy_p):
    got = token_batches(vocab, batch, seq, seed=seed, copy_p=copy_p)
    want = j_token_batches(vocab, batch, seq, seed=seed, copy_p=copy_p)
    for g, w in itertools.islice(zip(got, want), 3):
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


def test_shard_batch_puts_the_tree_on_the_device():
    host = {"tokens": np.arange(6, dtype=np.int32).reshape(2, 3),
            "more": [np.ones(2, np.float32)]}
    got = shard_batch(host, device="cpu")
    assert isinstance(got["tokens"], torch.Tensor)
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), host["tokens"])
    assert got["more"][0].dtype == torch.float32


def test_shard_batch_refuses_shardings():
    """Shardings place every leaf on their mesh (the placement itself:
    ``tests/test_torch_mesh_train.py``), so they take no ``device=``, and
    a tree of them must name a ``NamedSharding``."""
    with pytest.raises(ValueError, match="no device="):
        shard_batch({"x": np.zeros(2)}, {"x": "spec"}, device="cpu")
    with pytest.raises(ValueError, match="names no NamedSharding"):
        shard_batch({"x": np.zeros(2)}, {"x": None})
