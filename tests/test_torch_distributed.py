"""The port's Gram-sharded ring counter (``core.distributed``,
``distributed.collectives``) against the JAX package, on repeated CPU
devices in one process.

The reference runs its ring inside ``shard_map`` over a multi-device mesh,
which this process does not have, so the port's ring is held to the
reference's per-block-pair partial (``_pair_partial``) and to its
single-device exact counts (``window_exact_counts``), on grids of odd and
even ring sizes (the half ring skips the antipodal visit at even sizes)
under both schedules.  Every count here stays below 2**24, so counts must
be equal.
"""
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.distributed as jdist  # noqa: E402
from repro.core.butterfly import count_butterflies_dense  # noqa: E402
from repro.core.sgrapp import window_exact_counts  # noqa: E402
from repro.streams import bipartite_pa_stream  # noqa: E402
import repro_torch.core.distributed as tdist  # noqa: E402
from repro_torch.core.butterfly import build_biadjacency  # noqa: E402
from repro_torch.core.executor import _pad_window_axis  # noqa: E402
from repro_torch.distributed.collectives import ring_pair_count  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

CPU = "cpu"
GRIDS = ((2, 4), (1, 2), (1, 3), (1, 4))
SCHEDULES = ((False, None), (True, torch.int8))


@functools.lru_cache(maxsize=None)
def batch():
    s = bipartite_pa_stream(2500, temporal="uniform", n_unique=600, seed=5)
    return s.windowize(40)


@functools.lru_cache(maxsize=None)
def reference_counts():
    return np.asarray(window_exact_counts(batch(), tier="dense"))


def grid_mesh(shape):
    return make_mesh(shape, ("data", "model"), [CPU] * int(np.prod(shape)))


def random_block(rows, n_j, seed, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((rows, n_j)) < density).astype(np.float32)


@pytest.mark.parametrize("symmetric", (False, True))
@pytest.mark.parametrize("my_idx,their_idx", [(0, 0), (0, 1), (1, 0),
                                              (2, 2), (1, 3)])
def test_pair_partial_equals_reference(my_idx, their_idx, symmetric):
    block_rows, n_j = 24, 40
    mine = random_block(block_rows, n_j, seed=my_idx)
    theirs = random_block(block_rows, n_j, seed=10 + their_idx)
    got = tdist._pair_partial(torch.from_numpy(mine), torch.from_numpy(theirs),
                              my_idx, their_idx, symmetric, block_rows)
    want = jdist._pair_partial(jnp.asarray(mine), jnp.asarray(theirs),
                               my_idx, their_idx, symmetric, block_rows)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(want)


def test_pair_partial_batched_equals_one_at_a_time():
    blocks = np.stack([random_block(16, 30, seed=s) for s in range(3)])
    other = np.stack([random_block(16, 30, seed=9 + s) for s in range(3)])
    got = tdist._pair_partial(torch.from_numpy(blocks),
                              torch.from_numpy(other), 0, 1, False, 16)
    for b in range(3):
        one = tdist._pair_partial(torch.from_numpy(blocks[b]),
                                  torch.from_numpy(other[b]), 0, 1, False, 16)
        assert float(got[b]) == float(one)


@pytest.mark.parametrize("n", (1, 2, 3, 4, 5, 6))
@pytest.mark.parametrize("half_ring", (False, True))
def test_ring_visits_each_block_pair_once(n, half_ring):
    """The full ring visits every ordered pair once; the half ring every
    unordered pair once, the antipodal pair at even n from its lower
    index only."""
    seen = []

    def record(mine, theirs, me, their, symmetric):
        assert symmetric == half_ring
        assert torch.equal(theirs, torch.full((1,), float(their)))
        seen.append((me, their))
        return torch.zeros(())

    blocks = [torch.full((1,), float(k)) for k in range(n)]
    ring_pair_count(blocks, [torch.device(CPU)] * n, record,
                    half_ring=half_ring, wire_dtype=torch.int8)
    if half_ring:
        assert sorted(tuple(sorted(p)) for p in seen) == sorted(
            itertools.combinations_with_replacement(range(n), 2))
    else:
        assert sorted(seen) == sorted(itertools.product(range(n), repeat=2))


@pytest.mark.parametrize("half_ring,wire", SCHEDULES)
@pytest.mark.parametrize("n_dev", (1, 2, 3, 4))
def test_distributed_count_dense_equals_reference(n_dev, half_ring, wire):
    wb = batch()
    k = int(np.argmax(wb.n_edges))
    n_i = -(-int(wb.n_i_per_window[k]) // n_dev) * n_dev
    n_j = int(wb.n_j_per_window[k])
    adj = build_biadjacency(torch.from_numpy(wb.edge_i[k]),
                            torch.from_numpy(wb.edge_j[k]),
                            torch.from_numpy(wb.valid[k]), n_i, n_j)
    got = tdist.distributed_count_dense(
        adj, grid_mesh((1, n_dev)), half_ring=half_ring, wire_dtype=wire)
    want = count_butterflies_dense(jnp.asarray(adj.numpy()))
    assert got.dtype == torch.float32 and got.device.type == CPU
    assert float(got) == float(want) == reference_counts()[k]


def test_distributed_count_dense_needs_divisible_rows():
    with pytest.raises(ValueError, match="not divisible"):
        tdist.distributed_count_dense(torch.zeros((5, 4)), grid_mesh((1, 2)))


@pytest.mark.parametrize("half_ring,wire", SCHEDULES)
@pytest.mark.parametrize("shape", GRIDS)
def test_window_counter_equals_reference(shape, half_ring, wire):
    wb = batch()
    lanes = _pad_window_axis(wb.edge_i, wb.edge_j, wb.valid,
                             multiple=shape[0])
    fn = tdist.make_distributed_window_counter(
        wb.n_i, wb.n_j, grid_mesh(shape), half_ring=half_ring,
        wire_dtype=wire)
    got = fn(*lanes)
    assert got.dtype == torch.float32 and got.shape == (len(lanes[0]),)
    np.testing.assert_array_equal(got.numpy()[:wb.n_windows],
                                  reference_counts())
    np.testing.assert_array_equal(got.numpy()[wb.n_windows:], 0.0)


def test_window_counter_takes_tensors_and_checks_the_window_axis():
    wb = batch()
    fn = tdist.make_distributed_window_counter(wb.n_i, wb.n_j,
                                               grid_mesh((2, 2)))
    lanes = [torch.from_numpy(x[:4]) for x in (wb.edge_i, wb.edge_j,
                                               wb.valid)]
    np.testing.assert_array_equal(fn(*lanes).numpy(), reference_counts()[:4])
    with pytest.raises(ValueError, match="not divisible"):
        fn(*(x[:3] for x in lanes))
    assert fn(*(x[:0] for x in lanes)).shape == (0,)
