"""The port's graph primitives against the reference's (``repro.graphs``):
the segment reductions with and without masks (empty segments, multi-head
softmax, the integer ``segment_max``), ``gather_scatter`` and ``degrees``
on the same numpy draws; and the host-side structures that must be equal
element for element: ``build_csr``, ``build_csr_padded``,
``fanout_sample`` (the same ``default_rng(seed)`` draws), DimeNet's
``build_triplets`` (and its vectorised twin, against the loop at several
sizes and truncations), EquiformerV2's ``m_order_masks`` and the halo
partitioner ``build_partitioned_batch``; the in-process all-to-all and a
mesh's shard order.

Tolerances.  The port sums segments with ``index_add`` in another order
than XLA: float32 sums, means and softmaxes within rtol 1e-6, atol 1e-7
(measured: sums and means equal, softmaxes up to 2.98e-08 apart on values
up to 1); maxima, integer results and the host structures exactly.  The softmax's gradient (through
``torch.autograd`` against ``jax.grad``) within rtol = atol = 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.graphs import csr as j_csr  # noqa: E402
from repro.graphs import halo as j_halo  # noqa: E402
from repro.graphs import sampler as j_sampler  # noqa: E402
from repro.graphs import segment as j_seg  # noqa: E402
from repro.models.gnn.dimenet import build_triplets as j_build_triplets  # noqa: E402
from repro.models.gnn.equiformer_v2 import m_order_masks as j_m_order  # noqa: E402
from repro_torch import graphs  # noqa: E402
from repro_torch.distributed.collectives import all_to_all  # noqa: E402
from repro_torch.graphs import csr, halo, sampler, segment  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.gnn.dimenet import (  # noqa: E402
    build_triplets,
    build_triplets_vectorised,
)
from repro_torch.models.gnn.equiformer_v2 import m_order_masks  # noqa: E402

SUM_TOL = dict(rtol=1e-6, atol=1e-7)


def edges(n_seg, n_edges, seed, heads=None, empty=(3,)):
    """Edge data and destinations over ``n_seg`` segments, none into the
    ``empty`` ones, and a mask with about a fifth off."""
    rng = np.random.default_rng(seed)
    live = np.setdiff1d(np.arange(n_seg), empty)
    dst = rng.choice(live, n_edges).astype(np.int32)
    shape = (n_edges,) if heads is None else (n_edges, heads)
    data = (rng.normal(size=shape) * 3).astype(np.float32)
    mask = rng.random(n_edges) < 0.8
    return data, dst, mask


def both(fn_name, data, dst, n, mask):
    got = getattr(segment, fn_name)(torch.as_tensor(data), torch.as_tensor(dst),
                                    n, None if mask is None else torch.as_tensor(mask))
    want = getattr(j_seg, fn_name)(jnp.asarray(data), jnp.asarray(dst), n,
                                   None if mask is None else jnp.asarray(mask))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("fn_name", ["segment_sum", "segment_mean",
                                     "segment_max", "segment_softmax"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("heads", [None, 4], ids=["1d", "heads"])
def test_segment_ops_match_the_reference(fn_name, masked, heads):
    data, dst, mask = edges(9, 70, seed=1, heads=heads, empty=(3, 8))
    got, want = both(fn_name, data, dst, 9, mask if masked else None)
    assert got.shape == want.shape and got.dtype == want.dtype
    if fn_name == "segment_max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **SUM_TOL)
    if fn_name != "segment_softmax":
        np.testing.assert_array_equal(got[[3, 8]], 0)     # empty segments


def test_a_segment_of_masked_edges_only_is_empty():
    data = np.array([5.0, -1.0, 2.0], np.float32)
    dst = np.array([0, 1, 1], np.int32)
    mask = np.array([False, True, True])
    for fn_name in ("segment_sum", "segment_mean", "segment_max"):
        got, want = both(fn_name, data, dst, 2, mask)
        np.testing.assert_array_equal(got, want)
        assert got[0] == 0
    got, want = both("segment_softmax", data, dst, 2, mask)
    np.testing.assert_allclose(got, want, **SUM_TOL)
    assert got[0] == 0


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_integer_segment_max(dtype, masked):
    rng = np.random.default_rng(2)
    data = rng.integers(-50, 50, 40).astype(dtype)
    data[0] = np.iinfo(dtype).min + 1
    dst = rng.integers(0, 6, 40).astype(np.int32)
    dst[dst == 4] = 5                       # segment 4 empty
    mask = rng.random(40) < 0.7 if masked else None
    if dtype == np.int64:
        with jax.enable_x64(True):
            got, want = both("segment_max", data, dst, 6, mask)
    else:
        got, want = both("segment_max", data, dst, 6, mask)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert got[4] == 0


def test_segment_softmax_gradient_matches_jax_grad():
    data, dst, mask = edges(7, 50, seed=3, heads=3, empty=(2,))
    cot = np.random.default_rng(4).normal(size=data.shape).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(j_seg.segment_softmax(
        x, jnp.asarray(dst), 7, jnp.asarray(mask)) * cot))(jnp.asarray(data))
    x = torch.as_tensor(data).requires_grad_()
    out = segment.segment_softmax(x, torch.as_tensor(dst), 7, torch.as_tensor(mask))
    (got,) = torch.autograd.grad(out, x, torch.as_tensor(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_gather_scatter_and_degrees(reduce):
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(12, 5)).astype(np.float32)
    src = rng.integers(0, 12, 60).astype(np.int32)
    dst = rng.integers(0, 10, 60).astype(np.int32)
    mask = rng.random(60) < 0.8
    got = graphs.gather_scatter(torch.as_tensor(feats), torch.as_tensor(src),
                                torch.as_tensor(dst), 10, reduce=reduce,
                                msg_fn=torch.tanh, mask=torch.as_tensor(mask))
    want = j_seg.gather_scatter(jnp.asarray(feats), jnp.asarray(src),
                                jnp.asarray(dst), 10, reduce=reduce,
                                msg_fn=jnp.tanh, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        graphs.degrees(torch.as_tensor(dst), 10, torch.as_tensor(mask)).numpy(),
        np.asarray(j_seg.degrees(jnp.asarray(dst), 10, jnp.asarray(mask))))


def test_graphs_exports_the_references_names():
    from repro import graphs as j_graphs
    assert graphs.__all__ == j_graphs.__all__


# -- host structures: equal element for element --------------------------------

def random_graph(n, e, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("n,e,cap", [(30, 100, 4), (50, 400, 16), (7, 5, 3)])
def test_csr_builders_equal_the_reference(n, e, cap):
    src, dst = random_graph(n, e, seed=n)
    for a, b in zip(csr.build_csr(src, dst, n), j_csr.build_csr(src, dst, n)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for a, b in zip(csr.build_csr_padded(src, dst, n, cap),
                    j_csr.build_csr_padded(src, dst, n, cap)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("replace", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_fanout_sample_draws_the_references_blocks(replace, seed):
    src, dst = random_graph(200, 1500, seed=3)
    indptr, indices = csr.build_csr(src, dst, 200)
    seeds = np.arange(0, 200, 9)
    got = sampler.fanout_sample(indptr, indices, seeds, [5, 3], seed=seed,
                                replace=replace)
    want = j_sampler.fanout_sample(indptr, indices, seeds, [5, 3], seed=seed,
                                   replace=replace)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert got.frontier_sizes == want.frontier_sizes
    for a, b, ma, mb in zip(got.nbr, want.nbr, got.nbr_mask, want.nbr_mask):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ma, mb)


@pytest.mark.parametrize("n,e,max_t", [(20, 60, 500), (20, 60, 37), (64, 300, 1),
                                       (300, 2000, 4000), (5, 40, 10_000)])
def test_build_triplets_equal_the_reference_and_the_vectorised_twin(
        n, e, max_t, monkeypatch):
    from repro_torch.models.gnn import dimenet

    src, dst = random_graph(n, e, seed=e)
    want = j_build_triplets(src, dst, max_t)
    monkeypatch.setattr(dimenet, "TRIPLET_CHUNK", 17)
    for got in (build_triplets(src, dst, max_t),
                build_triplets_vectorised(src, dst, max_t)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype and a.shape == (max_t,)


def test_build_triplets_vectorised_on_a_skewed_graph_in_chunks(monkeypatch):
    from repro_torch.models.gnn import dimenet

    rng = np.random.default_rng(9)
    src = rng.integers(0, 400, 3000)
    dst = (400 * rng.random(3000) ** 3).astype(np.int64)      # hubs
    loop = build_triplets(src, dst, 50_000)
    for chunk in (1, 64, 1 << 20):
        monkeypatch.setattr(dimenet, "TRIPLET_CHUNK", chunk)
        for a, b in zip(build_triplets_vectorised(src, dst, 50_000), loop):
            np.testing.assert_array_equal(a, b)
    assert loop[2].sum() > 3000


@pytest.mark.parametrize("l_max,m_max", [(2, 1), (6, 2), (0, 0)])
def test_m_order_masks_equal_the_reference(l_max, m_max):
    np.testing.assert_array_equal(m_order_masks(l_max, m_max),
                                  j_m_order(l_max, m_max))


def locality_graph(n, e, seed=0, far_frac=0.2):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-4, 5, e), 0, n - 1)
    far = rng.random(e) < far_frac
    return src, np.where(far, rng.integers(0, n, e), dst)


@pytest.mark.parametrize("n,e,n_dev,halo_,cap", [
    (64, 400, 8, 64, None), (64, 300, 8, 4, None), (50, 200, 4, None, 30),
    (33, 120, 3, 2, 20)])
def test_build_partitioned_batch_equals_the_reference(n, e, n_dev, halo_, cap):
    src, dst = locality_graph(n, e, seed=n)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    got = halo.build_partitioned_batch(src, dst, x, labels, n_dev, halo=halo_,
                                       edge_cap=cap)
    want = j_halo.build_partitioned_batch(src, dst, x, labels, n_dev,
                                          halo=halo_, edge_cap=cap)
    assert (got.n_loc, got.halo) == (want.n_loc, want.halo)
    gb, wb = got.device_batch(), want.device_batch()
    assert list(gb) == list(wb)
    for k in gb:
        np.testing.assert_array_equal(gb[k], wb[k])
        assert gb[k].dtype == wb[k].dtype


def test_halo_exchange_sends_each_devices_rows_to_its_peers():
    n_dev, n_loc, h, f = 3, 5, 2, 4
    xs = [torch.arange(n_loc * f, dtype=torch.float32).reshape(n_loc, f) + 100 * d
          for d in range(n_dev)]
    rng = np.random.default_rng(0)
    idx = [torch.as_tensor(rng.integers(0, n_loc, (n_dev, h))) for _ in range(n_dev)]
    ext = halo.halo_exchange(xs, idx, ["cpu"] * n_dev)
    for d in range(n_dev):
        assert ext[d].shape == (n_loc + n_dev * h, f)
        assert torch.equal(ext[d][:n_loc], xs[d])
        for o in range(n_dev):
            got = ext[d][n_loc + o * h:n_loc + (o + 1) * h]
            assert torch.equal(got, xs[o][idx[o][d]])


def test_all_to_all_and_its_gradient():
    sends = [torch.randn(4, 3, requires_grad=True) for _ in range(4)]
    recv = all_to_all(sends, ["cpu"] * 4)
    for d in range(4):
        for o in range(4):
            assert torch.equal(recv[d][o], sends[o][d])
    total = sum((r * (i + 1)).sum() for i, r in enumerate(recv))
    grads = torch.autograd.grad(total, sends)
    for g in grads:
        for d in range(4):
            assert torch.all(g[d] == d + 1)
    with pytest.raises(ValueError, match="sends"):
        all_to_all(sends[:3], ["cpu"] * 4)


def test_shard_devices_follow_shard_maps_order():
    """A dim split over ``("data", "model")`` goes data-major; over one axis,
    along it at index 0 of the others (the grid's cells are labelled here,
    as the CPU is one device)."""
    mesh = make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    mesh.devices = np.array([[f"d{i}m{j}" for j in range(4)] for i in range(2)],
                            dtype=object)
    assert mesh.shard_devices(("data", "model")) == [
        f"d{i}m{j}" for i in range(2) for j in range(4)]
    assert mesh.shard_devices(("model", "data")) == [
        f"d{i}m{j}" for j in range(4) for i in range(2)]
    assert mesh.shard_devices("model") == [f"d0m{j}" for j in range(4)]
    assert mesh.shard_devices(("data",)) == ["d0m0", "d1m0"]
    with pytest.raises(ValueError, match="no axis"):
        mesh.shard_devices(("pod",))
