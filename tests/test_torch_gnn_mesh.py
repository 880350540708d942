"""The GNNs' train step over a mesh (``models.gnn.sharded``, the four
losses with ``shard=``, ``graphs.segment``'s mesh partials) against the
JAX package.

Each GNN arch's ``molecule`` cell (``d_in`` 16; DimeNet's per-graph
readout) runs through ``make_step(Sharder.for_mesh(mesh))`` on the tiny
meshes of 8 CPU positions, its smoke config in float32 with the
reference's weights, on a graph of 43 nodes and 170 edges (neither divides
8, so every node and edge array splits unevenly).  The reference's jitted,
unsharded ``make_train_step(loss)`` takes two steps from its fresh state;
the port starts from the reference's state after the first (parameters and
moments placed by the cell's ``in_shardings``, each position's shards a
copy of their own, so that every replica steps by itself) and takes the
second: ``loss``, ``grad_norm``, ``step`` and every gathered leaf of the
parameters and both moments within the GNN tests' float32 tolerance,
rtol = atol = 1e-4, and every replica bit-equal to its first holder's.
The step's moves, by kind, equal ``predicted_moves``.  The segment ops
over a mesh are held to the unsharded ones, and xDeepFM's steps are built
over a mesh.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import list_cells as j_list_cells  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import list_cells  # noqa: E402
from repro_torch.data import shard_batch  # noqa: E402
from repro_torch.distributed import Sharder, ShardedTensor  # noqa: E402
from repro_torch.distributed import observe  # noqa: E402
from repro_torch.distributed.sharding import put_tree, shard_bounds  # noqa: E402
from repro_torch.graphs import segment as seg  # noqa: E402
from repro_torch.launch.mesh import make_tiny_mesh  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.gnn.sharded import predicted_moves  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402

ARCH = {"graphsage": "graphsage-reddit", "graphcast": "graphcast",
        "dimenet": "dimenet", "equiformer": "equiformer-v2"}
MESHES = [False, True]          # (2, 4) and (2, 2, 2)
MESH_IDS = ["tiny", "tiny_multipod"]
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE, N_NODES, N_EDGES = "molecule", 43, 170


def tiny(multi):
    return make_tiny_mesh(multi_pod=multi, devices=["cpu"] * 8)


class Moves:
    """An observer that sums the moves by kind."""

    def __init__(self):
        self.by_kind = {}

    def move(self, kind, src, dst, nbytes):
        self.by_kind[kind] = self.by_kind.get(kind, 0) + nbytes

    def kernel(self, name, flops, nbytes):
        pass


def to_torch(tree):
    return tck.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def placed(tree, shardings):
    """``tree``'s tensors placed by a matching tree of ``NamedSharding``
    (``put_tree``), each position's shard a copy of its own."""
    def copy(st):
        if not isinstance(st, ShardedTensor):
            return st
        return ShardedTensor(st.sharding, st.shape,
                             tuple(s.clone() for s in st.shards))
    return tck.tree_map(copy, put_tree(tree, shardings))


@functools.lru_cache(maxsize=None)
def reference_for(arch):
    """One arch's smoke config at the cell's width: the reference's state
    after one and after two jitted steps of its ``molecule`` cell on one
    batch, with the second step's metrics."""
    from test_torch_gnn import graph_batch

    cell = list_cells(ARCH[arch], smoke=True)[SHAPE]
    cfg = cell.config
    jcfg = j_get_arch(ARCH[arch]).smoke_config()
    if hasattr(jcfg, "d_in"):
        jcfg = dataclasses.replace(jcfg, d_in=cfg.d_in)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    batch = graph_batch(arch, cfg, seed=3, n=N_NODES, e=N_EDGES)
    j_cell = j_list_cells(ARCH[arch], smoke=True)[SHAPE]
    jstep = jax.jit(j_cell.make_step(JSharder(None)))
    init = {"graphsage": "init_sage", "graphcast": "init_graphcast",
            "dimenet": "init_dimenet", "equiformer": "init_eqv2"}[arch]
    from repro.models import gnn as j_gnn

    jp = getattr(j_gnn, init)(jax.random.PRNGKey(0), jcfg)
    state = JTrainState(jp, j_adamw_init(jp), jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    first, _ = jstep(state, jb)
    second, metrics = jstep(first, jb)
    host = lambda s: jax.tree.map(np.asarray, (s.params, s.opt.m, s.opt.v,  # noqa: E731
                                               s.opt.step))
    return dict(cell=cell, cfg=cfg, batch=batch, first=host(first),
                second=host(second),
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module", params=list(ARCH))
def reference(request):
    return request.param, reference_for(request.param)


def flat_leaves(tree) -> list:
    return tck.tree_flatten(tree)[0]


@pytest.mark.parametrize("multi", MESHES, ids=MESH_IDS)
def test_gnn_cell_on_a_mesh_equals_the_reference(reference, multi):
    arch, ref = reference
    cell, mesh = ref["cell"], tiny(multi)
    shard = Sharder.for_mesh(mesh)
    params, m, v, step = ref["first"]
    state = placed(TrainState(to_torch(params), AdamWState(
        torch.from_numpy(np.array(step)), to_torch(m), to_torch(v)), 0),
        cell.in_shardings(shard)[0])
    before = flat_leaves(state)
    batch = shard_batch(ref["batch"], cell.in_shardings(shard)[1])
    watch = Moves()
    with observe.observing(watch):
        out, metrics = cell.make_step(shard)(state, batch)
    want = ref["metrics"]
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"], **TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"],
                               **TOL)
    assert int(metrics["step"]) == int(want["step"]) == 2
    p2, m2, v2, _ = ref["second"]
    for got, exp in ((out.params, p2), (out.opt.m, m2), (out.opt.v, v2)):
        got, exp = flat_leaves(got), flat_leaves(exp)
        assert len(got) == len(exp)
        for i, (g, e) in enumerate(zip(got, exp)):
            np.testing.assert_allclose(g.gather().numpy(), e, err_msg=str(i),
                                       **TOL)
    # the same layout, updated in place; every replica bit-equal
    after = flat_leaves(out)
    for a, b in zip(before, after):
        if not isinstance(b, ShardedTensor):
            continue
        assert a.sharding == b.sharding
        for group in b.holders():
            for q in group[1:]:
                assert torch.equal(b.shards[q], b.shards[group[0]])
    assert watch.by_kind == predicted_moves(arch, ref["cfg"], ref["batch"],
                                            mesh)


@pytest.mark.parametrize("arch", list(ARCH))
def test_predicted_moves_of_a_registry_shape(arch):
    """``predicted_moves`` takes a registry shape by name as well as a
    batch: its abstract batch gives the same bytes."""
    cell = list_cells(ARCH[arch], smoke=True)[SHAPE]
    abstract = cell.abstract_inputs()[1]
    mesh = tiny(False)
    got = predicted_moves(ARCH[arch], cell.config, SHAPE, mesh)
    assert got == predicted_moves(arch, cell.config, abstract, mesh)
    assert got["all-gather"] > 0 and got["reduce-scatter"] > 0
    assert got["all-reduce"] > 0


# -- the segment ops over a mesh ---------------------------------------------------

def edges(seed, n, e, width=None):
    rng = np.random.default_rng(seed)
    shape = (e,) if width is None else (e, width)
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32)),
            torch.from_numpy(rng.integers(0, n, e)),
            torch.from_numpy(rng.random(e) < 0.8))


def split(x, mesh):
    return [x[a:b] for a, b in shard_bounds(x.shape[0], mesh.size)]


def joined(blocks):
    return torch.cat(list(blocks))


@pytest.mark.parametrize("multi", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("masked", [False, True])
def test_segment_ops_over_a_mesh_equal_the_unsharded(multi, masked):
    """43 segments over 8 positions (the last block short), 170 edges:
    the sum reduce-scattered and all-reduced, the mean and the two-head
    softmax, values and gradients, against the unsharded ops."""
    mesh = tiny(multi)
    axes = Sharder.for_mesh(mesh).spec("flat")[0]
    n = 43
    data, dst, mask = edges(0, n, 170, 5)
    logits, _, _ = edges(1, n, 170, 2)
    mask = mask if masked else None
    pieces = lambda x: None if x is None else split(x, mesh)  # noqa: E731

    def both(fn, fn_mesh, x, **kw):
        x = x.clone().requires_grad_()
        want = fn(x, dst, n, mask)
        xm = x.detach().clone().requires_grad_()
        got = fn_mesh(split(xm, mesh), split(dst, mesh), n, mesh, axes,
                      pieces(mask), **kw)
        return x, want, xm, got

    x, want, xm, got = both(seg.segment_sum, seg.segment_sum_mesh, data)
    assert [t.shape[0] for t in got] == [b - a for a, b in
                                         shard_bounds(n, 8)]
    torch.testing.assert_close(joined(got), want, rtol=1e-6, atol=1e-6)
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(2))
    (want * w).sum().backward()
    (joined(got) * w).sum().backward()
    torch.testing.assert_close(xm.grad, x.grad)

    x, want, xm, got = both(seg.segment_sum, seg.segment_sum_mesh, data,
                            to="all")
    for t in got:
        torch.testing.assert_close(t, want, rtol=1e-6, atol=1e-6)

    x, want, xm, got = both(seg.segment_mean, seg.segment_mean_mesh, data)
    torch.testing.assert_close(joined(got), want, rtol=1e-6, atol=1e-6)

    x, want, xm, got = both(seg.segment_softmax, seg.segment_softmax_mesh,
                            logits)
    torch.testing.assert_close(joined(got), want, rtol=1e-6, atol=1e-6)
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(3))
    (want * w).sum().backward()
    (joined(got) * w).sum().backward()
    torch.testing.assert_close(xm.grad, x.grad, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="to must be"):
        seg.segment_sum_mesh(split(data, mesh), split(dst, mesh), n, mesh,
                             axes, to="some")


@pytest.mark.parametrize("arch", list(ARCH))
def test_gnn_forward_on_a_mesh_is_laid_out_by_flat(arch):
    """The forward over a mesh returns the unsharded port's output as a
    ``ShardedTensor`` in the nodes' ``"flat"`` blocks (DimeNet's per-graph
    readout whole at every position), each position's block at its
    rows."""
    from test_torch_gnn import graph_batch

    cell = list_cells(ARCH[arch], smoke=True)[SHAPE]
    cfg = cell.config
    batch = {k: torch.as_tensor(x) for k, x in
             graph_batch(arch, cfg, seed=4, n=N_NODES, e=N_EDGES).items()}
    init, _, forward = {
        "graphsage": (gnn.init_sage, gnn.sage_loss, gnn.sage_forward),
        "graphcast": (gnn.init_graphcast, gnn.graphcast_loss,
                      gnn.graphcast_forward),
        "dimenet": (gnn.init_dimenet, gnn.dimenet_loss, gnn.dimenet_forward),
        "equiformer": (gnn.init_eqv2, gnn.eqv2_loss, gnn.eqv2_forward)}[arch]
    params = init(cfg, seed=1, device="cpu")
    with torch.no_grad():
        want = forward(params, batch, cfg)
        got = forward(params, batch, cfg, Sharder.for_mesh(tiny(True)))
    assert isinstance(got, ShardedTensor) and got.shape == tuple(want.shape)
    torch.testing.assert_close(got.gather(), want, rtol=1e-4, atol=1e-5)
    if arch == "dimenet":
        assert got.sharding.spec == ()
    else:
        assert [s.shape[0] for s in got.shards] == [
            b - a for a, b in shard_bounds(N_NODES, 8)]


def test_xdeepfm_steps_still_refuse_a_mesh():
    """No xDeepFM step refuses a mesh any more: the four cells' steps are
    built over each tiny mesh (their runs against the reference:
    ``tests/test_torch_xdeepfm_mesh.py``)."""
    cells = list_cells("xdeepfm", smoke=True)
    assert set(cells) == {"train_batch", "serve_p99", "serve_bulk",
                          "retrieval_cand"}
    for multi in MESHES:
        for cell in cells.values():
            step = cell.make_step(Sharder.for_mesh(tiny(multi)))
            assert callable(step)
            assert getattr(step, "n_microbatches", 1) == 1
