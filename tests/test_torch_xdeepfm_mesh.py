"""xDeepFM's train, serve and retrieval steps over a mesh
(``models.recsys.sharded``, ``xdeepfm_*`` with ``shard=``) against the JAX
package, and the row-split lookup they share with the LMs' embedding.

The smoke config (8 fields of 128 rows, its 1,024 table rows split evenly
over "model") in float32 with the reference's weights, on the tiny meshes
of 8 CPU positions: (2, 4), two data groups of four "model" columns, and
(2, 2, 2), four groups of two.  Batches of 43 rows split over the groups
unevenly; 3 rows on (2, 2, 2) leave the last group an empty block.

* Train: the reference's jitted, unsharded ``make_train_step(
  xdeepfm_loss)`` takes two steps from its fresh state; the port starts
  from the reference's state after the first (parameters and moments
  placed by the cell's ``in_shardings``, each position's shards a copy of
  their own) and takes the second through the ``train_batch`` cell's step
  over the mesh: ``loss``, ``grad_norm``, ``step`` and every gathered leaf
  of the parameters and both moments within rtol = atol = 1e-4 (the
  xDeepFM tests' float32 tolerance), every replica bit-equal to its first
  holder's, and the moves, by kind, equal to ``predicted_moves``.
* Serve and retrieval: the ``serve_p99`` cell's step and
  ``xdeepfm_score_candidates`` (``chunk`` 16 below the candidates, so a
  group's last slab is short) over the mesh against the reference's
  ``xdeepfm_forward`` and ``xdeepfm_score_candidates`` within 1e-4, laid
  out over "batch", with their moves.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import list_cells as j_list_cells  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro.models.recsys import xdeepfm as j_x  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import get_arch, list_cells  # noqa: E402
from repro_torch.data import shard_batch  # noqa: E402
from repro_torch.distributed import Sharder, ShardedTensor  # noqa: E402
from repro_torch.distributed import observe  # noqa: E402
from repro_torch.distributed.collectives import row_split_lookup  # noqa: E402
from repro_torch.distributed.sharding import put_tree, shard_bounds  # noqa: E402
from repro_torch.launch.mesh import make_tiny_mesh  # noqa: E402
from repro_torch.models.recsys import params_from_reference  # noqa: E402
from repro_torch.models.recsys.sharded import predicted_moves  # noqa: E402
from repro_torch.models.recsys.xdeepfm import (  # noqa: E402
    xdeepfm_param_specs,
    xdeepfm_score_candidates,
)
from repro_torch.models.transformer.sharded import _embed, _Layout  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# (multi_pod, rows): 43 rows split unevenly over 2 and 4 groups; 3 rows
# over 4 groups leave the last one empty
CASES = [(False, 43), (True, 43), (True, 3)]
IDS = ["tiny-43", "tiny_multipod-43", "tiny_multipod-3"]


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
    """``tree``'s tensors placed by a matching tree of ``NamedSharding``,
    each position's shard a copy of its own."""
    def copy(st):
        if not isinstance(st, ShardedTensor):
            return st
        return ShardedTensor(st.sharding, st.shape,
                             tuple(s.clone() for s in st.shards))
    return tck.tree_map(copy, put_tree(tree, shardings))


def click_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, cfg.vocab_per_field,
                                (b, cfg.n_sparse)).astype(np.int32),
            "clicks": (rng.random(b) < 0.3).astype(np.float32)}


@functools.lru_cache(maxsize=None)
def reference_for(rows):
    """The reference's state after one and after two jitted
    ``train_batch`` steps of the smoke config on one batch of ``rows``
    rows, with the second step's metrics."""
    cfg = j_get_arch("xdeepfm").smoke_config()
    batch = click_batch(cfg, rows, seed=3)
    jstep = jax.jit(j_list_cells("xdeepfm", smoke=True)["train_batch"]
                    .make_step(JSharder(None)))
    jp = j_x.init_xdeepfm(jax.random.PRNGKey(0), cfg)
    state = JTrainState(jp, j_adamw_init(jp), jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    first, _ = jstep(state, jb)
    second, metrics = jstep(first, jb)
    host = lambda s: jax.tree.map(np.asarray, (s.params, s.opt.m, s.opt.v,  # noqa: E731
                                               s.opt.step))
    return dict(batch=batch, first=host(first), second=host(second),
                metrics={k: float(v) for k, v in metrics.items()})


def port_config():
    """The port's smoke config, the reference's field for field."""
    cfg = get_arch("xdeepfm").smoke_config()
    assert vars(cfg) == vars(j_get_arch("xdeepfm").smoke_config())
    return cfg


def flat_leaves(tree) -> list:
    return tck.tree_flatten(tree)[0]


@pytest.mark.parametrize("multi,rows", CASES, ids=IDS)
def test_train_step_on_a_mesh_equals_the_reference(multi, rows):
    ref = reference_for(rows)
    cell = list_cells("xdeepfm", smoke=True)["train_batch"]
    mesh = tiny(multi)
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
            np.testing.assert_allclose(g.gather().detach().numpy(), e,
                                       err_msg=str(i), **TOL)
    # the same layout, updated in place; every replica bit-equal
    after = flat_leaves(out)
    for a, b in zip(before, after):
        if not isinstance(b, ShardedTensor):
            continue
        assert a.sharding == b.sharding
        for group in b.holders():
            for q in group[1:]:
                assert torch.equal(b.shards[q], b.shards[group[0]])
    assert watch.by_kind == predicted_moves(port_config(), ("train", rows),
                                            mesh)


@pytest.mark.parametrize("multi,rows", CASES, ids=IDS)
def test_serve_and_retrieval_on_a_mesh_equal_the_reference(multi, rows):
    cfg = port_config()
    mesh = tiny(multi)
    shard = Sharder.for_mesh(mesh)
    groups = 2 if not multi else 4
    jcfg = j_get_arch("xdeepfm").smoke_config()
    ref = jax.tree.map(np.asarray, j_x.init_xdeepfm(jax.random.PRNGKey(1),
                                                    jcfg))
    jp = jax.tree.map(jnp.asarray, ref)
    cell = list_cells("xdeepfm", smoke=True)["serve_p99"]
    params = placed(params_from_reference(ref, "cpu"),
                    cell.in_shardings(shard)[0])
    ids = click_batch(cfg, rows, seed=5)["ids"]

    def held(got, want):
        assert isinstance(got, ShardedTensor) and got.shape == (rows,)
        assert [s.shape[0] for s in got.shards[::8 // groups]] == [
            b - a for a, b in shard_bounds(rows, groups)]
        assert not got.shards[0].requires_grad
        np.testing.assert_allclose(got.gather().numpy(), np.asarray(want),
                                   **TOL)

    watch = Moves()
    with observe.observing(watch):
        got = cell.make_step(shard)(params, shard_batch(
            {"ids": ids}, cell.in_shardings(shard)[1]))
    held(got, j_x.xdeepfm_forward(jp, {"ids": jnp.asarray(ids)}, jcfg))
    assert watch.by_kind == predicted_moves(cfg, ("serve", rows), mesh)

    n_user = 3
    cand = {"user_ids": ids[0, :n_user], "cand_ids": ids[:, n_user:]}
    watch = Moves()
    with observe.observing(watch), torch.no_grad():
        got = xdeepfm_score_candidates(params, shard_batch(cand, {
            "user_ids": shard.named(None), "cand_ids": shard.named(
                "batch", None)}), cfg, shard, chunk=16)
    held(got, j_x.xdeepfm_score_candidates(
        jp, {k: jnp.asarray(v) for k, v in cand.items()}, jcfg, chunk=16))
    assert watch.by_kind == predicted_moves(cfg, ("retrieval", rows), mesh)


def test_steps_take_whole_inputs_and_the_retrieval_cell():
    """Each step places whole inputs itself (as the dry-run passes them):
    serving with a whole parameter tree and ids, and the
    ``retrieval_cand`` cell (19 user fields, so 22 fields here) over
    (2, 4), against the unsharded port."""
    import dataclasses

    from repro_torch.configs.registry import xdeepfm_cells

    cfg = dataclasses.replace(port_config(), n_sparse=22)
    ref = jax.tree.map(np.asarray, j_x.init_xdeepfm(
        jax.random.PRNGKey(4), dataclasses.replace(
            j_get_arch("xdeepfm").smoke_config(), n_sparse=22)))
    params = params_from_reference(ref, "cpu")
    rng = np.random.default_rng(8)
    rb = {"user_ids": torch.from_numpy(rng.integers(0, 128, 19).astype(
              np.int32)),
          "cand_ids": torch.from_numpy(rng.integers(0, 128, (20, 3)).astype(
              np.int32))}
    cells = xdeepfm_cells(cfg)
    shard = Sharder.for_mesh(tiny(False))
    want = cells["retrieval_cand"].make_step(Sharder(None))(params, rb)
    got = cells["retrieval_cand"].make_step(shard)(params, rb)
    np.testing.assert_allclose(got.gather().numpy(), want.numpy(), **TOL)
    ids = {"ids": torch.cat([rb["user_ids"][None].expand(20, -1),
                             rb["cand_ids"]], dim=1)}
    got = cells["serve_p99"].make_step(shard)(params, ids)
    np.testing.assert_allclose(got.gather().numpy(), want.numpy(), **TOL)
    assert xdeepfm_param_specs(cfg)["table"] == ("model", None)


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_predicted_moves_of_a_registry_shape(shape):
    """``predicted_moves`` takes a registry shape by name as well as a
    ``(kind, rows)`` pair: the cell's rows (retrieval's padded)."""
    cell = list_cells("xdeepfm", smoke=True)[shape]
    rows = cell.abstract_inputs()[1]
    rows = (rows["ids"] if "ids" in rows else rows["cand_ids"]).shape[0]
    mesh, cfg = tiny(True), port_config()
    got = predicted_moves(cfg, shape, mesh)
    assert got == predicted_moves(cfg, (cell.kind, rows), mesh)
    assert got["all-reduce"] > 0


@pytest.mark.parametrize("multi", [False, True], ids=["tiny", "tiny_multipod"])
def test_the_lm_embedding_runs_through_the_row_split_lookup(multi):
    """``_embed``'s row branch is ``row_split_lookup``: on a table row-split
    over "model", every position gets its data group's tokens' rows bit
    for bit, and the blocks' gradients are the unsharded gradient's rows;
    the all-reduce over "model" moves ``2 (M - 1)`` times each group's
    lookup forward and ``(M - 1)`` times back from the column whose
    output takes a gradient."""
    mesh = tiny(multi)
    shard = Sharder.for_mesh(mesh)
    lay = _Layout(shard)
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(64, 5, generator=gen)
    tokens = torch.randint(0, 64, (7, 3), generator=gen)
    blocks = shard.named("model", None).put(table.clone().requires_grad_())
    tok = list(shard.act(tokens, "batch", None).shards)
    watch = Moves()
    with observe.observing(watch):
        got = _embed(lay, list(blocks.shards), ("model", None), tok)
    same = row_split_lookup(list(blocks.shards), tok, mesh, "model")
    for p in range(mesh.size):
        assert torch.equal(got[p], table[tok[p]])
        assert torch.equal(same[p], got[p])
    m = lay.n_cols
    assert watch.by_kind == {"all-reduce": 2 * (m - 1) * 7 * 3 * 5 * 4}
    w = torch.randn(7, 3, 5, generator=gen)
    homes = [int(p) for p in range(mesh.size) if lay.col[p] == 0]
    watch = Moves()
    with observe.observing(watch):
        loss = sum((got[h] * w[slice(*shard_bounds(7, lay.n_groups)[
            lay.group[h]])]).sum() for h in homes)
        grads = torch.autograd.grad(loss, list(blocks.shards))
    assert watch.by_kind == {"all-reduce": (m - 1) * 7 * 3 * 5 * 4}
    whole = table.clone().requires_grad_()
    (whole[tokens] * w).sum().backward()
    per = 64 // m
    for p in range(mesh.size):
        if lay.group[p] != 0:
            continue
        # group 0's blocks hold its tokens' gradient; adding the groups'
        # gives the unsharded gradient's rows
        total = sum(grads[q] for q in range(mesh.size)
                    if lay.col[q] == lay.col[p])
        c = lay.col[p]
        torch.testing.assert_close(total, whole.grad[c * per:(c + 1) * per])
