"""The port's recsys family against the reference's
(``repro.models.recsys``): ``embedding_bag`` in its three modes (ragged,
empty and padded bags, per-sample weights) and ``fused_field_lookup`` on
the same numpy draws; xDeepFM's forward, loss and every gradient leaf
against ``jax.value_and_grad`` with the reference's weights carried
across; ``xdeepfm_score_candidates`` with ``chunk`` smaller than the
candidates; the slabbed CIN equal to the one-slab CIN; the registry's
train, serve and retrieval cells on the smoke config against the
reference's.

Tolerances.  float32 sums in another order: ``embedding_bag`` within rtol
1e-6, atol 1e-6 (max mode exactly); xDeepFM (loss, logits, scores,
gradient leaves, parameters after one step) within rtol = atol = 1e-4, as
PR 13's (measured: the loss equal, gradient leaves ``max|dg| / max|g|``
up to 2.9e-07).  The slabbed CIN and the one-slab
CIN sum each row's outer product in the same order, so their features and
input gradients are held bit for bit (the weights' gradients, summed over
rows slab by slab, within ``1e-5 * max|g|``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import list_cells as j_list_cells  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro.models.recsys import embedding as j_emb  # noqa: E402
from repro.models.recsys import xdeepfm as j_x  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import list_cells  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.models import recsys  # noqa: E402
from repro_torch.models.recsys import embedding, xdeepfm  # noqa: E402
from repro_torch.train import TrainState, adamw_init  # noqa: E402
from repro_torch.train.checkpoint import tree_flatten  # noqa: E402
from repro_torch.train.optimizer import param_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def bags(seed, n_bags=7, vocab=30, dim=5):
    """A table and ragged bags (bag 2 empty), padded by 3 lanes."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5, n_bags)
    sizes[2] = 0
    offsets = np.r_[0, np.cumsum(sizes)[:-1]].astype(np.int32)
    total = int(sizes.sum())
    indices = np.r_[rng.integers(0, vocab, total), np.zeros(3)].astype(np.int32)
    weights = rng.uniform(0.5, 2.0, total + 3).astype(np.float32)
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    return table, indices, offsets, weights, total


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("padded", [False, True], ids=["whole", "padded"])
def test_embedding_bag_matches_the_reference(mode, weighted, padded):
    table, indices, offsets, weights, total = bags(seed=1)
    kw = {"mode": mode, "total_len": total if padded else None}
    w = weights if weighted else None
    got = embedding.embedding_bag(
        torch.as_tensor(table), torch.as_tensor(indices), torch.as_tensor(offsets),
        per_sample_weights=None if w is None else torch.as_tensor(w), **kw)
    want = np.asarray(j_emb.embedding_bag(
        jnp.asarray(table), jnp.asarray(indices), jnp.asarray(offsets),
        per_sample_weights=None if w is None else jnp.asarray(w), **kw))
    assert got.shape == want.shape
    if mode == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[2], 0)          # the empty bag


def test_embedding_bag_equals_torchs_embedding_bag_and_refuses_a_mode():
    """The same contract as ``nn.functional.embedding_bag`` (a yardstick of
    the contract only: the port builds its own, as the reference does)."""
    table, indices, offsets, _, total = bags(seed=2)
    t, i, o = (torch.as_tensor(a) for a in (table, indices[:total], offsets))
    for mode in ("sum", "mean", "max"):
        got = embedding.embedding_bag(t, i, o, mode=mode)
        want = torch.nn.functional.embedding_bag(i.long(), t, o.long(), mode=mode)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown mode"):
        embedding.embedding_bag(t, i, o, mode="min")


def test_fused_field_lookup_matches_the_reference():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(40, 3)).astype(np.float32)
    offs = np.array([0, 10, 25], np.int32)
    ids = rng.integers(0, 10, (6, 3)).astype(np.int32)
    got = embedding.fused_field_lookup(torch.as_tensor(table), torch.as_tensor(offs),
                                       torch.as_tensor(ids))
    want = j_emb.fused_field_lookup(jnp.asarray(table), jnp.asarray(offs),
                                    jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def smoke():
    return j_get_arch("xdeepfm").smoke_config()


def click_batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return {"ids": rng.integers(0, cfg.vocab_per_field,
                                (b, cfg.n_sparse)).astype(np.int32),
            "clicks": (rng.random(b) < 0.3).astype(np.float32)}


def ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, j_x.init_xdeepfm(jax.random.PRNGKey(seed), cfg))


def test_xdeepfm_loss_and_every_gradient_leaf_match_jax_value_and_grad():
    cfg = smoke()
    batch = click_batch(cfg, 48, seed=4)
    ref = ref_params(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: j_x.xdeepfm_loss(p, jb, cfg)))(jax.tree.map(jnp.asarray, ref))
    params = recsys.params_from_reference(ref, "cpu")
    leaves = param_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = xdeepfm.xdeepfm_loss(params, {k: torch.as_tensor(v)
                                         for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    want_leaves = jax.tree.leaves(want_grads)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_xdeepfm_forward_matches_the_reference():
    cfg = smoke()
    ids = click_batch(cfg, 33, seed=5)["ids"]
    ref = ref_params(cfg, seed=1)
    want = j_x.xdeepfm_forward(jax.tree.map(jnp.asarray, ref),
                               {"ids": jnp.asarray(ids)}, cfg)
    got = xdeepfm.xdeepfm_forward(recsys.params_from_reference(ref, "cpu"),
                                  {"ids": torch.as_tensor(ids)}, cfg)
    assert got.shape == (33,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_cand,chunk", [(50, 16), (64, 16), (10, 64)])
def test_score_candidates_in_slabs_match_the_reference(n_cand, chunk):
    cfg = smoke()
    rng = np.random.default_rng(6)
    n_user = 3
    batch = {"user_ids": rng.integers(0, cfg.vocab_per_field, n_user).astype(np.int32),
             "cand_ids": rng.integers(0, cfg.vocab_per_field,
                                      (n_cand, cfg.n_sparse - n_user)).astype(np.int32)}
    ref = ref_params(cfg, seed=2)
    want = j_x.xdeepfm_score_candidates(
        jax.tree.map(jnp.asarray, ref), {k: jnp.asarray(v) for k, v in batch.items()},
        cfg, chunk=chunk)
    with torch.no_grad():
        got = xdeepfm.xdeepfm_score_candidates(
            recsys.params_from_reference(ref, "cpu"),
            {k: torch.as_tensor(v) for k, v in batch.items()}, cfg, chunk=chunk)
    assert got.shape == (n_cand,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_the_slabbed_cin_equals_one_slab(grad, monkeypatch):
    """A byte budget of 7 rows' outer products cuts 40 rows into 6 slabs
    (checkpointed when gradients are needed): the same features and input
    gradients bit for bit; the weights' gradients sum over the rows slab by
    slab, so within ``1e-5 * max|g|``."""
    cfg = smoke()
    params = recsys.params_from_reference(ref_params(cfg, seed=3), "cpu")
    x0 = torch.randn(40, cfg.n_sparse, cfg.embed_dim,
                     generator=torch.Generator().manual_seed(0))
    per_row = max(cfg.n_sparse, *cfg.cin_layers[:-1]) * cfg.n_sparse * cfg.embed_dim * 4
    outs, grads = [], []
    for budget in (xdeepfm.CIN_SLAB_BYTES, 7 * per_row):
        monkeypatch.setattr(xdeepfm, "CIN_SLAB_BYTES", budget)
        x = x0.clone().requires_grad_(grad)
        ws = [w.clone().requires_grad_(grad) for w in params["cin_w"]]
        with torch.set_grad_enabled(grad):
            out = xdeepfm._cin({"cin_w": ws}, x, cfg, Sharder(None))
        outs.append(out.detach())
        if grad:
            grads.append(torch.autograd.grad(out.square().sum(), [x, *ws]))
    assert outs[0].shape == (40, sum(cfg.cin_layers))
    assert torch.equal(outs[0], outs[1])
    if grad:
        assert torch.equal(grads[0][0], grads[1][0])
        for a, b in zip(grads[0][1:], grads[1][1:]):
            gap = float((a - b).abs().max())
            assert gap <= 1e-5 * float(a.abs().max()), (gap, float(a.abs().max()))


def test_param_specs_and_init_tree_match_the_reference():
    for cfg in (smoke(), j_get_arch("xdeepfm").full_config()):
        assert xdeepfm.xdeepfm_param_specs(cfg) == j_x.xdeepfm_param_specs(cfg)
        want = jax.eval_shape(lambda: j_x.init_xdeepfm(jax.random.PRNGKey(0), cfg))
        got = xdeepfm.init_xdeepfm(cfg, device="meta")
        g_leaves, g_def = tree_flatten(got)
        w_leaves, w_def = jax.tree.flatten(want)
        assert str(g_def) == str(w_def)
        assert [tuple(g.shape) for g in g_leaves] == [w.shape for w in w_leaves]


def test_the_cells_match_the_reference_on_the_smoke_config():
    """train_batch (one step from the reference's state) and serve_p99
    (through each cell's ``make_step(Sharder(None))``), at small batches of
    the smoke config."""
    cfg = smoke()
    cells, j_cells = list_cells("xdeepfm", smoke=True), j_list_cells("xdeepfm", smoke=True)
    jp = j_x.init_xdeepfm(jax.random.PRNGKey(0), cfg)
    params = recsys.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    batch = click_batch(cfg, 32, seed=7)
    j_state = JTrainState(jp, j_adamw_init(jp), jax.random.PRNGKey(0))
    j_new, j_m = jax.jit(j_cells["train_batch"].make_step(JSharder(None)))(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    state, m = cells["train_batch"].make_step(Sharder(None))(
        TrainState(params, adamw_init(params), 0),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]), **TOL)
    for g, w in zip(tree_flatten(state.params)[0], jax.tree.leaves(j_new.params)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    # serving and retrieval on the trained weights, without autograd
    jp, params = j_new.params, state.params
    ids = {"ids": batch["ids"][:9]}
    want = j_cells["serve_p99"].make_step(JSharder(None))(
        jp, {"ids": jnp.asarray(ids["ids"])})
    got = cells["serve_p99"].make_step(Sharder(None))(
        params, {"ids": torch.as_tensor(ids["ids"])})
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_the_retrieval_cell_matches_the_reference():
    """retrieval_cand joins 19 user fields onto each candidate's items, so
    the smoke config (8 fields) cannot have it: 22 fields here."""
    from repro.configs.registry import xdeepfm_cells as j_xdeepfm_cells
    from repro_torch.configs.registry import xdeepfm_cells

    cfg = dataclasses.replace(smoke(), n_sparse=22)
    ref = ref_params(cfg, seed=4)
    rng = np.random.default_rng(8)
    rb = {"user_ids": rng.integers(0, 128, 19).astype(np.int32),
          "cand_ids": rng.integers(0, 128, (20, 3)).astype(np.int32)}
    want = j_xdeepfm_cells(cfg)["retrieval_cand"].make_step(JSharder(None))(
        jax.tree.map(jnp.asarray, ref), {k: jnp.asarray(v) for k, v in rb.items()})
    got = xdeepfm_cells(cfg)["retrieval_cand"].make_step(Sharder(None))(
        recsys.params_from_reference(ref, "cpu"),
        {k: torch.as_tensor(v) for k, v in rb.items()})
    assert got.shape == (20,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
