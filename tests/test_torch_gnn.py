"""The port's GNN family against the reference's (``repro.models.gnn``):
GraphSAGE, GraphCast, DimeNet and EquiformerV2 at their smoke configs,
with the reference's weights carried across (``params_from_reference``;
the port's own ``init_*`` draw from a torch generator) and inputs made
from a numpy seed.  The forward, the loss and every gradient leaf are held
to ``jax.value_and_grad`` of the reference's loss, leaves paired in
``jax.tree``'s order; GraphSAGE also on a fanout-sampled subgraph, DimeNet
on batched molecules (``graph_id``); the ``init_*`` trees' structure,
shapes and dtypes equal the reference's; the registry's train step equals
the reference's on one step.

Tolerances.  float32, as PR 13's: rtol = atol = 1e-4 on the loss, the
forward's outputs and each gradient leaf, and on the parameters after one
train step (measured: loss relative gaps up to 1.5e-07, gradient leaves
``max|dg| / max|g|`` up to 9.5e-06 over the four models, except
EquiformerV2's last attention bias, whose gradient is 0 up to rounding:
4.7e-10 against gaps of 7.0e-10).  EquiformerV2's bfloat16 branch cannot
run in the reference on the CPU (XLA's CPU backend has no bf16 x bf16 ->
f32 dot), so it is held to the reference's float32 loss within rtol 2e-2
and each gradient leaf within ``0.05 * max|g_ref|`` (measured 4.4e-05 and
1.6e-02), and must differ from the port's float32 branch (it rounds to
bf16).
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
from repro.models import gnn as j_gnn  # noqa: E402
from repro.models.gnn.dimenet import build_triplets as j_build_triplets  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import list_cells  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.graphs.csr import build_csr  # noqa: E402
from repro_torch.graphs.sampler import fanout_sample  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.train import TrainState, adamw_init  # noqa: E402
from repro_torch.train.checkpoint import tree_flatten  # noqa: E402
from repro_torch.train.optimizer import param_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = {"graphsage": "graphsage-reddit", "graphcast": "graphcast",
        "dimenet": "dimenet", "equiformer": "equiformer-v2"}
J_FNS = {"graphsage": (j_gnn.init_sage, j_gnn.sage_loss, j_gnn.sage_forward),
         "graphcast": (j_gnn.init_graphcast, j_gnn.graphcast_loss,
                       j_gnn.graphcast_forward),
         "dimenet": (j_gnn.init_dimenet, j_gnn.dimenet_loss, j_gnn.dimenet_forward),
         "equiformer": (j_gnn.init_eqv2, j_gnn.eqv2_loss, j_gnn.eqv2_forward)}
T_FNS = {"graphsage": (gnn.init_sage, gnn.sage_loss, gnn.sage_forward),
         "graphcast": (gnn.init_graphcast, gnn.graphcast_loss,
                       gnn.graphcast_forward),
         "dimenet": (gnn.init_dimenet, gnn.dimenet_loss, gnn.dimenet_forward),
         "equiformer": (gnn.init_eqv2, gnn.eqv2_loss, gnn.eqv2_forward)}


def graph_batch(arch, cfg, seed, n=40, e=160):
    """A numpy batch for ``arch`` on a random graph of ``n`` nodes and ``e``
    edges, about a tenth of the edges masked off."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    b = {"edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
         "edge_mask": rng.random(e) < 0.9}
    if arch == "graphsage":
        b |= {"x": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
              "labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
              "label_mask": (rng.random(n) < 0.8).astype(np.float32)}
    elif arch == "graphcast":
        b |= {"x": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
              "edge_feat": rng.normal(size=(e, cfg.d_edge_in)).astype(np.float32),
              "target": rng.normal(size=(n, cfg.d_out)).astype(np.float32),
              "label_mask": (rng.random(n) < 0.7).astype(np.float32)}
    elif arch == "dimenet":
        t_in, t_out, t_mask = j_build_triplets(src, dst, 4 * e)
        b |= {"pos": rng.normal(size=(n, 3)).astype(np.float32) * 2,
              "z": rng.integers(1, 9, (n, 1)).astype(np.float32),
              "t_in": t_in.astype(np.int32), "t_out": t_out.astype(np.int32),
              "triplet_mask": t_mask,
              "graph_id": np.sort(rng.integers(0, 4, n)).astype(np.int32),
              "target": rng.normal(size=(4, 1)).astype(np.float32)}
    else:
        nc = cfg.n_coeff
        b |= {"x": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
              "wigner": (rng.normal(size=(e, nc, nc)) * 0.2).astype(np.float32),
              "labels": rng.integers(0, cfg.d_out, n).astype(np.int32),
              "label_mask": (rng.random(n) < 0.8).astype(np.float32)}
    return b


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def reference(arch, cfg, batch, seed=0):
    """The reference's weights (numpy), loss and gradients."""
    j_init, j_loss, _ = J_FNS[arch]
    params = j_init(jax.random.PRNGKey(seed), cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, jb, cfg)))(params)
    return jax.tree.map(np.asarray, params), float(loss), jax.tree.leaves(grads)


def port_value_and_grad(loss_fn, params, batch, cfg):
    leaves = param_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = loss_fn(params, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))


def hold_grads(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **tol)


@pytest.mark.parametrize("arch", list(ARCH))
def test_loss_and_every_gradient_leaf_match_jax_value_and_grad(arch):
    cfg = j_get_arch(ARCH[arch]).smoke_config()
    batch = graph_batch(arch, cfg, seed=1)
    ref_params, want_loss, want_grads = reference(arch, cfg, batch)
    params = gnn.params_from_reference(ref_params, "cpu")
    loss, grads = port_value_and_grad(T_FNS[arch][1], params, to_torch(batch), cfg)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    hold_grads(grads, want_grads)


@pytest.mark.parametrize("arch", list(ARCH))
def test_forward_matches_the_reference(arch):
    cfg = j_get_arch(ARCH[arch]).smoke_config()
    batch = graph_batch(arch, cfg, seed=2)
    j_init, _, j_fwd = J_FNS[arch]
    ref = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(3), cfg))
    want = np.asarray(j_fwd(jax.tree.map(jnp.asarray, ref),
                            {k: jnp.asarray(v) for k, v in batch.items()}, cfg))
    with torch.no_grad():
        got = T_FNS[arch][2](gnn.params_from_reference(ref, "cpu"),
                             to_torch(batch), cfg)
    assert tuple(got.shape) == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("arch", list(ARCH))
def test_init_trees_match_the_reference(arch):
    """Structure, shapes and dtypes of ``init_*`` at the smoke and the full
    config (on ``meta`` for the full one), and the draws' scales."""
    j_init, t_init = J_FNS[arch][0], T_FNS[arch][0]
    for cfg in (j_get_arch(ARCH[arch]).smoke_config(),
                j_get_arch(ARCH[arch]).full_config()):
        want = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), cfg))
        got = t_init(cfg, seed=0, device="meta")
        g_leaves, g_def = tree_flatten(got)
        w_leaves, w_def = jax.tree.flatten(want)
        assert str(g_def) == str(w_def)
        for g, w in zip(g_leaves, w_leaves):
            assert g.device.type == "meta"
            assert tuple(g.shape) == tuple(w.shape)
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    cfg = j_get_arch(ARCH[arch]).smoke_config()
    got = t_init(cfg, seed=5, device="cpu")
    again = t_init(cfg, seed=5, device="cpu")
    ref = jax.tree.leaves(j_init(jax.random.PRNGKey(5), cfg))
    for g, a, w in zip(tree_flatten(got)[0], tree_flatten(again)[0], ref):
        assert torch.equal(g, a)                 # seeded
        w = np.asarray(w)
        if w.std() > 0:                          # the same distribution's scale
            assert 0.5 < float(g.std()) / float(w.std()) < 2.0
        else:
            assert torch.equal(g, torch.as_tensor(w))


def test_params_round_trip_through_the_reference_layout():
    cfg = j_get_arch("graphcast").smoke_config()
    params = gnn.init_graphcast(cfg, seed=2, device="cpu")
    ref = gnn.params_to_reference(params)
    assert all(isinstance(a, np.ndarray) for a in jax.tree.leaves(ref))
    back = gnn.params_from_reference(ref, "cpu")
    for a, b in zip(tree_flatten(params)[0], tree_flatten(back)[0]):
        assert torch.equal(a, b)


def test_graphsage_on_a_fanout_sampled_subgraph():
    """The minibatch_lg layout: seeds and two hops of a fanout sample
    (15 then 10 at full size; 4 then 3 here) as one padded edge list."""
    cfg = j_get_arch("graphsage-reddit").smoke_config()
    rng = np.random.default_rng(6)
    n_graph = 300
    src, dst = rng.integers(0, n_graph, 2400), rng.integers(0, n_graph, 2400)
    indptr, indices = build_csr(src, dst, n_graph)
    seeds = rng.choice(n_graph, 8, replace=False)
    blocks = fanout_sample(indptr, indices, seeds, [4, 3], seed=1)
    frontier = [blocks.seeds] + [nb.reshape(-1) for nb in blocks.nbr]
    nodes = np.concatenate(frontier)           # local ids = positions here
    offs = np.cumsum([0] + [len(f) for f in frontier])
    e_src, e_dst, e_mask = [], [], []
    for h, (nb, msk) in enumerate(zip(blocks.nbr, blocks.nbr_mask)):
        n_dst, fan = nb.shape
        e_dst.append(np.repeat(offs[h] + np.arange(n_dst), fan))
        e_src.append(offs[h + 1] + np.arange(n_dst * fan))
        e_mask.append(msk.reshape(-1))
    feats = rng.normal(size=(n_graph, cfg.d_in)).astype(np.float32)
    batch = {"x": feats[nodes], "edge_src": np.concatenate(e_src).astype(np.int32),
             "edge_dst": np.concatenate(e_dst).astype(np.int32),
             "edge_mask": np.concatenate(e_mask),
             "labels": rng.integers(0, cfg.n_classes, len(nodes)).astype(np.int32),
             "label_mask": (np.arange(len(nodes)) < len(seeds)).astype(np.float32)}
    ref_params, want_loss, want_grads = reference("graphsage", cfg, batch)
    loss, grads = port_value_and_grad(gnn.sage_loss,
                                      gnn.params_from_reference(ref_params, "cpu"),
                                      to_torch(batch), cfg)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    hold_grads(grads, want_grads)


def test_dimenet_without_graph_ids_predicts_per_node():
    cfg = j_get_arch("dimenet").smoke_config()
    batch = graph_batch("dimenet", cfg, seed=7)
    batch.pop("graph_id")
    batch["target"] = np.random.default_rng(8).normal(size=(40, 1)).astype(np.float32)
    ref_params, want_loss, want_grads = reference("dimenet", cfg, batch)
    loss, grads = port_value_and_grad(gnn.dimenet_loss,
                                      gnn.params_from_reference(ref_params, "cpu"),
                                      to_torch(batch), cfg)
    np.testing.assert_allclose(float(loss), want_loss, **TOL)
    hold_grads(grads, want_grads)


def test_equiformer_bf16_branch_within_bf16_of_the_reference():
    cfg = j_get_arch("equiformer-v2").smoke_config()
    batch = graph_batch("equiformer", cfg, seed=9)
    ref_params, want_loss, want_grads = reference("equiformer", cfg, batch)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    params = gnn.params_from_reference(ref_params, "cpu")
    loss, grads = port_value_and_grad(gnn.eqv2_loss, params, to_torch(batch), bf16)
    f32_loss, _ = port_value_and_grad(gnn.eqv2_loss, params, to_torch(batch), cfg)
    assert float(loss) != float(f32_loss)
    np.testing.assert_allclose(float(loss), want_loss, rtol=2e-2)
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        assert g.dtype == torch.float32
        assert float(np.abs(g.numpy() - w).max()) <= 0.05 * np.abs(w).max() + 1e-6


@pytest.mark.parametrize("arch", list(ARCH))
def test_the_cells_train_step_equals_the_references(arch):
    """One step of the registry's ``molecule`` cell (smoke config; the
    cell's shape-adapted ``d_in``) from the reference's state: loss,
    gradient norm and every parameter after AdamW."""
    cell = list_cells(ARCH[arch], smoke=True)["molecule"]
    j_cell = j_list_cells(ARCH[arch], smoke=True)["molecule"]
    cfg = cell.config
    batch = graph_batch(arch, cfg, seed=10)
    if arch == "dimenet":
        batch["target"] = batch["target"][:4]
    j_init = J_FNS[arch][0]
    jp = j_init(jax.random.PRNGKey(0), cfg)
    j_state = JTrainState(jp, j_adamw_init(jp), jax.random.PRNGKey(0))
    j_new, j_m = jax.jit(j_cell.make_step(JSharder(None)))(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    params = gnn.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    state, m = cell.make_step(Sharder(None))(
        TrainState(params, adamw_init(params), 0), to_torch(batch))
    np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(j_m["grad_norm"]), **TOL)
    assert int(m["step"]) == int(j_m["step"]) == 1
    for g, w in zip(tree_flatten(state.params)[0], jax.tree.leaves(j_new.params)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
