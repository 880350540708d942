"""The LMs' train step over a mesh (``train.loop``'s mesh step,
``models.transformer.sharded_train``, ``optimizer.adamw_update_mesh``),
the collectives' backward, the positions of a backward and
``data.shard_batch(shardings=)``, against the JAX package.

Each LM's ``train_4k`` cell runs through ``make_step(Sharder.for_mesh(
mesh))`` on the tiny meshes of 8 CPU positions, its smoke config in
float32 with the reference's weights, 2 microbatches.  The reference's
jitted ``make_train_step(lm_loss)`` takes two steps from its fresh state;
the port starts from the reference's state after the first (parameters and
moments placed by the cell's ``in_shardings``, each position's shards a
copy of their own, so that every replica steps by itself) and takes the
second: ``loss``, ``grad_norm``, ``step`` and every gathered leaf of the
parameters and both moments within the LM tests' float32 tolerance, rtol =
atol = 1e-4, and every replica of a block bit-equal to its first holder's.
The cell's batch and length are cut to ``BATCH`` x ``SEQ``
(``registry.LM_SHAPES`` patched, as the launcher tests cut ``train_4k``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models.common import cross_entropy as j_cross_entropy  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    init_lm_params as j_init,
    lm_loss as j_lm_loss,
)
from repro.train.loop import make_train_step as j_make_train_step  # noqa: E402
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.train_state import TrainState as JTrainState  # noqa: E402
from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.data import shard_batch  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    DuplicateSpecError,
    Sharder,
    ShardedTensor,
)
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import observe  # noqa: E402
from repro_torch.distributed.sharding import put_tree, shard_bounds  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_tiny_mesh  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.models.transformer.config import MoEConfig  # noqa: E402
from repro_torch.models.transformer.moe import (  # noqa: E402
    init_moe,
    moe_apply,
    moe_apply_mesh,
)
from repro_torch.models.transformer.sharded import _Layout  # noqa: E402
from repro_torch.models.transformer.sharded_train import _nll_sums  # noqa: E402
from repro_torch.train import TrainState  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
         "dbrx-132b"]
MESHES = [False, True]          # (2, 4) and (2, 2, 2)
MESH_IDS = ["tiny", "tiny_multipod"]
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ, MICRO = 4, 24, 2


def tiny(multi, device="cpu"):
    return make_tiny_mesh(multi_pod=multi, devices=[device] * 8)


class Moves:
    """An observer that keeps every move."""

    def __init__(self):
        self.moves = []

    def move(self, kind, src, dst, nbytes):
        self.moves.append((kind, src, dst, nbytes))

    def kernel(self, name, flops, nbytes):
        pass

    def by_kind(self):
        out = {}
        for kind, _, _, n in self.moves:
            out[kind] = out.get(kind, 0) + n
        return out


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def placed(tree, shardings):
    """``tree``'s tensors placed by a matching tree of ``NamedSharding``
    (``put_tree``), each position's shard a copy of its own."""
    def copy(st):
        if not isinstance(st, ShardedTensor):
            return st
        return ShardedTensor(st.sharding, st.shape,
                             tuple(s.clone() for s in st.shards))
    return tck.tree_map(copy, put_tree(tree, shardings))


def gathered(tree):
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return tree.gather().numpy()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# -- the train cells against the reference --------------------------------------

@functools.lru_cache(maxsize=None)
def reference_for(arch):
    """One arch's smoke config in float32: the reference's state after one
    and after two jitted steps on one batch, with the second step's
    metrics."""
    jcfg = dataclasses.replace(j_get_arch(arch).smoke_config(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # a label in the vocabulary's last real column
    batch["labels"][0, 0] = cfg.vocab_size - 1
    jstep = jax.jit(j_make_train_step(lambda p, b: j_lm_loss(p, b, jcfg),
                                      n_microbatches=MICRO))
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    state = JTrainState(jp, j_adamw_init(jp), jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    first, _ = jstep(state, jb)
    second, metrics = jstep(first, jb)
    host = lambda s: jax.tree.map(np.asarray, (s.params, s.opt.m, s.opt.v,
                                               s.opt.step))
    return dict(cfg=cfg, batch=batch, first=host(first), second=host(second),
                metrics={k: float(v) for k, v in metrics.items()})


@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    return reference_for(request.param)


def train_cell(monkeypatch, cfg):
    monkeypatch.setitem(registry.LM_SHAPES, "train_4k",
                        (SEQ, BATCH, "train"))
    return registry.lm_cells(cfg, n_microbatches=MICRO)["train_4k"]


def mesh_state(reference, cell, shard):
    params, m, v, step = reference["first"]
    return placed(TrainState(to_torch(params), AdamWState(
        to_torch(step), to_torch(m), to_torch(v)), 0),
        cell.in_shardings(shard)[0])


def assert_second_step(reference, state, metrics):
    want = reference["metrics"]
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"], **TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want["grad_norm"],
                               **TOL)
    assert int(metrics["step"]) == int(want["step"]) == 2
    params, m, v, _ = reference["second"]
    for got, exp in ((state.params, params), (state.opt.m, m),
                     (state.opt.v, v)):
        got, exp = flat(gathered(got)), flat(exp)
        assert got.keys() == exp.keys()
        for name in exp:
            np.testing.assert_allclose(got[name], exp[name], err_msg=name,
                                       **TOL)


@pytest.mark.parametrize("multi", MESHES, ids=MESH_IDS)
def test_train_cell_on_a_mesh_equals_the_reference(reference, multi,
                                                   monkeypatch):
    cfg = reference["cfg"]
    cell = train_cell(monkeypatch, cfg)
    mesh = tiny(multi)
    shard = Sharder.for_mesh(mesh)
    state = mesh_state(reference, cell, shard)
    before = tck.tree_flatten(state)[0]
    batch = shard_batch(reference["batch"], cell.in_shardings(shard)[1])
    watch = Moves()
    with observe.observing(watch):
        out, metrics = cell.make_step(shard)(state, batch)
    assert_second_step(reference, out, metrics)
    # the same layout, updated in place; every replica bit-equal
    after = tck.tree_flatten(out)[0]
    for a, b in zip(before[:-1], after[:-1]):
        if isinstance(a, ShardedTensor) and a.shape:
            assert b is a
    for leaf in tck.tree_flatten((out.params, out.opt.m, out.opt.v))[0]:
        for group in leaf.holders():
            for q in group[1:]:
                assert torch.equal(leaf.shards[q], leaf.shards[group[0]])
    assert out.opt.step.sharding == cell.in_shardings(shard)[0].opt.step
    kinds = watch.by_kind()
    # FSDP's gathers and their reduce-scatters; the row-parallel sums, the
    # vocabulary-split softmax and the replicas' sums; the microbatches'
    # rows re-split over the data groups, and an MoE's buffers
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0
    assert kinds["all-reduce"] > 0
    n_groups = col.axis_groups(mesh, "model").shape
    held = shard_bounds(BATCH, n_groups[0])
    mb = BATCH // MICRO
    rows = 0
    for i in range(MICRO):
        for g, (a, b) in enumerate(shard_bounds(mb, n_groups[0])):
            rows += sum(not held[g][0] <= i * mb + r < held[g][1]
                        for r in range(a, b))
    resplit = rows * n_groups[1] * SEQ * 4 * 2
    assert resplit > 0
    if cfg.moe is None:
        assert kinds["all-to-all"] == resplit
    else:
        assert kinds["all-to-all"] > resplit


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi3.5-moe-42b"])
def test_train_step_restored_onto_another_mesh(arch, monkeypatch, tmp_path):
    """The reference's state after one step, saved unsharded and restored
    onto (4, 2) by ``restore_checkpoint(..., shardings=)`` (shards on one
    device share storage with their replicas), steps to the reference's
    second state; under sequence parallelism the step raises
    ``DuplicateSpecError``, as the reference's does on a mesh with
    "model"."""
    reference = reference_for(arch)
    cfg = reference["cfg"]
    cell = train_cell(monkeypatch, cfg)
    params, m, v, step = reference["first"]
    whole = TrainState(to_torch(params), AdamWState(
        to_torch(step), to_torch(m), to_torch(v)), torch.zeros(2))
    tck.save_checkpoint(str(tmp_path), 1, whole)
    mesh = make_mesh((4, 2), ("data", "model"), ["cpu"] * 8)
    shard = Sharder.for_mesh(mesh)
    restored, _ = tck.restore_checkpoint(str(tmp_path), whole,
                                         shardings=cell.in_shardings(shard)[0])
    assert isinstance(restored.params["ln_f"], ShardedTensor)
    batch = {k: torch.from_numpy(v) for k, v in reference["batch"].items()}
    out, metrics = cell.make_step(shard)(restored, batch)
    assert_second_step(reference, out, metrics)
    # the reference's loss resolves its logits' layout ("batch", "seq",
    # "model") to ('data', 'model', 'model') under the flag, which jax
    # refuses: the port's raises the same error before any work
    with pytest.raises(DuplicateSpecError):
        cell.make_step(Sharder.for_mesh(mesh, seq_parallel=True))(out, batch)


# -- the vocabulary-split cross entropy ------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_vocab_split_cross_entropy_equals_cross_entropy(masked):
    """Logits ``[B, S, Vp]`` split over "model", the padding set to -1e30:
    the groups' summed nll over the token count equal ``cross_entropy`` of
    the whole (the port's and the reference's), with labels in the last
    real column and in the padding block."""
    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").smoke_config(),
                              vocab_size=500)
    vp = cfg.padded_vocab
    assert vp == 512 and vp % 4 == 0
    mesh = tiny(False)
    lay = _Layout(Sharder.for_mesh(mesh))
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((4, 6, vp)).astype(np.float32))
    logits[..., cfg.vocab_size:] = -1e30
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 6)))
    labels[0, 0] = cfg.vocab_size - 1
    labels[1, 2] = vp - 1
    mask = torch.from_numpy((rng.random((4, 6)) < 0.7).astype(np.float32))
    shard = lay.shard
    lf = list(shard.act(logits, "batch", None, "model").shards)
    lab = list(shard.act(labels, "batch", None).shards)
    mk = list(shard.act(mask, "batch", None).shards) if masked else None
    totals, counts = _nll_sums(lay, cfg, lf, lab, mk)
    assert [p for p, _ in totals] == [0, 4]
    total = sum(float(t) for _, t in totals)
    count = sum(float(c) for _, c in counts)
    got = total / count
    want = float(cross_entropy(logits, labels, mask=mask if masked else None))
    ref = float(j_cross_entropy(jnp.asarray(logits.numpy()),
                                jnp.asarray(labels.numpy()),
                                mask=jnp.asarray(mask.numpy()) if masked
                                else None))
    assert got > 1e28 or masked and mask[1, 2] == 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # without the padding label, at the LM tests' tolerance
    labels[1, 2] = 7
    lab = list(shard.act(labels, "batch", None).shards)
    totals, counts = _nll_sums(lay, cfg, lf, lab, mk)
    got = sum(float(t) for _, t in totals) / sum(float(c) for _, c in counts)
    np.testing.assert_allclose(
        got, float(cross_entropy(logits, labels, mask=mask if masked
                                 else None)), **TOL)


# -- the MoE balance term over a mesh ------------------------------------------------

@pytest.mark.parametrize("multi,batch,seq,slab", [
    (True, 3, 48, 72),          # slabs of 72 across two groups' tokens
    (False, 4, 10, 8192),       # one dispatch over every group's tokens
    (False, 2, 2048, 2048),     # capacity 1,280: slots over "data"
])
def test_moe_balance_term_over_a_mesh_equals_moe_apply(multi, batch, seq,
                                                       slab):
    """``moe_apply_mesh(..., with_aux=True)``'s term equals ``moe_apply``'s
    (the mean over slabs of ``E sum_e f_e P_e``, each slab's means over all
    its tokens, a slab spanning data groups), and so does its gradient in
    the router."""
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=24)
    d = 16
    gen = torch.Generator().manual_seed(5)
    p = init_moe(gen, d, moe)
    x = torch.randn((batch * seq, d), generator=gen)
    router = p["w_router"].clone().requires_grad_()
    _, want = moe_apply(type("P", (), {**p, "w_router": router})(), x, moe,
                        slab=slab)
    want_grad, = torch.autograd.grad(want, router)
    mesh = tiny(multi)
    shard = Sharder.for_mesh(mesh)
    rows = col.axis_groups(mesh, "model")
    groups = shard_bounds(batch, rows.shape[0])
    experts = shard_bounds(4, rows.shape[1])
    routers = [p["w_router"].clone().requires_grad_() for _ in range(8)]
    ps, xs, first = [None] * 8, [None] * 8, [0] * 8
    for g, row in enumerate(rows):
        for m, q in enumerate(row):
            e0, e1 = experts[m]
            ps[q] = {"w_router": routers[q],
                     **{k: p[k][e0:e1] for k in ("wi", "wg", "wo")}}
            xs[q] = x[groups[g][0] * seq:groups[g][1] * seq]
            first[q] = groups[g][0] * seq
    _, aux = moe_apply_mesh(ps, xs, moe, mesh, model_axis=shard.model_axis,
                            first=first, n_tokens=batch * seq, slab=slab,
                            with_aux=True)
    torch.testing.assert_close(aux, want, rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(aux, routers, allow_unused=True)
    total = sum(g for g in grads if g is not None)
    torch.testing.assert_close(total, want_grad, rtol=1e-4, atol=1e-6)


# -- the collectives' backward ------------------------------------------------------

@pytest.mark.parametrize("multi,axis", [
    (False, "model"), (False, "data"), (True, ("pod", "data")),
    (True, ("pod", "data", "model"))])
def test_collectives_backward_is_the_dual_collective(multi, axis):
    """Each collective's gradient equals plain autograd through the
    concatenation or sum it stands for, and its backward's moves are
    noted under the dual kind: an all-gather's by reduce-scatter, a
    reduce-scatter's by all-gather, an all-reduce's and a re-split's by
    their own, each of the bytes its forward moved."""
    mesh = tiny(multi)
    groups = col.axis_groups(mesh, axis)
    rng = np.random.default_rng(6)

    def leaves(shape_of):
        return [torch.from_numpy(rng.standard_normal(shape_of(p)))
                .requires_grad_() for p in range(8)]
    rank = {int(q): i for group in groups for i, q in enumerate(group)}
    k = groups.shape[1]
    cases = {
        "all-gather": (lambda xs: col.all_gather(xs, mesh, axis, -1),
                       lambda p: (2, 3 + rank[p] % 2)),
        "all-reduce": (lambda xs: col.psum(xs, mesh, axis), lambda p: (2, 5)),
        "max": (lambda xs: col.pmax(xs, mesh, axis), lambda p: (2, 5)),
        "reduce-scatter": (lambda xs: col.reduce_scatter(xs, mesh, axis, -1),
                           lambda p: (2, 5)),
        "all-to-all": (lambda xs: col.resplit(
            xs, mesh, axis, -1, [b - a for a, b in shard_bounds(4 * k, k)]),
            lambda p: (2, 3 + rank[p] % 2)),
    }
    dual = {"all-gather": "reduce-scatter", "all-reduce": "all-reduce",
            "max": "all-reduce", "reduce-scatter": "all-gather",
            "all-to-all": "all-to-all"}
    for name, (op, shape_of) in cases.items():
        if name == "all-to-all" and any(
                sum(shape_of(int(q))[1] for q in g) != 4 * k for g in groups):
            continue
        xs = leaves(shape_of)
        fwd, bwd = Moves(), Moves()
        with observe.observing(fwd):
            outs = op(xs)
        cots = [torch.from_numpy(rng.standard_normal(tuple(o.shape)))
                for o in outs]
        with observe.observing(bwd):
            got = torch.autograd.grad(outs, xs, cots, allow_unused=True)
        plain = [x.detach().clone().requires_grad_() for x in xs]
        want_outs = [None] * 8
        for group in groups:
            members = [int(q) for q in group]
            if name in ("all-gather", "all-to-all"):
                cat = torch.cat([plain[q] for q in members], dim=-1)
                lo = 0
                for q in members:
                    n = outs[q].shape[-1]
                    want_outs[q] = cat if name == "all-gather" \
                        else cat[:, lo:lo + n]
                    lo += n
            else:
                total = plain[members[0]]
                for q in members[1:]:
                    total = torch.maximum(total, plain[q]) if name == "max" \
                        else total + plain[q]
                for i, q in enumerate(members):
                    if name == "reduce-scatter":
                        a, b = shard_bounds(5, k)[i]
                        want_outs[q] = total[:, a:b]
                    else:
                        want_outs[q] = total
        for q in range(8):
            torch.testing.assert_close(outs[q], want_outs[q].detach())
        want = torch.autograd.grad(want_outs, plain, cots, allow_unused=True)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w)
        kinds = fwd.by_kind()
        if name == "max":
            kinds = {"all-reduce": kinds.get("all-reduce", 0)}
        assert set(bwd.by_kind()) <= {dual[name]}
        assert sum(bwd.by_kind().values()) == sum(kinds.values()), name
        # each backward move runs the reverse way of a forward one
        assert sorted((d, s, n) for _, s, d, n in fwd.moves) == \
            sorted((s, d, n) for _, s, d, n in bwd.moves), name


# -- the backward's positions ----------------------------------------------------------

class Positions(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each aten op's position."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func.overloadpacket.__name__,
                         observe.current_position()))
        return func(*args, **(kwargs or {}))


def test_backward_runs_at_the_forward_positions():
    """Under an observer, each autograd node made inside ``at_position``
    runs its backward at that position: a product at position 3 and one at
    position 5, moved to position 0 and summed there; the gradient moved
    back runs at the sender's position and reaches each leaf there, and
    after the backward no position is current."""
    mesh = tiny(False)
    w = [torch.randn(4, 4, requires_grad=True) for _ in range(8)]
    x = torch.randn(2, 4)
    watch = Moves()
    with observe.observing(watch):
        with observe.at_position(3):
            a = x @ w[3]
        with observe.at_position(5):
            b = x @ w[5]
        total = col.psum([a if p == 3 else b if p == 5 else
                          torch.zeros(2, 4) for p in range(8)], mesh,
                         ("data", "model"))[0]
        with Positions() as seen:
            grads = torch.autograd.grad(total.sum(), [w[3], w[5]])
        assert observe.current_position() is None
    mms = [p for name, p in seen.ops if name == "mm"]
    assert sorted(mms) == [3, 5]
    assert all(torch.equal(g, x.t() @ torch.ones(2, 4)) for g in grads)
    assert {k for k, *_ in watch.moves} == {"all-reduce"}


# -- shard_batch -----------------------------------------------------------------------------

def test_shard_batch_places_as_named_sharding():
    mesh = tiny(True)
    shard = Sharder.for_mesh(mesh)
    host = {"tokens": np.arange(24, dtype=np.int32).reshape(8, 3),
            "labels": np.arange(24, 48, dtype=np.int32).reshape(8, 3),
            "mask": np.ones((8, 3), np.float32)}
    sh = {"tokens": shard.named("batch", None),
          "labels": shard.named("batch", None), "mask": None}
    got = shard_batch(host, sh)
    for key in ("tokens", "labels"):
        assert isinstance(got[key], ShardedTensor)
        want = sh[key].place(torch.from_numpy(host[key]))
        assert got[key].sharding == sh[key] and got[key].shape == (8, 3)
        assert all(torch.equal(a, b) for a, b in zip(got[key].shards, want))
    assert isinstance(got["mask"], torch.Tensor)
    assert torch.equal(got["mask"], torch.ones(8, 3))
    assert torch.equal(shard_batch(host, device="cpu")["tokens"],
                       torch.from_numpy(host["tokens"]))
    with pytest.raises(ValueError, match="no device="):
        shard_batch(host, sh, device="cpu")
