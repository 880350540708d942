"""The LMs' prefill over a mesh (``models.transformer.sharded``), its
sharding helpers (``Sharder.act`` / ``params`` / ``place``) and
collectives (``all_gather``, ``psum``, ``reduce_scatter``, ``resplit``),
against the JAX package.

Each LM's ``prefill_32k`` cell runs through ``make_step(Sharder.for_mesh(
mesh))`` on the tiny meshes of 8 CPU positions, its smoke config in
float32 with the reference's weights carried across (``convert``), and is
held to the reference's unsharded ``prefill`` (JAX on the CPU) within the
LM tests' float32 tolerance, rtol = atol = 1e-4 (measured max abs gap
5.4e-06 over the logits, up to 4.4, and every cache leaf).  The cell's sequence length and batch are
cut to ``MAX_LEN`` x ``BATCH`` (``registry.LM_SHAPES`` patched, as the
launcher tests cut ``train_4k``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    init_lm_params as j_init,
    lm_param_specs as j_lm_param_specs,
    prefill as j_prefill,
)
from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    DuplicateSpecError,
    NamedSharding,
    Sharder,
    ShardedTensor,
)
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import observe  # noqa: E402
from repro_torch.distributed.sharding import shard_bounds  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_tiny_mesh  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    lm_param_specs,
    params_from_reference,
)
from repro_torch.models.transformer.config import MoEConfig  # noqa: E402
from repro_torch.models.transformer.model import param_shapes  # noqa: E402
from repro_torch.models.transformer.moe import (  # noqa: E402
    init_moe,
    moe_apply,
    moe_apply_mesh,
)
from repro_torch.train.checkpoint import tree_flatten  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
         "dbrx-132b"]
MESHES = [False, True]          # (2, 4) and (2, 2, 2)
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, PROMPT, MAX_LEN = 4, 100, 128


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


# -- the prefill cells against the reference --------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """One arch's smoke config in float32: the reference's weights, tokens
    from a seed, and the reference's unsharded prefill of them."""
    arch = request.param
    jcfg = dataclasses.replace(j_get_arch(arch).smoke_config(), dtype="float32")
    cfg = dataclasses.replace(get_arch(arch).smoke_config(), dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (BATCH, PROMPT))
    last, cache = jax.jit(lambda p, t: j_prefill(p, t, jcfg, MAX_LEN))(
        jp, jnp.asarray(toks, jnp.int32))
    return dict(cfg=cfg, tree=jax.tree.map(np.asarray, jp), toks=toks,
                last=np.asarray(last, np.float32),
                cache={k: np.asarray(v, np.float32) for k, v in cache.items()
                       if k != "len"}, len=int(cache["len"]))


def prefill_cell(monkeypatch, cfg):
    monkeypatch.setitem(registry.LM_SHAPES, "prefill_32k",
                        (MAX_LEN, BATCH, "prefill"))
    return registry.lm_cells(cfg)["prefill_32k"]


def assert_laid_out(got: ShardedTensor, want: NamedSharding, mesh):
    """``got``'s shards are ``want``'s slices of its gathered value, each on
    its position's device."""
    whole = got.gather()
    assert got.sharding.spec == want.spec
    for p, shard in enumerate(got.shards):
        idx = want.shard_slices(p, got.shape)
        assert got.sharding.shard_slices(p, got.shape) == idx
        assert shard.device == mesh.devices.flat[p]
        assert torch.equal(shard, whole[idx])


@pytest.mark.parametrize("multi", MESHES, ids=["tiny", "tiny_multipod"])
def test_prefill_cell_on_a_mesh_equals_the_reference(reference, multi,
                                                     monkeypatch):
    cfg = reference["cfg"]
    cell = prefill_cell(monkeypatch, cfg)
    mesh = tiny(multi)
    shard = Sharder.for_mesh(mesh)
    model = params_from_reference(reference["tree"], cfg, "cpu")
    watch = Moves()
    with observe.observing(watch):
        last, cache = cell.make_step(shard)(
            model, torch.from_numpy(reference["toks"]))
    np.testing.assert_allclose(last.gather().numpy(), reference["last"], **TOL)
    assert cache["len"] == reference["len"] == PROMPT
    for name, want in reference["cache"].items():
        assert cache[name].shape == want.shape
        np.testing.assert_allclose(cache[name].gather().numpy(), want, **TOL)
    out_sh = cell.out_shardings(shard)
    assert_laid_out(last, out_sh[0], mesh)
    for name in reference["cache"]:
        assert_laid_out(cache[name], out_sh[1][name], mesh)
    kinds = watch.by_kind()
    # FSDP gathers and column blocks, row-parallel sums; an MoE's buffers
    assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0
    assert ("all-to-all" in kinds) == (cfg.moe is not None)


def test_prefill_takes_the_reference_tree_and_refuses_seq_parallel(
        reference, monkeypatch):
    """The dry-run's input, the reference's tree with layers stacked on
    ``[L]``, gives what the module gives; under sequence parallelism on a
    mesh with "model" the step raises ``DuplicateSpecError`` where the
    reference's does: its logits' layout ``("batch", "seq", "model")``
    names "model" twice, which jax's ``NamedSharding`` refuses."""
    cfg = reference["cfg"]
    cell = prefill_cell(monkeypatch, cfg)
    def tensors(t):
        return {k: tensors(v) for k, v in t.items()} if isinstance(t, dict) \
            else torch.from_numpy(np.array(t))
    tree = tensors(reference["tree"])
    mesh = tiny(False)
    last, _ = cell.make_step(Sharder.for_mesh(mesh))(
        tree, torch.from_numpy(reference["toks"]))
    np.testing.assert_allclose(last.gather().numpy(), reference["last"], **TOL)
    j_mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1] * 8, dtype=object).reshape(2, 4),
        ("data", "model"))
    with pytest.raises(Exception) as j_err:
        JSharder.for_mesh(j_mesh, seq_parallel=True).named(
            "batch", "seq", "model")
    assert type(j_err.value).__name__ == "DuplicateSpecError"
    with pytest.raises(DuplicateSpecError):
        cell.make_step(Sharder.for_mesh(mesh, seq_parallel=True))(
            tree, torch.from_numpy(reference["toks"]))


def test_seq_parallel_prefill_without_a_model_axis_equals_the_reference(
        reference, monkeypatch):
    """On an 8-position ``("data",)`` mesh ``"seq"`` resolves to None, so
    the flag changes nothing: the prefill runs (the reference's does too)
    and equals the reference's unsharded prefill, 4 rows over 8 data
    positions (the last four empty)."""
    cfg = reference["cfg"]
    cell = prefill_cell(monkeypatch, cfg)
    mesh = make_mesh((8,), ("data",), ["cpu"] * 8)
    shard = Sharder.for_mesh(mesh, seq_parallel=True)
    assert shard.spec("batch", "seq", "model") == ("data", None, None)
    model = params_from_reference(reference["tree"], cfg, "cpu")
    last, cache = cell.make_step(shard)(model,
                                        torch.from_numpy(reference["toks"]))
    np.testing.assert_allclose(last.gather().numpy(), reference["last"], **TOL)
    assert cache["len"] == reference["len"]
    for name, want in reference["cache"].items():
        np.testing.assert_allclose(cache[name].gather().numpy(), want, **TOL)


SPECS = [("data", "model"), (("model", "data"),), (), (None, "model"),
         ("data", "model", "model"), (("data", "model"), "model"),
         (("data", "data"),), ("data", None, "data"), (None, "nope")]


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_named_sharding_refuses_what_jax_refuses(spec):
    """The port's ``NamedSharding`` accepts and refuses at construction the
    specs jax's does: an axis named twice (``DuplicateSpecError``, a plain
    ``Exception`` in both) or an axis the mesh lacks (``ValueError``)."""
    j_mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1] * 8, dtype=object).reshape(2, 4),
        ("data", "model"))
    mesh = tiny(False)
    try:
        jax.sharding.NamedSharding(j_mesh, jax.sharding.PartitionSpec(*spec))
        want = None
    except Exception as e:      # noqa: BLE001 - the kind is compared
        want = type(e).__name__
    try:
        NamedSharding(mesh, spec)
        got = None
    except Exception as e:      # noqa: BLE001
        got = type(e).__name__
    assert got == want
    assert issubclass(DuplicateSpecError, Exception)
    assert not issubclass(DuplicateSpecError, ValueError)


# -- the parameters' shardings ------------------------------------------------------

@pytest.mark.parametrize("multi", MESHES, ids=["tiny", "tiny_multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharder_params_equal_the_reference(arch, multi):
    axes = ("pod", "data", "model") if multi else ("data", "model")
    grid = (2, 2, 2) if multi else (2, 4)
    j_mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1] * 8, dtype=object).reshape(grid), axes)
    jcfg, cfg = j_get_arch(arch).smoke_config(), get_arch(arch).smoke_config()
    mesh = tiny(multi, "meta")
    got = Sharder.for_mesh(mesh).params(lm_param_specs(cfg),
                                        param_shapes(cfg))
    jp = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
    want = JSharder.for_mesh(j_mesh).params(j_lm_param_specs(jcfg), jp)
    got_leaves, _ = tree_flatten(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) > 0
    for g, w in zip(got_leaves, want_leaves):
        assert isinstance(g, NamedSharding) and g.mesh is mesh
        assert g.spec == tuple(w.spec) and not g.uneven


def test_sharder_place_puts_each_leaf_by_its_spec():
    mesh = tiny(False)
    shard = Sharder.for_mesh(mesh)
    tree = {"w": torch.arange(32.).reshape(4, 8), "b": [torch.arange(6.)]}
    placed = shard.place({"w": ("data", "model"), "b": [(None,)]}, tree)
    assert placed["w"].sharding.spec == ("data", "model")
    assert all(s.shape == (2, 2) for s in placed["w"].shards)
    assert torch.equal(placed["w"].gather(), tree["w"])
    assert all(torch.equal(s, tree["b"][0]) for s in placed["b"][0].shards)
    assert Sharder(None).place({"w": ("data",)}, tree) is tree
    with pytest.raises(ValueError, match="does not divide"):
        shard.place({"w": (None, "model")}, {"w": torch.zeros(2, 6)})


# -- act's uneven rule --------------------------------------------------------------------

def test_act_splits_an_uneven_dim_as_gspmd_pads():
    """A dim that does not divide splits ``ceil(n / k)`` a shard, the last
    short or empty; a parameter's sharding still raises.  From a tensor
    every position holds nothing moves; a re-split moves each piece a
    position lacks once, from the position that holds it."""
    mesh = tiny(False)
    shard = Sharder.for_mesh(mesh)
    x = torch.arange(3 * 5 * 6, dtype=torch.float32).reshape(3, 5, 6)
    watch = Moves()
    with observe.observing(watch):
        a = shard.act(x, "batch", None, "model")
    assert watch.moves == []
    assert a.sharding.uneven and a.sharding.spec == ("data", None, "model")
    assert [tuple(s.shape) for s in a.shards] == [
        (2, 5, 2), (2, 5, 2), (2, 5, 2), (2, 5, 0),
        (1, 5, 2), (1, 5, 2), (1, 5, 2), (1, 5, 0)]
    assert torch.equal(a.gather(), x)
    with pytest.raises(ValueError, match="does not divide"):
        shard.named("batch", None, "model").shard_shape(x.shape)
    with observe.observing(watch):
        b = shard.act(a, None, "model", None)
    assert [s.shape[1] for s in b.shards] == [2, 2, 1, 0] * 2
    assert torch.equal(b.gather(), x)
    # each position lacks all of its sequence block but the part it held
    rows, seqs, cols = [(0, 2), (2, 3)], [(0, 2), (2, 4), (4, 5), (5, 5)], \
        [(0, 2), (2, 4), (4, 6), (6, 6)]
    want = 0
    for d in range(2):
        for m in range(4):
            n_seq = seqs[m][1] - seqs[m][0]
            own = (rows[d][1] - rows[d][0]) * (cols[m][1] - cols[m][0])
            want += (3 * 6 - own) * n_seq * 4
    assert {k for k, *_ in watch.moves} == {"all-to-all"}
    assert sum(n for *_, n in watch.moves) == want
    # the same layout again: nothing moves, the shards are kept
    watch.moves.clear()
    with observe.observing(watch):
        c = shard.act(b, None, "model", None)
    assert watch.moves == [] and c.shards == b.shards
    # a split dropped: an all-gather
    with observe.observing(watch):
        d = shard.act(a, "batch", None, None)
    assert {k for k, *_ in watch.moves} == {"all-gather"}
    assert all(torch.equal(s, x[:2]) for s in d.shards[:4])


# -- the collectives ----------------------------------------------------------------------

@pytest.mark.parametrize("multi,axis", [
    (False, "model"), (False, "data"), (True, ("pod", "data")),
    (True, "model"), (True, ("pod", "data", "model"))])
def test_collectives_against_plain_sums_and_concatenations(multi, axis):
    mesh = tiny(multi)
    groups = col.axis_groups(mesh, axis)
    rank = {int(q): i for group in groups for i, q in enumerate(group)}
    rng = np.random.default_rng(3)
    pieces = [torch.from_numpy(rng.standard_normal((2, 3 + rank[p] % 2)))
              for p in range(mesh.size)]
    even = [torch.from_numpy(rng.standard_normal((2, 5)))
            for _ in range(mesh.size)]
    watch = Moves()
    with observe.observing(watch):
        gathered = col.all_gather(pieces, mesh, axis, -1)
        summed = col.psum(even, mesh, axis)
        scattered = col.reduce_scatter(even, mesh, axis, -1)
    k = groups.shape[1]
    want_bytes = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0}
    for group in groups:
        members = [int(q) for q in group]
        cat = torch.cat([pieces[q] for q in members], dim=-1)
        total = even[members[0]].clone()
        for q in members[1:]:
            total = total + even[q]
        c = -(-5 // k)
        for i, p in enumerate(members):
            assert torch.equal(gathered[p], cat)
            assert torch.equal(summed[p], total)
            assert torch.equal(scattered[p], total[:, min(i * c, 5):
                                                  min((i + 1) * c, 5)])
            want_bytes["all-gather"] += sum(pieces[q].nbytes
                                            for q in members if q != p)
            if p != members[0]:
                want_bytes["all-reduce"] += 2 * total.nbytes
                want_bytes["reduce-scatter"] += even[p].nbytes \
                    + scattered[p].nbytes
    assert watch.by_kind() == want_bytes
    # resplit: blocks of 3 or 4 re-cut to the uneven split of the group's
    # width
    watch.moves.clear()
    with observe.observing(watch):
        cut = col.resplit(pieces, mesh, axis, -1, [
            b - a for a, b in shard_bounds(
                sum(pieces[int(q)].shape[1] for q in groups[0]), k)])
    for group in groups:
        members = [int(q) for q in group]
        cat = torch.cat([pieces[q] for q in members], dim=-1)
        lo = 0
        for p in members:
            assert torch.equal(cut[p], cat[:, lo:lo + cut[p].shape[1]])
            lo += cut[p].shape[1]
        assert lo == cat.shape[1]
    assert set(watch.by_kind()) <= {"all-to-all"}
    same = col.resplit(pieces, mesh, axis, -1,
                       [pieces[int(q)].shape[1] for q in groups[0]])
    assert all(s is t for s, t in zip(same, pieces))


def test_collectives_over_a_missing_axis_keep_each_position():
    mesh = make_mesh((2,), ("data",), ["cpu"] * 2)
    xs = [torch.ones(2), torch.zeros(2)]
    assert col.axis_groups(mesh, None).tolist() == [[0], [1]]
    assert all(a is b for a, b in zip(col.psum(xs, mesh, None), xs))
    assert all(a is b for a, b in zip(col.all_gather(xs, mesh, None, 0), xs))


# -- the MoE over a mesh ----------------------------------------------------------------

@pytest.mark.parametrize("multi,batch,seq,slab", [
    (False, 4, 10, 8192),       # one dispatch over every group's tokens
    (False, 4, 64, 64),         # slabs, one group's each
    (True, 3, 48, 72),          # an uneven batch; a slab across two groups
    (False, 2, 2048, 2048),     # capacity 1,280: slots over "data"
])
def test_moe_apply_mesh_equals_moe_apply(multi, batch, seq, slab):
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=24)
    d = 16
    gen = torch.Generator().manual_seed(5)
    p = init_moe(gen, d, moe)
    x = torch.randn((batch * seq, d), generator=gen)
    want, _ = moe_apply(type("P", (), p)(), x, moe, slab=slab)
    mesh = tiny(multi)
    shard = Sharder.for_mesh(mesh)
    rows = col.axis_groups(mesh, "model")
    groups = shard_bounds(batch, rows.shape[0])
    experts = shard_bounds(4, rows.shape[1])
    ps, xs, first = [None] * 8, [None] * 8, [0] * 8
    for g, row in enumerate(rows):
        for m, q in enumerate(row):
            e0, e1 = experts[m]
            ps[q] = {"w_router": p["w_router"],
                     **{k: p[k][e0:e1] for k in ("wi", "wg", "wo")}}
            xs[q] = x[groups[g][0] * seq:groups[g][1] * seq]
            first[q] = groups[g][0] * seq
    watch = Moves()
    with observe.observing(watch):
        ys = moe_apply_mesh(ps, xs, moe, mesh, model_axis=shard.model_axis,
                            first=first, n_tokens=batch * seq, slab=slab)
    for q in range(8):
        torch.testing.assert_close(ys[q], want[first[q]:first[q] + len(xs[q])],
                                   rtol=1e-5, atol=1e-5)
    kinds = watch.by_kind()
    assert kinds["all-reduce"] > 0
    assert kinds["all-to-all"] > 0
