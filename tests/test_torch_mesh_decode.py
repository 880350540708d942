"""The LMs' decode over a mesh (``models.transformer.sharded.decode_on_mesh``)
and ``collectives.pmax``, against the JAX package.

Each LM's ``prefill_32k`` and ``decode_32k`` cells run through
``make_step(Sharder.for_mesh(mesh))`` on the tiny meshes of 8 CPU
positions, the smoke config in float32 with the reference's weights carried
across (``params_from_reference``): the sharded prefill fills the cache laid
out by ``cache_specs`` (the sequence over "model") and three decode steps
run on it.  They are held to the reference's unsharded ``prefill`` and
``decode_step`` (JAX on the CPU), fed the same tokens, within the LM tests'
float32 tolerance, rtol = atol = 1e-4, on the logits of every step and on
every cache leaf.  The cells' length and batch are cut to ``MAX_LEN`` x
``BATCH`` (``registry.LM_SHAPES`` patched, as the prefill tests cut
``prefill_32k``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models.transformer import (  # noqa: E402
    decode_step as j_decode_step,
    init_lm_params as j_init,
    prefill as j_prefill,
)
from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.distributed import NamedSharding, Sharder, ShardedTensor  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import observe  # noqa: E402
from repro_torch.distributed.sharding import shard_bounds  # noqa: E402
from repro_torch.launch.mesh import make_tiny_mesh  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    decode_step,
    init_lm_params,
    params_from_reference,
    prefill,
)
from repro_torch.models.transformer.config import MoEConfig  # noqa: E402
from repro_torch.models.transformer.model import cache_specs  # noqa: E402
from repro_torch.models.transformer.moe import (  # noqa: E402
    init_moe,
    moe_apply,
    moe_apply_mesh,
)
from repro_torch.models.transformer.sharded import cache_len_of  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
         "dbrx-132b"]
MESHES = [False, True]          # (2, 4) and (2, 2, 2)
MESH_IDS = ["tiny", "tiny_multipod"]
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, PROMPT, MAX_LEN, STEPS = 4, 100, 128, 3


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


def cells(monkeypatch, cfg):
    monkeypatch.setitem(registry.LM_SHAPES, "prefill_32k",
                        (MAX_LEN, BATCH, "prefill"))
    monkeypatch.setitem(registry.LM_SHAPES, "decode_32k",
                        (MAX_LEN, BATCH, "decode"))
    out = registry.lm_cells(cfg)
    return out["prefill_32k"], out["decode_32k"]


def float32(arch, **kw):
    return dataclasses.replace(get_arch(arch).smoke_config(),
                               dtype="float32", **kw)


def prompts(cfg, batch=BATCH, length=PROMPT, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, length)))


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


# -- the decode cells against the reference ----------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def reference(request):
    """One arch's smoke config in float32: the reference's weights, prompts
    from a seed, the reference's unsharded prefill and ``STEPS`` decode
    steps fed its own greedy tokens: each step's tokens and logits and the
    final cache."""
    arch = request.param
    jcfg = dataclasses.replace(j_get_arch(arch).smoke_config(), dtype="float32")
    cfg = float32(arch)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    toks = prompts(cfg).numpy()
    last, cache = jax.jit(lambda p, t: j_prefill(p, t, jcfg, MAX_LEN))(
        jp, jnp.asarray(toks, jnp.int32))
    step = jax.jit(lambda p, c, t: j_decode_step(p, c, t, jcfg))
    fed, logits = [], []
    for _ in range(STEPS):
        t = jnp.argmax(last[:, :cfg.vocab_size], axis=-1).astype(jnp.int32)
        last, cache = step(jp, cache, t)
        fed.append(np.asarray(t))
        logits.append(np.asarray(last, np.float32))
    return dict(cfg=cfg, tree=jax.tree.map(np.asarray, jp), toks=toks,
                fed=fed, logits=logits,
                cache={k: np.asarray(v, np.float32) for k, v in cache.items()
                       if k != "len"}, len=int(cache["len"]))


@pytest.mark.parametrize("multi", MESHES, ids=MESH_IDS)
def test_decode_cell_on_a_mesh_equals_the_reference(reference, multi,
                                                    monkeypatch):
    cfg = reference["cfg"]
    pre, dec = cells(monkeypatch, cfg)
    mesh = tiny(multi)
    shard = Sharder.for_mesh(mesh)
    model = params_from_reference(reference["tree"], cfg, "cpu")
    _, cache = pre.make_step(shard)(model, torch.from_numpy(reference["toks"]))
    step = dec.make_step(shard)
    out_sh = dec.out_shardings(shard)
    watch = Moves()
    for t, want in zip(reference["fed"], reference["logits"]):
        with observe.observing(watch):
            logits, cache = step(model, cache, torch.from_numpy(t))
        np.testing.assert_allclose(logits.gather().numpy(), want, **TOL)
        assert_laid_out(logits, out_sh[0], mesh)
    assert cache["len"] == reference["len"] == PROMPT + STEPS
    for name, want in reference["cache"].items():
        assert cache[name].shape == want.shape
        np.testing.assert_allclose(cache[name].gather().numpy(), want, **TOL)
        assert_laid_out(cache[name], out_sh[1][name], mesh)
    kinds = watch.by_kind()
    # FSDP gathers, the new entry's gathers, the split softmax's pmax and
    # psum, the row-parallel sums; an MoE's buffers
    assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0
    assert ("all-to-all" in kinds) == (cfg.moe is not None)


def test_decode_takes_a_whole_cache_and_the_reference_tree(reference,
                                                           monkeypatch):
    """A cache of whole tensors (the unsharded prefill's) is placed by
    ``Sharder.act``, each position taking its block, nothing moved; the
    reference's stacked tree serves as the parameters; a tensor ``len`` is
    read.; under
    sequence parallelism the step runs and equals the step without the
    flag bit for bit (and the reference's within ``TOL``), as the
    reference's decode runs unchanged."""
    cfg = reference["cfg"]
    _, dec = cells(monkeypatch, cfg)
    mesh = tiny(False)
    shard = Sharder.for_mesh(mesh)
    model = params_from_reference(reference["tree"], cfg, "cpu")
    toks = torch.from_numpy(reference["toks"])
    _, whole = prefill(model, toks, cfg, MAX_LEN)
    whole["len"] = torch.tensor(whole["len"], dtype=torch.int32)

    def tensors(t):
        return {k: tensors(v) for k, v in t.items()} if isinstance(t, dict) \
            else torch.from_numpy(np.array(t))
    watch = Moves()
    with observe.observing(watch):
        placed = {name: shard.act(leaf, *cache_specs(cfg)[name])
                  for name, leaf in whole.items() if name != "len"}
    assert watch.moves == []
    logits, cache = dec.make_step(shard)(tensors(reference["tree"]), whole,
                                         torch.from_numpy(reference["fed"][0]))
    np.testing.assert_allclose(logits.gather().numpy(),
                               reference["logits"][0], **TOL)
    assert cache["len"] == PROMPT + 1
    for name, leaf in placed.items():
        assert_laid_out(cache[name], leaf.sharding, mesh)
    # sequence parallelism: the reference's decode never resolves "seq" and
    # runs unchanged; the port's equals its step without the flag bit for
    # bit, on both tiny meshes, from one cache each
    for multi in MESHES:
        mesh = tiny(multi)
        got = []
        for flag in (True, False):
            _, fresh = prefill(model, toks, cfg, MAX_LEN)
            got.append(dec.make_step(Sharder.for_mesh(
                mesh, seq_parallel=flag))(model, fresh, torch.from_numpy(
                    reference["fed"][0])))
        (flagged, f_cache), (plain, p_cache) = got
        np.testing.assert_allclose(flagged.gather().numpy(),
                                   reference["logits"][0], **TOL)
        assert torch.equal(flagged.gather(), plain.gather())
        for name in reference["cache"]:
            assert torch.equal(f_cache[name].gather(), p_cache[name].gather())


# -- the cache's blocks ---------------------------------------------------------------------

def run_both(cfg, mesh, prompt, steps, max_len=MAX_LEN, batch=BATCH):
    """The port's prefill of ``prompt`` tokens and ``steps`` greedy decode
    steps, unsharded and over ``mesh`` fed the same tokens: the largest
    logit gap of any step, the sharded cache and the unsharded one."""
    model = init_lm_params(cfg, seed=2, device="cpu")
    toks = prompts(cfg, batch, prompt, seed=4)
    shard = Sharder.for_mesh(mesh)
    want, want_cache = prefill(model, toks, cfg, max_len)
    _, got_cache = prefill(model, toks, cfg, max_len, shard)
    gap = 0.0
    for _ in range(steps):
        t = want[:, :cfg.vocab_size].argmax(-1)
        want, want_cache = decode_step(model, want_cache, t, cfg)
        got, got_cache = decode_step(model, got_cache, t, cfg, shard)
        gap = max(gap, float((got.gather() - want).abs().max()))
    return gap, got_cache, want_cache


@pytest.mark.parametrize("multi", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "minicpm3-4b"])
def test_writes_at_a_blocks_last_slot_and_the_next_blocks_first(arch, multi):
    """The sequence splits into ``MAX_LEN / M`` positions a "model" column:
    a prompt one short of a block puts the first write at that block's last
    slot (the next block wholly masked) and the second at the next block's
    first slot."""
    cfg = float32(arch)
    mesh = tiny(multi)
    block = MAX_LEN // mesh.shape["model"]
    gap, got, want = run_both(cfg, mesh, block - 1, 2)
    assert gap <= 1e-4
    names = [n for n in want if n != "len"]
    for name in names:
        leaf = got[name]
        assert leaf.sharding.spec[2] == "model"
        np.testing.assert_allclose(leaf.gather().numpy(),
                                   want[name].numpy(), **TOL)
        # the two new entries, each in its block only
        for p, shard in enumerate(leaf.shards):
            seq = leaf.sharding.shard_slices(p, leaf.shape)[2]
            written = shard.abs().sum(dim=tuple(
                d for d in range(shard.dim()) if d != 2)) > 0
            top = int(written.nonzero().max()) + seq.start \
                if bool(written.any()) else None
            if seq.start == block:
                assert top == block          # only the first slot
            elif seq.start > block:
                assert top is None
            else:
                assert top == block - 1
    assert got["len"] == block + 1


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "minicpm3-4b"])
def test_the_last_slot_then_a_full_cache(arch):
    """A prompt of ``MAX_LEN - 1`` leaves one slot, the last of the last
    block (the dry-run's stand-in for ``len``); one more step refuses."""
    cfg = float32(arch)
    mesh = tiny(False)
    gap, got, _ = run_both(cfg, mesh, MAX_LEN - 1, 1, batch=2)
    assert gap <= 1e-4 and got["len"] == MAX_LEN
    model = init_lm_params(cfg, seed=2, device="cpu")
    with pytest.raises(ValueError, match="cache is full"):
        decode_step(model, got, torch.zeros(2, dtype=torch.int64), cfg,
                    Sharder.for_mesh(mesh))


@pytest.mark.parametrize("multi", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "minicpm3-4b",
                                  "phi3.5-moe-42b"])
def test_without_seq_shard_attn_cache(arch, multi):
    """The cache whole along the sequence at every "model" position: each
    position attends its own heads (the uneven split) over all of it."""
    cfg = float32(arch, seq_shard_attn_cache=False)
    gap, got, want = run_both(cfg, tiny(multi), 37, STEPS)
    assert gap <= 1e-4
    for name in (n for n in want if n != "len"):
        assert got[name].sharding.spec[2] is None
        np.testing.assert_allclose(got[name].gather().numpy(),
                                   want[name].numpy(), **TOL)


def test_cache_len_stand_in_on_meta():
    assert cache_len_of(7, 128) == 7
    assert cache_len_of(torch.tensor(9, dtype=torch.int32), 128) == 9
    assert cache_len_of(torch.empty((), dtype=torch.int32, device="meta"),
                        128) == 127
    mesh = tiny(False, "meta")
    placed = Sharder.for_mesh(mesh).named().put(
        torch.empty((), dtype=torch.int32, device="meta"))
    assert cache_len_of(placed, 32768) == 32767


# -- pmax --------------------------------------------------------------------------------

@pytest.mark.parametrize("multi,axis", [
    (False, "model"), (False, "data"), (True, ("pod", "data")),
    (True, "model"), (True, ("pod", "data", "model"))])
def test_pmax_against_a_plain_max_with_its_bytes(multi, axis):
    mesh = tiny(multi)
    groups = col.axis_groups(mesh, axis)
    rng = np.random.default_rng(7)
    pieces = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
              for _ in range(mesh.size)]
    watch = Moves()
    with observe.observing(watch):
        got = col.pmax(pieces, mesh, axis)
    want_bytes = 0
    for group in groups:
        members = [int(q) for q in group]
        top = torch.stack([pieces[q] for q in members]).amax(0)
        for p in members:
            assert torch.equal(got[p], top)
            if p != members[0]:
                want_bytes += pieces[p].nbytes + top.nbytes
    assert watch.by_kind() == ({"all-reduce": want_bytes} if want_bytes
                               else {})


# -- the MoE at one token a sequence ------------------------------------------------------

@pytest.mark.parametrize("multi,batch", [(False, 4), (False, 128), (True, 3),
                                         (True, 8)])
def test_moe_decode_step_at_one_token_a_sequence(multi, batch):
    """``moe_apply_mesh`` on ``[b_g, d]``, one token of each sequence of a
    data group (``n_tokens = B``), equals ``moe_apply`` on ``[B, d]``, the
    reference's decode dispatch: one slab, its capacity from ``B``."""
    moe = MoEConfig(n_experts=4, top_k=2, d_ff_expert=24)
    d = 16
    gen = torch.Generator().manual_seed(9)
    p = init_moe(gen, d, moe)
    x = torch.randn((batch, d), generator=gen)
    want, _ = moe_apply(type("P", (), p)(), x, moe)
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
            xs[q] = x[groups[g][0]:groups[g][1]]
            first[q] = groups[g][0]
    watch = Moves()
    with observe.observing(watch):
        ys = moe_apply_mesh(ps, xs, moe, mesh, model_axis=shard.model_axis,
                            first=first, n_tokens=batch)
    for q in range(8):
        torch.testing.assert_close(ys[q], want[first[q]:first[q] + len(xs[q])],
                                   rtol=1e-5, atol=1e-5)
    assert watch.by_kind()["all-to-all"] > 0


# -- a greedy loop -----------------------------------------------------------------------

@pytest.mark.parametrize("multi", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "minicpm3-4b",
                                  "dbrx-132b"])
def test_greedy_loop_on_a_mesh_gives_the_unsharded_tokens(arch, multi):
    """Four greedy steps, each run fed its own tokens, pick the same
    tokens over a mesh as unsharded."""
    cfg = float32(arch)
    model = init_lm_params(cfg, seed=3, device="cpu")
    toks = prompts(cfg, 2, 20, seed=5)
    shard = Sharder.for_mesh(tiny(multi))
    runs = []
    for s in (None, shard):
        last, cache = prefill(model, toks, cfg, 64, s)
        picked = []
        for _ in range(4):
            whole = last.gather() if isinstance(last, ShardedTensor) else last
            t = whole[:, :cfg.vocab_size].argmax(-1)
            picked.append(t.tolist())
            last, cache = decode_step(model, cache, t, cfg, s)
        runs.append(picked)
    assert runs[0] == runs[1]
