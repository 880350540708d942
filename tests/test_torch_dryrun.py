"""The port's dry-run (``repro_torch.launch.dryrun``), its meshes and the
window counter over a tuple of data axes, against the JAX package.

The dry-run traces a cell's step on a mesh of ``meta`` positions at full
shape, in this process.  Its records are held to the reference's own
dry-run (run in a subprocess, as ``tests/test_launchers_distributed.py``
runs it) where both compute the same thing: ``status``, ``kind``,
``model_flops``, ``n_devices`` and each device's argument bytes.  Flops,
collective bytes and temporaries differ by design (XLA's full ring, which
also permutes after its last step, against the port's half ring; XLA's
buffer assignment against torch's allocations), so the port is held to its
own analytic values for them.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.sgrapp import window_exact_counts  # noqa: E402
from repro.streams import bipartite_pa_stream  # noqa: E402
from repro_torch.configs import get_arch, list_cells  # noqa: E402
from repro_torch.distributed import NamedSharding, Sharder  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_production_mesh,
    make_tiny_mesh,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("tiny", "tiny_multipod")
SHAPES = get_arch("sgrapp").full_config()["shapes"]
# (rows the windows split over, ring size) of each mesh
SPLIT = {"tiny": (2, 4), "tiny_multipod": (4, 2), "pod": (16, 16),
         "multipod": (32, 16)}


# -- the window counter over ("pod", "data") -------------------------------------

def fitting_windows(n_windows, cap, n_i, n_j):
    """The first ``n_windows`` windows of a seeded stream whose ids fit
    ``n_i x n_j``, as the reference windowizes them, padded to ``cap``
    lanes."""
    wb = bipartite_pa_stream(4000, temporal="uniform", n_unique=900,
                             seed=7).windowize(60)
    wb = wb.take(np.arange(n_windows))
    assert wb.n_i_per_window.max() <= n_i and wb.n_j_per_window.max() <= n_j
    assert wb.capacity <= cap
    pad = cap - wb.capacity
    lanes = [np.pad(x, ((0, 0), (0, pad)))
             for x in (wb.edge_i, wb.edge_j, wb.valid)]
    return wb, lanes


def test_win_cell_over_pod_data_model_equals_the_reference():
    """Windows split over ("pod", "data") (first axis major), each Gram
    over "model": the counts of the reference's single-device dense
    tier."""
    W, cap, n_i, n_j = get_arch("sgrapp").smoke_config()["shapes"]["win_8k"]
    wb, lanes = fitting_windows(8, cap, n_i, n_j)
    want = np.asarray(window_exact_counts(wb, tier="dense"))
    assert want.max() > 0
    mesh = make_tiny_mesh(multi_pod=True, devices=["cpu"] * 8)
    step = list_cells("sgrapp", smoke=True)["win_8k"].make_step(
        Sharder.for_mesh(mesh))
    got = step(*lanes)
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_rows_follow_the_shard_order(monkeypatch):
    """Window row d runs on the "model" line at (pod, data) =
    divmod(d, 2): the order in which ``shard_map`` splits a dim over
    ``P(("pod", "data"))``."""
    import repro_torch.core.distributed as tdist

    mesh = make_tiny_mesh(multi_pod=True, devices=["cpu"] * 8)
    seen = []
    orig = tdist.ring_pair_count

    def spy(blocks, devices, pair_fn, **kw):
        seen.append(tuple(kw["positions"]))
        return orig(blocks, devices, pair_fn, **kw)

    monkeypatch.setattr(tdist, "ring_pair_count", spy)
    fn = tdist.make_distributed_window_counter(16, 16, mesh,
                                               window_axis=("pod", "data"))
    fn(*(np.zeros((4, 8), dtype) for dtype in (np.int32, np.int32, bool)))
    # shard_map's order for P(("pod", "data")): pod major, model at 0
    heads = list(np.arange(8).reshape(2, 2, 2)[:, :, 0].ravel())
    assert [s[0] for s in seen] == heads == [0, 2, 4, 6]
    assert seen == [tuple(mesh.axis_positions("model", **{
        a: mesh.position_index(h)[a] for a in ("pod", "data")}))
        for h in heads]


# -- meshes ------------------------------------------------------------------------

@pytest.mark.parametrize("make,multi,shape,axes", [
    (make_production_mesh, False, (16, 16), ("data", "model")),
    (make_production_mesh, True, (2, 16, 16), ("pod", "data", "model")),
    (make_tiny_mesh, False, (2, 4), ("data", "model")),
    (make_tiny_mesh, True, (2, 2, 2), ("pod", "data", "model")),
])
def test_meshes_have_the_reference_shapes(make, multi, shape, axes):
    n = math.prod(shape)
    mesh = make(multi_pod=multi, devices=["meta"] * n)
    assert mesh.devices.shape == shape and mesh.axis_names == axes
    assert mesh.size == n and all(d.type == "meta" for d in mesh.devices.flat)
    with pytest.raises(ValueError, match=f"needs {n} devices"):
        make(multi_pod=multi, devices=["cpu"] * (n - 1))


@pytest.mark.parametrize("make,n_cards", [
    (make_production_mesh, 8), (make_tiny_mesh, 1), (make_tiny_mesh, 4)])
def test_default_mesh_needs_exactly_its_cards(monkeypatch, make, n_cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    with pytest.raises(ValueError, match="devices, got"):
        make()


def test_mesh_positions():
    mesh = make_tiny_mesh(multi_pod=True, devices=["cpu"] * 8)
    assert mesh.position_index(5) == {"pod": 1, "data": 0, "model": 1}
    assert mesh.axis_positions("model", pod=1, data=1) == [6, 7]
    assert mesh.axis_positions("pod", data=1, model=1) == [3, 7]


# -- NamedSharding --------------------------------------------------------------------

def test_named_sharding_shards_and_places():
    mesh = make_tiny_mesh(multi_pod=True, devices=["cpu"] * 8)
    shard = Sharder.for_mesh(mesh)
    named = shard.named("batch", None)
    assert isinstance(named, NamedSharding)
    assert named.spec == (("pod", "data"), None)
    assert named.shard_shape((8, 3)) == (2, 3)
    x = torch.arange(24).reshape(8, 3)
    parts = named.place(x)
    assert len(parts) == 8
    for p, part in enumerate(parts):
        at = mesh.position_index(p)
        k = at["pod"] * 2 + at["data"]
        assert torch.equal(part, x[2 * k:2 * k + 2])
    rep = shard.named()
    assert rep.shard_shape(()) == () and all(
        torch.equal(t, torch.tensor(1.0)) for t in rep.place(torch.tensor(1.0)))
    with pytest.raises(ValueError, match="does not divide"):
        named.shard_shape((6, 3))
    with pytest.raises(ValueError, match="more dims"):
        named.shard_shape((8,))
    assert shard.named("model").shard_shape((4,)) == (2,)


def test_cell_in_shardings_on_a_mesh():
    mesh = make_tiny_mesh(devices=["meta"] * 8)
    shard = Sharder.for_mesh(mesh)
    cell = list_cells("sgrapp")["estimator"]
    got = cell.in_shardings(shard)
    assert [s.spec for s in got] == [("data", None)] * 3 + [(None,)] * 3 + [()]
    assert cell.out_shardings(shard) is None
    # act and params on the mesh: a placed ShardedTensor, NamedShardings
    x = torch.empty((4, 3), device="meta")
    placed = shard.act(x, "batch", None)
    assert placed.sharding == got[0] and len(placed.shards) == 8
    assert all(s.shape == (2, 3) and s.device.type == "meta"
               for s in placed.shards)
    assert shard.params({"w": ("batch", None)}, {"w": x}) == {"w": got[0]}


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lm_cell_shardings_equal_the_reference_specs(multi, shape):
    """``Cell.in_shardings`` / ``out_shardings`` on a mesh resolve every
    leaf of an LM cell's trees to the reference's ``PartitionSpec``, in
    ``jax.tree``'s leaf order; nothing is placed."""
    import jax

    from repro.configs import list_cells as j_list_cells
    from repro.distributed.sharding import Sharder as JSharder
    from repro_torch.train.checkpoint import tree_flatten

    axes = ("pod", "data", "model") if multi else ("data", "model")
    grid = (2, 2, 2) if multi else (2, 4)
    j_mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1] * 8, dtype=object).reshape(grid), axes)
    mesh = make_tiny_mesh(multi_pod=multi, devices=["meta"] * 8)
    got_cell = list_cells("phi4-mini-3.8b", smoke=True)[shape]
    want_cell = j_list_cells("phi4-mini-3.8b", smoke=True)[shape]
    for which in ("in_shardings", "out_shardings"):
        got = getattr(got_cell, which)(Sharder.for_mesh(mesh))
        want = getattr(want_cell, which)(JSharder.for_mesh(j_mesh))
        if want is None:
            assert got is None
            continue
        got_leaves, _ = tree_flatten(got)
        want_leaves = jax.tree.leaves(want)
        assert len(got_leaves) == len(want_leaves) > 0
        for g, w in zip(got_leaves, want_leaves):
            assert isinstance(g, NamedSharding) and g.mesh is mesh
            assert g.spec == tuple(w.spec)


# -- the dry-run, in process, on meta at full shape ----------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    return {(shape, mesh): dryrun.run_cell("sgrapp", shape, mesh, str(out))
            for mesh in TINY for shape in ("win_8k", "estimator")}


def half_ring(mesh_kind):
    """Analytic figures of ``win_8k``'s half ring on ``mesh_kind``."""
    W, cap, n_i, n_j = SHAPES["win_8k"]
    rows, n = SPLIT[mesh_kind]
    br = n_i // n
    pair = 2 * br * br * n_j
    per = W // rows
    steps = n // 2 + 1
    return {
        "flops": W * n * (n + 1) // 2 * pair,
        "busiest_flops": per * steps * pair,
        "permute": W * (steps - 1) * n * br * n_j,
        "busiest_permute": per * (steps - 1) * br * n_j,
        "all_reduce": W * (n - 1) * 4,
        "all_gather": (W - per) * 4,
        "arguments": per * cap * (4 + 4 + 1),
        # what a position must hold at once in a pair: its float32 block
        # (and the scatter's spare slot), its int8 wire copy, the float32
        # copy of the block it holds, and the Gram tile
        "temp_low": br * n_j * 4 + 4 + br * n_j + br * n_j * 4 + br * br * 4,
        # and the tile's elementwise temporaries, the diagonal mask and the
        # lanes' int64 copies
        "temp_high_extra": 3 * br * br * 4 + br * br + 16 * cap * 8,
    }


@pytest.mark.parametrize("mesh", TINY)
def test_dryrun_win_8k_is_the_half_ring(records, mesh):
    rec = records[("win_8k", mesh)]
    want = half_ring(mesh)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == 8 and rec["kind"] == "stream"
    assert rec["cost"]["flops"] == want["flops"]
    assert rec["collectives"] == {
        "all-gather": want["all_gather"], "all-reduce": want["all_reduce"],
        "collective-permute": want["permute"],
        "total": want["all_gather"] + want["all_reduce"] + want["permute"]}
    hlo = rec["hlo"]
    assert hlo["busiest_position"] == 0 and hlo["positions"] == 8
    assert hlo["flops"] == want["busiest_flops"]
    assert hlo["collectives"]["collective-permute"] == want["busiest_permute"]
    assert hlo["collectives"]["total"] > 0
    assert hlo["mesh"]["flops"] == want["flops"]
    mem = rec["memory"]
    assert mem["argument_size_bytes"] == want["arguments"]
    assert mem["generated_code_size_bytes"] is None
    assert want["temp_low"] <= mem["temp_size_bytes"] <= (
        want["temp_low"] + want["temp_high_extra"]), mem
    assert rec["trace_s"] > 0


@pytest.mark.parametrize("mesh", TINY)
def test_dryrun_estimator_counts_k1_on_the_first_position(records, mesh):
    rec = records[("estimator", mesh)]
    W, cap, n_i, n_j = SHAPES["estimator"]
    rows, _ = SPLIT[mesh]
    assert rec["status"] == "ok", rec.get("error")
    k1 = 2 * W * n_i * (n_i - 1) // 2 * n_j
    assert rec["cost"]["flops"] == k1 == rec["hlo"]["flops"]
    assert rec["hlo"]["kernels"] == {"K1": {"launches": 4, "flops": k1}}
    assert rec["collectives"] == {"total": 0}
    mem = rec["memory"]
    assert mem["position"] == 0
    assert mem["argument_size_bytes"] == (W // rows * cap * 9 + W * 9 + 4)
    assert mem["output_size_bytes"] == W * 4 + 4
    # the 128-window uint8 stack K1 reads, and under 5 GiB in all
    assert 128 * n_i * n_j <= mem["temp_size_bytes"] < 5 * 2**30


def test_k1_on_meta_launches_nothing():
    from repro_torch.kernels.butterfly import butterfly_kernel as kk
    from repro_torch.kernels.butterfly.ops import (
        butterfly_count_pallas_windows,
        oriented_biadjacency,
    )

    kk.reset_launch_count()
    lanes = [torch.empty((3, 64), dtype=d, device="meta")
             for d in (torch.int32, torch.int32, torch.bool)]
    adj = oriented_biadjacency(*lanes, 40, 24)
    assert adj.device.type == "meta" and adj.shape == (3, 24, 40)
    assert adj.dtype == torch.uint8
    got = butterfly_count_pallas_windows(adj)
    assert got.device.type == "meta" and got.shape == (3,)
    assert got.dtype == torch.float32
    assert kk.launch_count("K1") == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kk.butterfly_pairs_kernel_call(adj[0], block_i=8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kk.butterfly_pairs_windows_kernel_multiset_call(
            adj.to(torch.float32), block_i=8)


# -- the LMs' prefill cells ------------------------------------------------------------------

LM_ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
            "dbrx-132b"]


@pytest.fixture(scope="module")
def lm_records(tmp_path_factory):
    """The five LMs' ``prefill_32k`` records at full config on both tiny
    meshes, and K4's launches over all ten traces."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    out = tmp_path_factory.mktemp("dryrun_lm")
    k4.reset_launch_count()
    recs = {(arch, mesh): dryrun.run_cell(arch, "prefill_32k", mesh, str(out))
            for mesh in TINY for arch in LM_ARCHS}
    return recs, k4.launch_count()


@pytest.mark.parametrize("mesh", TINY)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_dryrun_lm_prefill_is_ok_with_k4_on_each_position(lm_records, arch,
                                                          mesh):
    """Each record is ``ok``; K4 runs once a layer at every position (each
    holds heads on the tiny meshes) through ``note_kernel``, its flops the
    causal QK^T and PV of every sequence and head once; the FSDP gathers
    and the row-parallel sums move bytes, and an MoE's buffers too."""
    recs, launches = lm_records
    rec = recs[(arch, mesh)]
    assert launches == 0
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kind"] == "prefill" and rec["n_devices"] == 8
    cfg = get_arch(arch).full_config()
    b, s = get_arch(arch).cells(cfg)["prefill_32k"].abstract_inputs()[1].shape
    hd, hd_v = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                 cfg.mla.v_head_dim) if cfg.is_mla
                else (cfg.head_dim, cfg.head_dim))
    k4 = cfg.n_layers * b * cfg.n_heads * s * (s + 1) // 2 * 2 * (hd + hd_v)
    assert rec["hlo"]["kernels"] == {
        "K4": {"launches": 8 * cfg.n_layers, "flops": k4}}
    assert rec["cost"]["flops"] > k4
    coll = rec["collectives"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert ("all-to-all" in coll) == (cfg.moe is not None)
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    mem = rec["memory"]
    assert mem["argument_size_bytes"] > 0 and mem["output_size_bytes"] > 0
    assert rec["trace_s"] > 0


def test_k4_on_meta_launches_nothing():
    from repro_torch.distributed import observe
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    class Kernels:
        def __init__(self):
            self.seen = []

        def move(self, *a):
            pass

        def kernel(self, name, flops, nbytes):
            self.seen.append((name, flops, nbytes))

    k4.reset_launch_count()
    q = torch.empty((2, 40, 3, 96), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 40, 1, 96), dtype=torch.bfloat16, device="meta")
    v = torch.empty((2, 40, 1, 64), dtype=torch.bfloat16, device="meta")
    with observe.observing(Kernels()) as watch:
        out = k4.flash_attention_bshd(q, k, v, causal=True, q_offset=0)
    assert out.device.type == "meta" and out.shape == (2, 40, 3, 64)
    assert out.dtype == torch.bfloat16 and k4.launch_count() == 0
    pairs = 2 * 3 * 40 * 41 // 2
    assert watch.seen == [("K4", 2.0 * pairs * (96 + 64),
                           q.nbytes + k.nbytes + v.nbytes + out.nbytes)]


def reference_argument_bytes(shape: str, mesh: str) -> tuple:
    """``(cell, bytes)``: the reference's phi4-mini-3.8b cell ``shape`` and
    each device's bytes of its inputs on ``mesh``, from its own
    ``lm_param_specs`` and input specs through ``jax.sharding`` (its
    compile of the full 32-layer, 32k-token step is not run here)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import list_cells as j_list_cells
    from repro.distributed.sharding import Sharder as JSharder

    j_cell = j_list_cells("phi4-mini-3.8b")[shape]
    multi = mesh == "tiny_multipod"
    axes = ("pod", "data", "model") if multi else ("data", "model")
    grid = (2, 2, 2) if multi else (2, 4)
    j_mesh = jax.sharding.Mesh(
        np.array(jax.devices()[:1] * 8, dtype=object).reshape(grid), axes)
    shard = JSharder.for_mesh(j_mesh)
    leaves = jax.tree.leaves(j_cell.abstract_inputs())
    specs = jax.tree.leaves(
        j_cell.logical_specs(), is_leaf=lambda x: isinstance(x, tuple)
        and all(a is None or isinstance(a, str) for a in x))
    assert len(leaves) == len(specs)
    return j_cell, sum(
        math.prod(jax.sharding.NamedSharding(
            j_mesh, P(*shard.spec(*spec))).shard_shape(x.shape))
        * x.dtype.itemsize for x, spec in zip(leaves, specs))


def test_dryrun_phi4_prefill_agrees_with_the_reference_specs(lm_records):
    """phi4-mini-3.8b's record against what the reference's dry-run
    records: ``status``, ``kind``, ``model_flops`` and ``n_devices`` from
    its registry, and each device's argument bytes
    (:func:`reference_argument_bytes`)."""
    recs, _ = lm_records
    for mesh in TINY:
        got = recs[("phi4-mini-3.8b", mesh)]
        j_cell, per_device = reference_argument_bytes("prefill_32k", mesh)
        assert got["status"] == "ok" and got["kind"] == j_cell.kind
        assert got["model_flops"] == j_cell.model_flops
        assert got["n_devices"] == 8
        assert got["memory"]["argument_size_bytes"] == per_device


# -- the LMs' decode cells ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_decode_records(tmp_path_factory):
    """The five LMs' ``decode_32k`` records at full config on both tiny
    meshes, and K4's launches over all ten traces."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    out = tmp_path_factory.mktemp("dryrun_decode")
    k4.reset_launch_count()
    recs = {(arch, mesh): dryrun.run_cell(arch, "decode_32k", mesh, str(out))
            for mesh in TINY for arch in LM_ARCHS}
    return recs, k4.launch_count()


@pytest.mark.parametrize("mesh", TINY)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_dryrun_lm_decode_is_ok_with_the_len_stand_in(lm_decode_records,
                                                      arch, mesh):
    """Each record is ``ok`` with the analytic ``2 N B`` flops; the trace
    took ``len``'s stand-in, the last slot, and says so; no K4 (decode
    attention is plain torch); the matmuls count at least ``2 N B`` (the
    attention over the cache adds its own); the FSDP gathers and the
    row-parallel and softmax sums move bytes, an MoE's buffers too; a
    position holds its blocks of the cache and the parameters."""
    recs, launches = lm_decode_records
    rec = recs[(arch, mesh)]
    assert launches == 0
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kind"] == "decode" and rec["n_devices"] == 8
    cfg = get_arch(arch).full_config()
    cell = get_arch(arch).cells(cfg)["decode_32k"]
    _, cache, toks = cell.abstract_inputs()
    b, s = toks.shape[0], cache["ckv" if cfg.is_mla else "k"].shape[2]
    assert rec["model_flops"] == cell.model_flops == \
        2.0 * cfg.active_param_count() * b
    assert rec["cache_len"]["stand_in"] == s - 1
    assert rec["hlo"]["kernels"] == {}
    assert rec["cost"]["flops"] > rec["model_flops"] - 2.0 * b * \
        cfg.padded_vocab * cfg.d_model
    coll = rec["collectives"]
    assert coll["all-gather"] > 0 and coll["all-reduce"] > 0
    assert ("all-to-all" in coll) == (cfg.moe is not None)
    cache_bytes = sum(math.prod(x.shape) * x.dtype.itemsize
                      for x in cache.values())
    mem = rec["memory"]
    assert mem["argument_size_bytes"] > cache_bytes / 8
    assert mem["output_size_bytes"] > 0 and rec["trace_s"] > 0


def test_dryrun_phi4_decode_agrees_with_the_reference_specs(
        lm_decode_records):
    """phi4-mini-3.8b's ``decode_32k`` record against the reference's:
    ``status``, ``kind``, ``model_flops``, ``n_devices`` and each device's
    argument bytes, the cache's block among them
    (:func:`reference_argument_bytes`)."""
    recs, _ = lm_decode_records
    for mesh in TINY:
        got = recs[("phi4-mini-3.8b", mesh)]
        j_cell, per_device = reference_argument_bytes("decode_32k", mesh)
        assert got["status"] == "ok" and got["kind"] == j_cell.kind
        assert got["model_flops"] == j_cell.model_flops
        assert got["n_devices"] == 8
        assert got["memory"]["argument_size_bytes"] == per_device


# -- against the reference's record ----------------------------------------------------------

def reference_dryrun(tmp_path_factory, shape: str, mesh: str) -> dict:
    """The reference's own dry-run of ``sgrapp/<shape>`` on ``mesh``, run
    as ``tests/test_launchers_distributed.py`` runs it."""
    out = tmp_path_factory.mktemp(f"ref_{shape}_{mesh}")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--arch", "sgrapp",
         "--shape", shape, "--mesh", mesh, "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    with open(out / mesh / f"sgrapp__{shape}.json") as f:
        return json.load(f)


@pytest.fixture(scope="module", params=TINY)
def reference_record(request, tmp_path_factory):
    """The reference's own dry-run of ``sgrapp/win_8k``."""
    return request.param, reference_dryrun(tmp_path_factory, "win_8k",
                                           request.param)


@pytest.mark.parametrize("mesh", TINY)
def test_dryrun_estimator_agrees_with_the_reference_record(
        records, tmp_path_factory, mesh):
    """The estimator's record against the reference's: ``status``,
    ``kind``, ``model_flops``, ``n_devices`` and the argument bytes agree.
    The rest differs by design: the reference's jit does not split the
    scan over the data axes but all-gathers the windows' lanes to every
    device (an all-gather of the W x cap x 9 lane bytes) and runs the whole
    scan on each (per-device flops 2 W n_i^2 n_j), where the port counts
    once, on the first position, and gathers nothing."""
    want = reference_dryrun(tmp_path_factory, "estimator", mesh)
    got = records[("estimator", mesh)]
    for key in ("status", "kind", "model_flops", "n_devices"):
        assert got[key] == want[key], key
    assert got["memory"]["argument_size_bytes"] == \
        want["memory"]["argument_size_bytes"]
    W, cap, n_i, n_j = SHAPES["estimator"]
    assert want["hlo"]["collectives"] == {"all-gather": W * cap * 9,
                                          "total": W * cap * 9}
    assert want["hlo"]["flops"] == 2 * W * n_i * n_i * n_j
    assert got["collectives"] == {"total": 0}
    assert got["hlo"]["busiest_position"] == 0


def test_dryrun_agrees_with_the_reference_record(records, reference_record):
    mesh, want = reference_record
    got = records[("win_8k", mesh)]
    for key in ("status", "kind", "model_flops", "n_devices"):
        assert got[key] == want[key], key
    assert got["memory"]["argument_size_bytes"] == \
        want["memory"]["argument_size_bytes"]
    assert want["hlo"]["collectives"]["total"] > 0
    assert got["hlo"]["collectives"]["total"] > 0


# -- the launcher --------------------------------------------------------------------------

def test_launcher_records_other_families_as_errors(tmp_path, monkeypatch):
    """A cell whose step raises is recorded as an error with its message,
    and the launcher then exits 1 (here ``serve_p99`` patched to raise).
    No family's cell raises any more: xDeepFM's ``train_batch`` and
    ``serve_p99`` are ``ok`` (all four cells:
    ``tests/test_torch_dryrun_xdeepfm.py``), as the LMs' and the GNNs'
    train cells are (``tests/test_torch_dryrun_train.py``,
    ``tests/test_torch_dryrun_gnn.py``)."""
    import dataclasses

    from repro_torch.configs import ARCHS

    for arch, shape in (("xdeepfm", "train_batch"),
                        ("xdeepfm", "serve_p99")):
        rec = dryrun.run_cell(arch, shape, "tiny", str(tmp_path))
        assert rec["status"] == "ok", rec.get("error")
    assert dryrun.run_cell("phi4-mini-3.8b", "long_500k", "tiny",
                           str(tmp_path))["status"] == "skipped"

    def refuse(shard):
        raise NotImplementedError("this step is not ported (a stand-in)")
    cells = ARCHS["xdeepfm"].cells
    monkeypatch.setattr(ARCHS["xdeepfm"], "cells", lambda cfg: {
        **cells(cfg), "serve_p99": dataclasses.replace(
            cells(cfg)["serve_p99"], make_step=refuse)})
    rec = dryrun.run_cell("xdeepfm", "serve_p99", "tiny_multipod",
                          str(tmp_path))
    assert rec["status"] == "error"
    assert "not ported (a stand-in)" in rec["error"]
    with open(tmp_path / "tiny_multipod" / "xdeepfm__serve_p99.json") as f:
        assert json.load(f)["status"] == "error"
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "xdeepfm", "--shape", "serve_p99", "--mesh",
                     "tiny_multipod", "--out", str(tmp_path)])
    assert e.value.code == 1


def test_launcher_writes_and_reuses_records(tmp_path, capsys):
    dryrun.main(["--arch", "sgrapp", "--shape", "win_8k", "--mesh", "tiny",
                 "--out", str(tmp_path)])
    path = tmp_path / "tiny" / "sgrapp__win_8k.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "tiny"
    out = capsys.readouterr().out
    assert "memory_analysis" in out and "1 ok, 0 skipped, 0 failed" in out
    path.write_text(json.dumps({**rec, "marker": 1}))
    assert dryrun.run_cell("sgrapp", "win_8k", "tiny", str(tmp_path))["marker"] == 1
    assert "marker" not in dryrun.run_cell("sgrapp", "win_8k", "tiny",
                                           str(tmp_path), force=True)


def test_dryrun_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.launch.dryrun, repro_torch.launch.hlo_cost\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    for name in ("dryrun.py", "hlo_cost.py"):
        text = open(os.path.join(REPO, "src", "repro_torch", "launch",
                                 name)).read()
        assert "XLA_FLAGS" not in text
