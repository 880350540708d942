"""The port's dry-run of xDeepFM's four cells (``repro_torch.launch.dryrun``)
on the tiny meshes, in this process, on ``meta`` positions at full config
and shape.

One record per cell (``train_batch``, ``serve_p99``, ``serve_bulk``,
``retrieval_cand``) on each tiny mesh, held to analytic values: status
``ok``; ``model_flops`` the registry's ``_xdfm_flops``; each position's
argument bytes its row blocks of ``table`` and ``linear`` (and of both
moments, for the train step), the replicated nets whole and its data
group's block of the ids, and the same from the reference's own specs
through ``jax.sharding``; the moves, by kind,
``models.recsys.sharded.predicted_moves``; no kernel of K1-K4.  Each
group's "model" columns repeat its rows' CIN and MLP (replicated weights,
an activation whole along "model"), so a serve or retrieval trace's
flops over the mesh are ``M`` times the cell's model flops.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.registry import _xdfm_flops  # noqa: E402
from repro_torch.configs.shapes import RECSYS_SHAPES, pad_to  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.recsys.sharded import predicted_moves  # noqa: E402
from repro_torch.models.recsys.xdeepfm import init_xdeepfm  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402

TINY = ("tiny", "tiny_multipod")
# (data groups, "model" columns) of each tiny mesh
GRID = {"tiny": (2, 4), "tiny_multipod": (4, 2)}
SHAPES = list(RECSYS_SHAPES)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_xdeepfm")
    return {(shape, mesh): dryrun.run_cell("xdeepfm", shape, mesh, str(out))
            for mesh in TINY for shape in SHAPES}


def analytic_argument_bytes(cfg, shape: str, mesh: str) -> int:
    """One position's bytes of an xDeepFM cell's inputs: its row block of
    ``table`` and ``linear`` and the nets whole, three times over for the
    train step (parameters and both float32 moments, with the int32 step
    and the uint32[2] key); its data group's block of the rows' ids (and
    clicks), retrieval's 19 user ids whole beside its candidates' 20."""
    g, m = GRID[mesh]
    rows, kind = RECSYS_SHAPES[shape]
    params = init_xdeepfm(cfg, device="meta")
    tables = sum(params[k].numel() for k in ("table", "linear"))
    nets = sum(t.numel() for t in tck.tree_flatten(params)[0]) - tables
    assert tables % m == 0
    state = (tables // m + nets) * 4
    if kind == "train":
        assert rows % g == 0
        return 3 * state + 4 + 8 + rows // g * (cfg.n_sparse + 1) * 4
    if kind == "serve":
        return state + rows // g * cfg.n_sparse * 4
    rows = pad_to(rows)
    assert rows % g == 0
    return state + 19 * 4 + rows // g * (cfg.n_sparse - 19) * 4


def reference_argument_bytes(shape: str, mesh: str) -> int:
    """Each device's bytes of the reference's xDeepFM cell's inputs on
    ``mesh``, from its own specs through ``jax.sharding``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import list_cells as j_list_cells
    from repro.distributed.sharding import Sharder as JSharder

    j_cell = j_list_cells("xdeepfm")[shape]
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
    return sum(math.prod(jax.sharding.NamedSharding(
        j_mesh, P(*shard.spec(*spec))).shard_shape(x.shape))
        * x.dtype.itemsize for x, spec in zip(leaves, specs))


@pytest.mark.parametrize("mesh", TINY)
@pytest.mark.parametrize("shape", SHAPES)
def test_dryrun_xdeepfm_cell_is_ok(records, shape, mesh):
    rec = records[(shape, mesh)]
    assert rec["status"] == "ok", rec.get("error")
    rows, kind = RECSYS_SHAPES[shape]
    assert rec["kind"] == kind and rec["n_devices"] == 8
    cfg = get_arch("xdeepfm").full_config()
    assert rec["model_flops"] == _xdfm_flops(cfg, rows, kind) > 0
    assert rec["memory"]["argument_size_bytes"] == \
        analytic_argument_bytes(cfg, shape, mesh)
    assert rec["memory"]["temp_size_bytes"] > 0
    coll = rec["collectives"]
    want = predicted_moves(cfg, shape, dryrun.make_meta_mesh(mesh))
    assert {k: v for k, v in coll.items() if k != "total"} == want
    assert coll["total"] == sum(want.values())
    assert rec["hlo"]["kernels"] == {}
    assert rec["trace_s"] > 0
    if kind == "serve":
        # the forward at every position: each group's rows once per column
        m = GRID[mesh][1]
        flops = rec["cost"]["flops"]
        assert m * rec["model_flops"] <= flops <= 1.05 * m * rec["model_flops"]


def test_dryrun_xdeepfm_agrees_with_the_reference_specs(records):
    """Each record's argument bytes equal the reference's per-device
    bytes of the same cell's inputs under its own specs."""
    for (shape, mesh), rec in records.items():
        assert rec["memory"]["argument_size_bytes"] == \
            reference_argument_bytes(shape, mesh), (shape, mesh)
