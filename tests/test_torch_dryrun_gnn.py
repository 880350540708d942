"""The port's dry-run of the GNNs' train cells (``repro_torch.launch.dryrun``)
on the tiny meshes, in this process, on ``meta`` positions at full config
and shape.

One record per arch (``minibatch_lg``, the cell ``chip_smoke.py`` runs on
the card) on each tiny mesh, held to analytic values: status ``ok``;
``model_flops`` the registry's ``_gnn_flops``; each position's argument
bytes the replicated state (parameters, both float32 moments, the step
and the key) whole and every batch array's ``"flat"`` block, and the same
from the reference's own specs through ``jax.sharding``; the moves, by
kind, ``models.gnn.sharded.predicted_moves``; the busiest position's flops
within 10% of the mesh's over 8 (the blocks divide evenly at ``pad_to``
sizes, and the backward's work counts where its forward ran).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.registry import ShapeDtype  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.gnn.sharded import predicted_moves  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402

TINY = ("tiny", "tiny_multipod")
ARCHS = ["graphsage-reddit", "graphcast", "dimenet", "equiformer-v2"]
SHAPE = "minibatch_lg"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_gnn")
    return {(arch, mesh): dryrun.run_cell(arch, SHAPE, mesh, str(out))
            for mesh in TINY for arch in ARCHS}


def analytic_argument_bytes(cell, n_positions: int) -> int:
    """One position's bytes of a GNN cell's inputs: the state whole, each
    batch array's block of ``rows / n_positions`` rows (DimeNet's
    per-graph target whole)."""
    state, batch = cell.abstract_inputs()
    _, specs = cell.logical_specs()
    size = lambda s: math.prod(s.shape) * torch.empty(  # noqa: E731
        (), dtype=s.dtype).element_size()
    total = sum(size(s) for s in tck.tree_flatten(state)[0])
    for key, s in batch.items():
        split = specs[key] and specs[key][0] == "flat"
        assert not split or s.shape[0] % n_positions == 0
        total += size(s) // n_positions if split else size(s)
    return total


def reference_argument_bytes(arch: str, mesh: str) -> int:
    """Each device's bytes of the reference's GNN cell's inputs on
    ``mesh``, from its own specs through ``jax.sharding``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import list_cells as j_list_cells
    from repro.distributed.sharding import Sharder as JSharder

    j_cell = j_list_cells(arch)[SHAPE]
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
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_gnn_train_is_ok(records, arch, mesh):
    rec = records[(arch, mesh)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kind"] == "train" and rec["n_devices"] == 8
    cfg = get_arch(arch).full_config()
    cell = get_arch(arch).cells(cfg)[SHAPE]
    assert rec["model_flops"] == cell.model_flops > 0
    assert rec["memory"]["argument_size_bytes"] == \
        analytic_argument_bytes(cell, 8)
    assert rec["memory"]["temp_size_bytes"] > 0
    coll = rec["collectives"]
    want = predicted_moves(arch, cell.config, SHAPE,
                           dryrun.make_meta_mesh(mesh))
    assert {k: v for k, v in coll.items() if k != "total"} == want
    assert coll["total"] == sum(want.values())
    assert rec["cost"]["flops"] > 0
    assert rec["hlo"]["flops"] <= 1.1 * rec["hlo"]["mesh"]["flops"] / 8
    assert rec["hlo"]["kernels"] == {}
    assert rec["trace_s"] > 0


def test_dryrun_gnn_agrees_with_the_reference_specs(records):
    """Each record's argument bytes equal the reference's per-device
    bytes of the same cell's inputs under its own specs."""
    for (arch, mesh), rec in records.items():
        assert rec["memory"]["argument_size_bytes"] == \
            reference_argument_bytes(arch, mesh), (arch, mesh)


def test_abstract_batch_is_shape_records():
    """The GNN cells' abstract batches allocate nothing."""
    cell = get_arch("dimenet").cells(get_arch("dimenet").full_config())[
        "molecule"]
    batch = cell.abstract_inputs()[1]
    assert all(isinstance(s, ShapeDtype) for s in batch.values())
    assert cell.logical_specs()[1]["target"] == (None, None)
