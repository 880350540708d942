"""The port's dry-run of the LMs' ``train_4k`` cells
(``repro_torch.launch.dryrun``) on the tiny meshes, in this process, on
``meta`` positions at full config and shape.

The trace runs the first of the step's 8 microbatches and the optimizer and
scales the microbatch's work by 8 (``train.loop.traced_microbatches``,
``hlo_cost.CostModel.scale``); ``test_one_microbatch_scaled_equals_the_full
_trace`` holds that scaling to a trace of every microbatch.  It runs the
first ``dryrun.TRACED_LAYERS`` layers of the trunk and counts a middle one
for the rest (``train.loop.traced_layers``, ``CostModel.repeat``), which
``tests/test_torch_dryrun_light.py`` holds to a trace of every layer.  Each record is
held to analytic values: ``model_flops = 6 N T``; the traced matmuls
between ``6 N T`` and the remat's ``8 N T`` plus the attention's
backward (an MoE's experts counted at their capacity); K4's launches and flops (the forward and the recompute at each
position); the all-gather and reduce-scatter bytes the specs imply
(``sharded_train.predicted_gathers``); the busiest position's flops
within 10% of the mesh's over 8 (the backward's work counts where its
forward ran); phi4-mini-3.8b's argument bytes against the reference's
specs.  The MLA and MoE archs' records are in
``tests/test_torch_dryrun_train_mla_moe.py`` and
``tests/test_torch_dryrun_train_dbrx.py`` (files of their own, so that
``--dist loadfile`` runs them beside these).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.kernels.flash_attention import flash_kernel as k4  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.transformer.sharded_train import (  # noqa: E402
    predicted_gathers,
)

TINY = ("tiny", "tiny_multipod")
ARCHS = ["phi4-mini-3.8b", "granite-8b"]


def train_records(tmp_path_factory, archs) -> tuple[dict, int]:
    """``train_4k``'s records of ``archs`` on both tiny meshes, and K4's
    launches over all their traces."""
    out = tmp_path_factory.mktemp("dryrun_train")
    k4.reset_launch_count()
    recs = {(arch, mesh): dryrun.run_cell(arch, "train_4k", mesh, str(out))
            for mesh in TINY for arch in archs}
    return recs, k4.launch_count()


def check_train_record(rec: dict, arch: str, mesh: str) -> None:
    """One record against its analytic values (see the module
    docstring)."""
    assert rec["status"] == "ok", rec.get("error")
    assert rec["kind"] == "train" and rec["n_devices"] == 8
    cfg = get_arch(arch).full_config()
    cell = get_arch(arch).cells(cfg)["train_4k"]
    b, s = cell.abstract_inputs()[1]["tokens"].shape
    n = cfg.active_param_count()
    assert rec["model_flops"] == cell.model_flops == 6.0 * n * b * s
    nm = rec["microbatches"]["n_microbatches"]
    assert nm == 8 and rec["microbatches"]["traced"] == 1
    layers = rec["layers"]
    assert layers["n_layers"] == cfg.n_layers
    assert layers["traced"] == dryrun.TRACED_LAYERS < cfg.n_layers
    assert layers["scaled_by"] == cfg.n_layers - layers["traced"] + 1
    hd, hd_v = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
                 cfg.mla.v_head_dim) if cfg.is_mla
                else (cfg.head_dim, cfg.head_dim))
    # the forward and the recompute of every layer at every position (each
    # holds heads and rows on the tiny meshes)
    k4_flops = 2 * cfg.n_layers * b * cfg.n_heads * s * (s + 1) // 2 * 2 \
        * (hd + hd_v)
    assert rec["hlo"]["kernels"] == {
        "K4": {"launches": 2 * cfg.n_layers * 8 * nm, "flops": k4_flops}}
    matmuls = rec["cost"]["flops"] - k4_flops
    # an MoE's experts run on every slot of their capacity: capacity_factor
    # times the active experts' work
    extra = 0 if cfg.moe is None else (cfg.moe.capacity_factor - 1) \
        * cfg.moe.top_k * 3 * cfg.d_model * cfg.moe.d_ff_expert * cfg.n_layers
    # the attention's backward: five products over each query chunk's
    # causal prefix, at most 2.5 times K4's two passes
    assert 6.0 * n * b * s <= matmuls <= 8.0 * (n + extra) * b * s \
        + 2.5 * k4_flops
    assert rec["hlo"]["flops"] <= 1.1 * rec["hlo"]["mesh"]["flops"] / 8
    want = predicted_gathers(cfg, dryrun.make_meta_mesh(mesh), b, s, nm)
    coll = rec["collectives"]
    assert {k: coll[k] for k in want} == want
    assert coll["all-reduce"] > 0
    assert ("all-to-all" in coll) == (cfg.moe is not None)
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    mem = rec["memory"]
    assert mem["argument_size_bytes"] > 0 and mem["temp_size_bytes"] > 0
    assert rec["trace_s"] > 0


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return train_records(tmp_path_factory, ARCHS)


@pytest.mark.parametrize("mesh", TINY)
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_lm_train_is_ok(records, arch, mesh):
    recs, launches = records
    assert launches == 0
    check_train_record(recs[(arch, mesh)], arch, mesh)


def test_dryrun_phi4_train_agrees_with_the_reference_specs(records):
    """phi4-mini-3.8b's records against the reference's registry:
    ``kind``, ``model_flops`` and each device's argument bytes (the
    state of ``_lm_state_specs`` and the batch)."""
    from test_torch_dryrun import reference_argument_bytes

    recs, _ = records
    for mesh in TINY:
        got = recs[("phi4-mini-3.8b", mesh)]
        j_cell, per_device = reference_argument_bytes("train_4k", mesh)
        assert got["status"] == "ok" and got["kind"] == j_cell.kind
        assert got["model_flops"] == j_cell.model_flops
        assert got["memory"]["argument_size_bytes"] == per_device


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi3.5-moe-42b"])
def test_one_microbatch_scaled_equals_the_full_trace(arch, tmp_path,
                                                     monkeypatch):
    """The smoke config's step on a cut shape (``full_config`` and
    ``LM_SHAPES`` patched): the first microbatch traced and scaled by 8
    gives the flops, bytes, every collective kind (the mesh's and the
    busiest position's) and K4's launches and flops of a trace of all 8
    (``TRACED_MICROBATCHES`` patched)."""
    monkeypatch.setitem(registry.LM_SHAPES, "train_4k", (128, 16, "train"))
    a = get_arch(arch)
    monkeypatch.setattr(a, "full_config", a.smoke_config)
    one = dryrun.run_cell(arch, "train_4k", "tiny", str(tmp_path / "one"))
    monkeypatch.setattr(dryrun, "TRACED_MICROBATCHES", 8)
    full = dryrun.run_cell(arch, "train_4k", "tiny", str(tmp_path / "all"))
    assert one["status"] == full["status"] == "ok", one.get("error")
    assert one["microbatches"]["traced"] == 1
    assert full["microbatches"]["traced"] == 8
    for key in ("cost", "collectives", "model_flops"):
        assert one[key] == full[key], key
    for key in ("flops", "bytes", "collectives", "kernels", "n_ops",
                "busiest_position"):
        assert one["hlo"][key] == full["hlo"][key], key
    assert one["collectives"]["reduce-scatter"] > 0
