"""The dry-run's lighter train trace (``launch.dryrun.TRACED_LAYERS``)
against the trace of every layer, on the tiny meshes.

Each LM's smoke config, its depth raised to ``DEPTH`` layers, traces its
``train_4k`` step (the shape cut to ``SEQ`` x ``BATCH``, ``LM_SHAPES``
patched) twice: the first ``TRACED_LAYERS`` layers with layer
``sharded_train.SCALED_LAYER`` counted for the other two, and every layer.
Every field of the records but ``trace_s`` and the ``layers`` note is
equal: ``memory`` to the byte (the busiest position's arguments, outputs
and peak of temporaries), ``cost``, ``collectives`` by kind, and ``hlo``'s
per-device and mesh figures, K4's launches and flops and ``n_ops``
among them.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.transformer.sharded_train import SCALED_LAYER  # noqa: E402

ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
         "dbrx-132b"]
TINY = ("tiny", "tiny_multipod")
DEPTH, SEQ, BATCH = 4, 8, 16


def trace(arch: str, mesh: str, layers, out) -> dict:
    dryrun.TRACED_LAYERS = layers
    return dryrun.run_cell(arch, "train_4k", mesh, str(out), force=True)


@pytest.mark.parametrize("mesh", TINY)
@pytest.mark.parametrize("arch", ARCHS)
def test_lighter_trace_equals_the_trace_of_every_layer(arch, mesh, tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(registry.LM_SHAPES, "train_4k", (SEQ, BATCH, "train"))
    a = get_arch(arch)
    smoke = a.smoke_config
    monkeypatch.setattr(a, "full_config", lambda: dataclasses.replace(
        smoke(), n_layers=DEPTH))
    monkeypatch.setattr(dryrun, "TRACED_LAYERS", dryrun.TRACED_LAYERS)
    k = dryrun.TRACED_LAYERS
    assert SCALED_LAYER + 2 <= k < DEPTH
    light = trace(arch, mesh, k, tmp_path / "light")
    full = trace(arch, mesh, None, tmp_path / "full")
    assert light["status"] == full["status"] == "ok", light.get("error")
    assert light["layers"] == {
        "n_layers": DEPTH, "traced": k, "scaled_by": DEPTH - k + 1,
        "why": light["layers"]["why"]}
    assert "layers" not in full
    for key in ("memory", "cost", "collectives", "model_flops",
                "microbatches", "n_devices", "kind"):
        assert light[key] == full[key], key
    assert light["hlo"] == full["hlo"]
    assert set(light) - {"layers"} == set(full)
    assert light["hlo"]["kernels"]["K4"]["launches"] > 0
    assert light["memory"]["temp_size_bytes"] > 0
