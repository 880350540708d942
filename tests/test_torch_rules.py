"""Rules the port keeps: no JAX and no reference package at run time, and no
silent CPU run when the caller did not ask for the CPU."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import WindowExecutor, run_sgrapp, run_sgrapp_x  # noqa: E402
from repro_torch.core.sgrapp import sgrapp_estimate  # noqa: E402
from repro_torch.configs import get_arch, list_cells  # noqa: E402
from repro_torch.data import shard_batch  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch import serve_streams  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_window_mesh  # noqa: E402
from repro_torch.launch.serve import load_model, monitor_butterflies  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    init_cache,
    init_lm_params,
    params_from_reference,
)
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    StreamingSGrapp,
    bipartite_pa_stream,
)
from repro_torch.streams.server import StreamServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_never_imports_jax_or_the_reference(path):
    bad = imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_every_module():
    names = {p.name for p in PORT_FILES}
    assert {"executor.py", "sgrapp.py", "engine.py", "butterfly_kernel.py",
            "ops.py", "build.py", "chip_smoke.py", "flash_kernel.py",
            "attention.py", "model.py", "convert.py", "serve.py",
            "registry.py", "common.py", "rope.py", "server.py", "wal.py",
            "faults.py", "checkpoint.py", "fault.py", "serve_streams.py",
            "datasets.py", "analysis.py", "distributed.py", "mesh.py",
            "sharding.py", "collectives.py", "shapes.py", "sgrapp_paper.py",
            "optimizer.py", "train_state.py", "loop.py", "pipeline.py",
            "train.py", "segment.py", "csr.py", "sampler.py", "halo.py",
            "graphsage.py", "graphcast.py", "dimenet.py", "equiformer_v2.py",
            "halo_loss.py", "embedding.py", "xdeepfm.py",
            "graphsage_reddit.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/kernels/build.py",
            "src/repro_torch/kernels/butterfly/build.py",
            "src/repro_torch/kernels/flash_attention/build.py",
            "src/repro_torch/streams/server.py",
            "src/repro_torch/streams/wal.py",
            "src/repro_torch/streams/faults.py",
            "src/repro_torch/streams/datasets.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/train/fault.py",
            "src/repro_torch/launch/serve_streams.py",
            "src/repro_torch/core/analysis.py",
            "src/repro_torch/core/distributed.py",
            "src/repro_torch/distributed/__init__.py",
            "src/repro_torch/distributed/sharding.py",
            "src/repro_torch/distributed/collectives.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/configs/shapes.py",
            "src/repro_torch/configs/sgrapp_paper.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/train_state.py",
            "src/repro_torch/train/loop.py",
            "src/repro_torch/data/pipeline.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/graphs/__init__.py",
            "src/repro_torch/graphs/segment.py",
            "src/repro_torch/graphs/csr.py",
            "src/repro_torch/graphs/sampler.py",
            "src/repro_torch/graphs/halo.py",
            "src/repro_torch/models/gnn/__init__.py",
            "src/repro_torch/models/gnn/graphsage.py",
            "src/repro_torch/models/gnn/graphcast.py",
            "src/repro_torch/models/gnn/dimenet.py",
            "src/repro_torch/models/gnn/equiformer_v2.py",
            "src/repro_torch/models/gnn/halo_loss.py",
            "src/repro_torch/models/recsys/__init__.py",
            "src/repro_torch/models/recsys/embedding.py",
            "src/repro_torch/models/recsys/xdeepfm.py",
            "src/repro_torch/configs/graphsage_reddit.py",
            "src/repro_torch/configs/graphcast.py",
            "src/repro_torch/configs/dimenet.py",
            "src/repro_torch/configs/equiformer_v2.py",
            "src/repro_torch/configs/xdeepfm.py"} <= rel
    assert imported_roots(ROOT / "tests" / "test_torch_engine.py") >= {
        "repro", "repro_torch"}


def test_cuda_sources_ship_with_the_package():
    assert list((ROOT / "src" / "repro_torch" / "kernels" / "butterfly"
                 / "csrc").glob("*.cu"))
    text = (ROOT / "pyproject.toml").read_text()
    assert "csrc/*.cu" in text and "gpu:" in text


@pytest.mark.parametrize("package", ["butterfly", "flash_attention"])
def test_each_kernel_package_ships_its_sources(package):
    assert list((ROOT / "src" / "repro_torch" / "kernels" / package
                 / "csrc").glob("*.cu"))
    text = (ROOT / "pyproject.toml").read_text()
    assert f'"repro_torch.kernels.{package}" = ["csrc/*.cu"]' in text


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def small_batch():
    s = bipartite_pa_stream(600, n_unique=200, seed=1)
    return s.windowize(20)


@pytest.mark.parametrize("entry", [
    lambda: run_sgrapp(small_batch(), 1.02, tier="pallas"),
    lambda: run_sgrapp(small_batch(), 1.02),
    lambda: run_sgrapp_x(small_batch(), 1.02, np.ones(2), tier="dense"),
    lambda: WindowExecutor("pallas"),
    lambda: WindowExecutor("numpy"),
    lambda: StreamingSGrapp(20, 1.02, config=EngineConfig(tier="pallas")),
    lambda: sgrapp_estimate(np.ones(3), np.arange(3), 1.0),
    lambda: resolve_device("cuda"),
    lambda: init_lm_params(get_arch("phi4-mini-3.8b").smoke_config()),
    lambda: init_cache(get_arch("granite-8b").smoke_config(), 1, 4),
    lambda: load_model("phi4-mini-3.8b", smoke=True),
    lambda: params_from_reference({}, get_arch("phi4-mini-3.8b").smoke_config()),
    lambda: monitor_butterflies(np.zeros((1, 2), int), np.zeros((1, 1), int)),
    lambda: StreamServer(nt_w=20, alpha0=1.0, tenants={"a": 0}),
    lambda: StreamServer(nt_w=20, alpha0=1.0, tenants={"a": 0},
                         config=EngineConfig(tier="pallas")),
    lambda: serve_streams.main(["--nt-w", "20", "--tenant", "a:0",
                                "--tier", "pallas"]),
    lambda: list_cells("sgrapp", smoke=True)["win_8k"].make_step(Sharder(None)),
    lambda: list_cells("sgrapp", smoke=True)["estimator"].make_step(
        Sharder(None)),
    lambda: shard_batch({"tokens": np.zeros((1, 2), np.int32)}),
    lambda: train_launcher.main(["--arch", "phi4-mini-3.8b", "--smoke",
                                 "--steps", "1"]),
    lambda: gnn.init_sage(get_arch("graphsage-reddit").smoke_config()),
    lambda: gnn.init_graphcast(get_arch("graphcast").smoke_config()),
    lambda: gnn.init_dimenet(get_arch("dimenet").smoke_config()),
    lambda: gnn.init_eqv2(get_arch("equiformer-v2").smoke_config()),
    lambda: recsys.init_xdeepfm(get_arch("xdeepfm").smoke_config()),
    lambda: gnn.params_from_reference({"w": np.zeros(2, np.float32)}),
    lambda: recsys.params_from_reference({"w": np.zeros(2, np.float32)}),
    lambda: train_launcher.main(["--arch", "graphsage-reddit", "--smoke",
                                 "--steps", "1"]),
    lambda: train_launcher.main(["--arch", "xdeepfm", "--smoke", "--steps",
                                 "1"]),
], ids=["run_sgrapp_pallas", "run_sgrapp_default", "run_sgrapp_x",
        "executor_pallas", "executor_numpy", "engine", "estimator",
        "resolve_cuda", "init_lm_params", "init_cache", "serve_load_model",
        "params_from_reference", "monitor_butterflies",
        "stream_server_default", "stream_server_pallas",
        "serve_streams_main", "sgrapp_win_cell", "sgrapp_estimator_cell",
        "shard_batch", "train_main", "init_sage", "init_graphcast",
        "init_dimenet", "init_eqv2", "init_xdeepfm",
        "gnn_params_from_reference", "recsys_params_from_reference",
        "train_main_gnn", "train_main_recsys"])
def test_without_a_card_entry_points_raise(no_card, entry):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


@pytest.mark.parametrize("entry", [
    lambda: make_window_mesh(),
    lambda: make_window_mesh(2),
    lambda: make_window_mesh(["cuda", "cuda"]),
    lambda: make_mesh((2, 2), ("data", "model")),
    lambda: WindowExecutor("pallas", devices=2),
    lambda: run_sgrapp(small_batch(), 1.02, tier="pallas", devices=1),
    lambda: StreamingSGrapp(20, 1.02, config=EngineConfig(tier="pallas",
                                                          devices=2)),
], ids=["window_mesh_all", "window_mesh_int", "window_mesh_cuda",
        "mesh_all", "executor_devices", "run_sgrapp_devices",
        "engine_devices"])
def test_without_a_card_meshes_raise(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_explicit_cpu_runs(no_card):
    res = run_sgrapp(small_batch(), 1.02, tier="pallas", device="cpu")
    assert np.isfinite(res.estimates).all()
    assert resolve_device("cpu").type == "cpu"
    # meta, the dry-run's placeholder, only where it is named
    assert resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="CUDA or CPU"):
        resolve_device("xpu")
