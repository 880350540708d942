"""Gradient compression and the elastic restore on the card (marked
``gpu``).

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_collectives.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture.  One card holds all 8 positions of a tiny mesh as
``[cuda:0] * 8``.  The mean's float32 operations (IEEE division and
products, sums in group order) are exact on both devices, so the card's
results equal the CPU's bit for bit for every method.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import NamedSharding  # noqa: E402
from repro_torch.distributed.collectives import psum_mean_compressed  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_tiny_mesh  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test holds the card's results "
                    "to the CPU's")
    return torch.device("cuda", 0)


def trees(seed: int, device) -> list:
    rng = np.random.default_rng(seed)
    return [{"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
                np.float32) * 2.0 ** rng.integers(-6, 6)).to(device),
             "b": torch.from_numpy(rng.standard_normal(96).astype(
                 np.float32)).to(torch.bfloat16).to(device)}
            for _ in range(8)]


@pytest.mark.parametrize("method", [None, "bf16", "int8"], ids=str)
@pytest.mark.parametrize("multi,axis", [(False, "data"), (False, "model"),
                                        (True, ("pod", "data"))], ids=str)
def test_psum_mean_compressed_on_the_card_equals_the_cpu(cuda, multi, axis,
                                                         method):
    cpu_mesh = make_tiny_mesh(multi_pod=multi, devices=["cpu"] * 8)
    card_mesh = make_tiny_mesh(multi_pod=multi, devices=[cuda] * 8)
    want = psum_mean_compressed(trees(3, "cpu"), cpu_mesh, axis, method)
    got = psum_mean_compressed(trees(3, cuda), card_mesh, axis, method)
    for g, w in zip(got, want):
        for k in w:
            assert g[k].device.type == "cuda" and g[k].dtype == torch.float32
            assert torch.equal(g[k].cpu(), w[k]), (k, method)


def test_elastic_restore_onto_card_positions(cuda, tmp_path):
    """Saved from (2, 4) card positions, restored onto the transposed
    (4, 2) ones: every shard on the card and value-exact."""
    mesh_a = make_mesh((2, 4), ("data", "model"), [cuda] * 8)
    mesh_b = make_mesh((4, 2), ("data", "model"), [cuda] * 8)
    p = trees(4, cuda)[0]
    saved = {"w": NamedSharding(mesh_a, ("model", None)).put(p["w"]),
             "b": NamedSharding(mesh_a, (("data", "model"),)).put(p["b"])}
    tck.save_checkpoint(str(tmp_path), 1, saved)
    layout = {"w": NamedSharding(mesh_b, (None, "data")),
              "b": NamedSharding(mesh_b, ("model",))}
    restored, _ = tck.restore_checkpoint(str(tmp_path), p, shardings=layout)
    for k in p:
        for q, shard in enumerate(restored[k].shards):
            assert shard.device.type == "cuda"
            assert torch.equal(
                shard, p[k][layout[k].shard_slices(q, p[k].shape)])
        assert torch.equal(restored[k].gather(cuda), p[k])
