"""LM training over a mesh on the card (marked ``gpu``).

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_mesh_train.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture.  One card holds all 8 positions of a tiny mesh as
``[cuda:0] * 8``.  phi4-mini-3.8b at full width cut to ``LAYERS`` layers
trains ``STEPS`` steps of the ``train_4k`` cell over (2, 4) on one repeated
batch of ``BATCH`` x ``SEQ`` in 2 microbatches, against the unsharded
port's step from the same weights on the same card: in bf16 the loss and
gradient norm within ``NORMWISE`` relative (``chip_smoke.py``'s
``MESH_TRAIN_NORMWISE``: each run lies within bf16's rounding of the
float32 function) and the loss falling, K4 launched on ``wgmma`` once a
layer, twice a microbatch (forward and recompute) at each position that
holds heads and rows; in float32 (K4's SIMT variant) within rtol 1e-4.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, registry  # noqa: E402
from repro_torch.data import token_batches  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.distributed.sharding import put_tree  # noqa: E402
from repro_torch.kernels.flash_attention import flash_kernel as k4  # noqa: E402
from repro_torch.launch.mesh import make_tiny_mesh  # noqa: E402
from repro_torch.models.transformer import init_lm_params  # noqa: E402
from repro_torch.models.transformer.sharded import _trees  # noqa: E402
from repro_torch.train import AdamWState, TrainState, adamw_init  # noqa: E402
from repro_torch.train.checkpoint import tree_map  # noqa: E402

pytestmark = pytest.mark.gpu

LAYERS, BATCH, SEQ, STEPS, MICRO = 2, 2, 1024, 3, 2
NORMWISE = 4e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test runs the mesh positions "
                    "on the card")
    return torch.device("cuda", 0)


def sharded_state(cfg, model, shard, cell):
    """``model``'s weights as the reference's tree placed by the cell's
    ``in_shardings``, with zero moments and step 0."""
    top, layers = _trees(model, cfg)

    def stack(*ts):
        if isinstance(ts[0], dict):
            return {k: stack(*(t[k] for t in ts)) for k in ts[0]}
        return torch.stack([t.detach() for t in ts])
    tree = {**{k: v.detach().clone() for k, v in top.items()},
            "layers": stack(*layers)}

    def zeros():
        return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), tree)
    step = torch.zeros((), dtype=torch.int32, device=tree["ln_f"].device)
    return put_tree(TrainState(tree, AdamWState(step, zeros(), zeros()), 0),
                    cell.in_shardings(shard)[0])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mesh_train_on_the_card_equals_the_unsharded_port(cuda, dtype,
                                                          monkeypatch):
    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").full_config(),
                              n_layers=LAYERS, dtype=dtype)
    monkeypatch.setitem(registry.LM_SHAPES, "train_4k", (SEQ, BATCH, "train"))
    cell = registry.lm_cells(cfg, n_microbatches=MICRO)["train_4k"]
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             next(token_batches(cfg.vocab_size, BATCH, SEQ, seed=2)).items()}
    model = init_lm_params(cfg, seed=3, device=cuda)
    mesh = make_tiny_mesh(devices=[cuda] * 8)
    shard = Sharder.for_mesh(mesh)
    state = sharded_state(cfg, model, shard, cell)
    plain = TrainState(model, adamw_init(model), 0)
    step, plain_step = cell.make_step(shard), cell.make_step(Sharder(None))
    losses = []
    # one row a microbatch: one data group holds it, 4 positions with heads
    want_k4 = 2 * LAYERS * 4 * MICRO
    route = "wgmma" if dtype == "bfloat16" else "simt"
    for _ in range(STEPS):
        plain, want = plain_step(plain, batch)
        k4.reset_launch_count()
        state, got = step(state, batch)
        assert k4.launch_count() == k4.launch_count(route) == want_k4
        for key in ("loss", "grad_norm"):
            g, w = float(got[key]), float(want[key])
            if dtype == "bfloat16":
                assert abs(g - w) <= NORMWISE * abs(w), key
            else:
                assert abs(g - w) <= 1e-4 * abs(w), key
        assert int(got["step"]) == int(want["step"])
        losses.append(float(got["loss"]))
    assert losses[0] > losses[1] > losses[2]
