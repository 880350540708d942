"""The GNN and recsys families on the card (marked ``gpu``): chip_smoke's
phases 21 (a), (c) and 22 (a) at a small size.

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_gnn.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture.  No TPU kernel lies on this path: the card runs torch's
own gathers, ``index_add`` / ``scatter_reduce`` (with atomics, in a
run-dependent order) and GEMMs, so it is held to the CPU port within an
rtol: segment sums and means within ``1e-5`` of the segment's sum (mean) of
magnitudes (measured on an H100: 6.7e-05 off on a hub segment of about
5,800 terms, whose magnitudes sum to thousands), maxima and softmaxes
within rtol 1e-5, atol 1e-6; each model's loss within
rtol 1e-4 and every gradient leaf within ``1e-4 * max|g_cpu| + 1e-6``
(chip_smoke's bounds); the halo losses over ``[cuda:0] * 8`` within the
reference's 2e-5 and 3e-5 of the gather losses.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch, list_cells  # noqa: E402
from repro_torch.configs.registry import _GNN_INIT, _GNN_LOSS  # noqa: E402
from repro_torch.distributed import Sharder  # noqa: E402
from repro_torch.graphs import segment  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.recsys.xdeepfm import init_xdeepfm, xdeepfm_loss  # noqa: E402
from repro_torch.train import TrainState, adamw_init  # noqa: E402
from repro_torch.train.checkpoint import tree_map  # noqa: E402
from repro_torch.train.optimizer import param_leaves  # noqa: E402

pytestmark = pytest.mark.gpu

GNN_KEY = {"graphsage-reddit": "graphsage", "graphcast": "graphcast",
           "dimenet": "dimenet", "equiformer-v2": "equiformer"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's atomics are what is held")
    return torch.device("cuda", 0)


def value_and_grads(loss_fn, params, batch):
    leaves = param_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    return float(loss.detach()), torch.autograd.grad(loss, list(leaves.values()))


def on(tree, device):
    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


def hold(loss_fn, params, batch, cuda):
    l_cpu, g_cpu = value_and_grads(loss_fn, params, batch)
    l_card, g_card = value_and_grads(loss_fn, on(params, cuda), on(batch, cuda))
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-6


@pytest.mark.parametrize("fn", ["segment_sum", "segment_mean", "segment_max",
                                "segment_softmax"])
def test_segment_ops_on_the_card_equal_the_cpu(cuda, fn):
    g = torch.Generator().manual_seed(0)
    data = torch.randn(100_000, 8, generator=g)
    dst = (5000 * torch.rand(100_000, generator=g) ** 3).long()   # hubs
    mask = torch.rand(100_000, generator=g) < 0.9
    want = getattr(segment, fn)(data, dst, 6000, mask)
    got = getattr(segment, fn)(data.to(cuda), dst.to(cuda), 6000, mask.to(cuda))
    if fn in ("segment_sum", "segment_mean"):
        # float32 sums in two orders differ by up to a few ulps of the
        # segment's sum of magnitudes, whatever the sum itself
        scale = getattr(segment, fn)(data.abs(), dst, 6000, mask)
        assert bool(((got.cpu() - want).abs() <= 1e-5 * scale + 1e-6).all())
    else:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def graph_batch(key, cfg, n=1024, e=4096, seed=0):
    """A seeded CPU batch on ``n`` nodes and ``e`` edges, destinations
    skewed (hubs, where the card's atomics collide)."""
    from repro_torch.models.gnn.dimenet import build_triplets_vectorised

    g = torch.Generator().manual_seed(seed)
    src = torch.randint(0, n, (e,), generator=g)
    dst = (n * torch.rand(e, generator=g) ** 3).long()
    b = {"edge_src": src.int(), "edge_dst": dst.int(),
         "edge_mask": torch.rand(e, generator=g) < 0.95}
    rnd = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    if key == "graphsage":
        b |= {"x": rnd(n, cfg.d_in), "labels": torch.randint(0, cfg.n_classes, (n,),
                                                             generator=g),
              "label_mask": torch.ones(n)}
    elif key == "graphcast":
        b |= {"x": rnd(n, cfg.d_in), "edge_feat": rnd(e, cfg.d_edge_in),
              "target": rnd(n, cfg.d_out)}
    elif key == "dimenet":
        t_in, t_out, t_mask = build_triplets_vectorised(src.numpy(), dst.numpy(), 2 * e)
        b |= {"pos": rnd(n, 3) * 2, "z": torch.randint(1, 9, (n, 1), generator=g).float(),
              "t_in": torch.as_tensor(t_in), "t_out": torch.as_tensor(t_out),
              "triplet_mask": torch.as_tensor(t_mask), "target": rnd(n, 1)}
    else:
        b |= {"x": rnd(n, cfg.d_in), "wigner": rnd(e, cfg.n_coeff, cfg.n_coeff) * 0.2,
              "labels": torch.randint(0, cfg.d_out, (n,), generator=g),
              "label_mask": torch.ones(n)}
    return b


@pytest.mark.parametrize("arch", list(GNN_KEY))
def test_gnn_smoke_on_the_card_equals_the_cpu(cuda, arch):
    cell = list_cells(arch, smoke=True)["molecule"]
    cfg = cell.config
    batch = graph_batch(GNN_KEY[arch], cfg)
    params = _GNN_INIT[GNN_KEY[arch]](cfg, seed=0, device="cpu")
    hold(lambda p, b: _GNN_LOSS[GNN_KEY[arch]](p, b, cfg), params, batch, cuda)
    state = TrainState(on(params, cuda), adamw_init(on(params, cuda)), 0)
    state, m = cell.make_step(Sharder(None))(state, on(batch, cuda))
    assert np.isfinite(float(m["loss"])) and int(m["step"]) == 1


def test_xdeepfm_smoke_on_the_card_equals_the_cpu(cuda):
    cfg = get_arch("xdeepfm").smoke_config()
    g = torch.Generator().manual_seed(1)
    batch = {"ids": torch.randint(0, cfg.vocab_per_field, (256, cfg.n_sparse),
                                  generator=g).int(),
             "clicks": (torch.rand(256, generator=g) < 0.3).float()}
    hold(lambda p, b: xdeepfm_loss(p, b, cfg),
         init_xdeepfm(cfg, seed=1, device="cpu"), batch, cuda)


@pytest.mark.parametrize("arch", ["graphsage-reddit", "equiformer-v2"])
def test_halo_losses_over_eight_shards_of_the_card(cuda, arch):
    import dataclasses

    from repro_torch.graphs.halo import build_partitioned_batch

    cfg = dataclasses.replace(get_arch(arch).smoke_config(), d_in=16)
    rng = np.random.default_rng(0)
    n, e = 512, 4096
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-4, 5, e), 0, n - 1)
    dst = np.where(rng.random(e) < 0.2, rng.integers(0, n, e), dst)
    x = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 4, n)
    pg = build_partitioned_batch(src, dst, x, labels, 8, halo=n)
    assert pg.edge_mask.sum() == e
    gather = {"x": x, "edge_src": src, "edge_dst": dst, "labels": labels,
              "label_mask": np.ones(n, np.float32)}
    halo_b = pg.device_batch()
    if arch == "equiformer-v2":
        nc = cfg.n_coeff
        wig = (rng.normal(size=(e, nc, nc)) * 0.2).astype(np.float32)
        owner = np.minimum(dst // pg.n_loc, 7)
        wig_p = np.zeros((8, pg.edge_src_ext.shape[1], nc, nc), np.float32)
        for d in range(8):
            mine = np.flatnonzero(owner == d)
            wig_p[d, :len(mine)] = wig[mine]
        gather["wigner"], halo_b["wigner"] = wig, wig_p
    mesh = make_mesh((2, 4), ("data", "model"), [cuda] * 8)
    init, loss, loss_halo = {
        "graphsage-reddit": (gnn.init_sage, gnn.sage_loss, gnn.sage_loss_halo),
        "equiformer-v2": (gnn.init_eqv2, gnn.eqv2_loss, gnn.eqv2_loss_halo)}[arch]
    params = init(cfg, seed=0, device=cuda)
    to = lambda b: {k: torch.as_tensor(v, device=cuda) for k, v in b.items()}  # noqa: E731
    with torch.no_grad():
        lh = float(loss_halo(params, to(halo_b), cfg, mesh, ("data", "model")))
        lg = float(loss(params, to(gather), cfg))
    assert abs(lh - lg) < {"graphsage-reddit": 2e-5, "equiformer-v2": 3e-5}[arch]
