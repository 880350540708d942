"""The halo-exchange losses of the port (``sage_loss_halo``,
``eqv2_loss_halo``) on a CPU mesh of 8 shards (``[cpu] * 8`` as a 2 x 4
``("data", "model")`` grid: one device may repeat, so the shards run one
after another in this process) against the port's gather losses and the
reference's, on the reference's own inputs (``tests/test_halo.py``: a
locality graph of 64 nodes, the reference's weights carried across).

Tolerances are the reference's own (``tests/test_halo.py``): the halo loss
within 2e-5 (GraphSAGE) and 3e-5 (EquiformerV2) of the gather loss, both
against the port's gather loss and the reference's (measured: GraphSAGE
0.0 and 1.2e-07, EquiformerV2 0.0 and 1.2e-07).  The halo loss's
gradients, through the all-to-all, equal the gather loss's within rtol =
atol = 1e-4 (measured ``max|dg| / max|g|`` up to 9.0e-07, but for
EquiformerV2's last attention bias, whose gradient is 0 up to rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.gnn import equiformer_v2 as j_eqv2  # noqa: E402
from repro.models.gnn import graphsage as j_sage  # noqa: E402
from repro_torch.graphs.halo import build_partitioned_batch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.models.gnn.equiformer_v2 import EqV2Config  # noqa: E402
from repro_torch.models.gnn.graphsage import SAGEConfig  # noqa: E402
from repro_torch.train.optimizer import param_leaves  # noqa: E402

AXES = ("data", "model")


def cpu_mesh():
    return make_mesh((2, 4), AXES, ["cpu"] * 8)


def locality(n, e, seed=0, far=True):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = np.clip(src + rng.integers(-4, 5, e), 0, n - 1)
    if far:
        dst = np.where(rng.random(e) < 0.2, rng.integers(0, n, e), dst)
    return rng, src, dst


def as_torch(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def grads(loss, params):
    leaves = list(param_leaves(params).values())
    return torch.autograd.grad(loss, leaves)


def with_grad(params):
    for p in param_leaves(params).values():
        p.requires_grad_(True)
    return params


def sage_case(seed=0, halo=64):
    rng, src, dst = locality(64, 400, seed)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    labels = rng.integers(0, 5, 64)
    cfg = SAGEConfig(name="s", d_in=16, d_hidden=8, n_classes=5)
    jp = j_sage.init_sage(jax.random.PRNGKey(seed), j_sage.SAGEConfig(
        name="s", d_in=16, d_hidden=8, n_classes=5))
    pg = build_partitioned_batch(src, dst, x, labels, 8, halo=halo)
    gather = {"x": x, "edge_src": src, "edge_dst": dst, "labels": labels,
              "label_mask": np.ones(64, np.float32)}
    return cfg, jax.tree.map(np.asarray, jp), pg.device_batch(), gather


def test_sage_halo_loss_equals_the_gather_loss():
    cfg, ref, halo_batch, gather = sage_case()
    params = with_grad(gnn.params_from_reference(ref, "cpu"))
    lh = gnn.sage_loss_halo(params, as_torch(halo_batch), cfg, cpu_mesh(), AXES)
    lg = gnn.sage_loss(params, as_torch(gather), cfg)
    lr = float(j_sage.sage_loss(jax.tree.map(jnp.asarray, ref),
                                {k: jnp.asarray(v) for k, v in gather.items()}, cfg))
    assert abs(float(lh) - float(lg)) < 2e-5, (float(lh), float(lg))
    assert abs(float(lh) - lr) < 2e-5, (float(lh), lr)
    for a, b in zip(grads(lh, params), grads(lg, params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_sage_halo_loss_with_dropped_halo_rows_differs():
    """A halo budget of 2 rows drops edges (masked off), so the loss is no
    longer the gather loss: the exchange is what carries the boundary."""
    cfg, ref, halo_batch, gather = sage_case(halo=2)
    params = gnn.params_from_reference(ref, "cpu")
    lh = gnn.sage_loss_halo(params, as_torch(halo_batch), cfg, cpu_mesh(), AXES)
    lg = gnn.sage_loss(params, as_torch(gather), cfg)
    assert np.isfinite(float(lh)) and abs(float(lh) - float(lg)) > 1e-4


def eqv2_case():
    rng, src, dst = locality(64, 300, 0, far=False)
    x = rng.normal(size=(64, 12)).astype(np.float32)
    labels = rng.integers(0, 4, 64)
    kw = dict(name="e", n_layers=2, d_hidden=8, l_max=2, m_max=1, n_heads=2,
              d_in=12, d_out=4, dtype="float32")
    cfg = EqV2Config(**kw)
    ref = jax.tree.map(np.asarray, j_eqv2.init_eqv2(jax.random.PRNGKey(0),
                                                    j_eqv2.EqV2Config(**kw)))
    nc = cfg.n_coeff
    pg = build_partitioned_batch(src, dst, x, labels, 8, halo=64)
    wig_global = rng.normal(size=(300, nc, nc)).astype(np.float32) * 0.2
    # each kept edge's Wigner matrix in its receiver's edge slot
    owner = np.minimum(dst // pg.n_loc, 7)
    wig_p = np.zeros((8,) + pg.edge_src_ext.shape[1:] + (nc, nc), np.float32)
    for d in range(8):
        mine = np.flatnonzero(owner == d)[:pg.edge_src_ext.shape[1]]
        wig_p[d, :len(mine)] = wig_global[mine]
    halo_batch = pg.device_batch() | {"wigner": wig_p}
    gather = {"x": x, "edge_src": src, "edge_dst": dst, "wigner": wig_global,
              "labels": labels, "label_mask": np.ones(64, np.float32)}
    return cfg, ref, halo_batch, gather


def test_eqv2_halo_loss_equals_the_gather_loss():
    cfg, ref, halo_batch, gather = eqv2_case()
    params = with_grad(gnn.params_from_reference(ref, "cpu"))
    lh = gnn.eqv2_loss_halo(params, as_torch(halo_batch), cfg, cpu_mesh(), AXES)
    lg = gnn.eqv2_loss(params, as_torch(gather), cfg)
    lr = float(j_eqv2.eqv2_loss(jax.tree.map(jnp.asarray, ref),
                                {k: jnp.asarray(v) for k, v in gather.items()}, cfg))
    assert abs(float(lh) - float(lg)) < 3e-5, (float(lh), float(lg))
    assert abs(float(lh) - lr) < 3e-5, (float(lh), lr)
    for a, b in zip(grads(lh, params), grads(lg, params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grid,axes", [((8,), ("data",)), ((4, 2), ("model", "data"))])
def test_halo_losses_on_other_meshes(grid, axes):
    """The shard order follows ``axes`` (``Mesh.shard_devices``): a 1-D mesh
    of 8 and a 4 x 2 grid split model-major give the same loss."""
    cfg, ref, halo_batch, gather = sage_case(seed=1)
    params = gnn.params_from_reference(ref, "cpu")
    names = ("data",) if len(grid) == 1 else ("model", "data")
    mesh = make_mesh(grid, names, ["cpu"] * 8)
    lh = gnn.sage_loss_halo(params, as_torch(halo_batch), cfg, mesh, axes)
    lg = gnn.sage_loss(params, as_torch(gather), cfg)
    assert abs(float(lh) - float(lg)) < 2e-5


def test_a_batch_partitioned_for_another_mesh_is_refused():
    cfg, ref, halo_batch, _ = sage_case()
    mesh = make_mesh((2, 2), AXES, ["cpu"] * 4)
    with pytest.raises(ValueError, match="not partitioned over 4 devices"):
        gnn.sage_loss_halo(gnn.params_from_reference(ref, "cpu"),
                           as_torch(halo_batch), cfg, mesh, AXES)
