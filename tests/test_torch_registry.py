"""The port's cell registry against the reference's: every arch's cells --
the LMs, the GNNs, xDeepFM and ``sgrapp``, the reference's 11 -- (names,
kinds, skips, donations, ``model_flops`` and the abstract inputs leaf by
leaf), the ``Sharder``, and the ``sgrapp`` smoke steps against the
reference's on the same lanes (numpy draws from a seed), with and without a
mesh.  Window counts are exact integers in float32 at these sizes, so they
are held equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import list_cells as j_list_cells  # noqa: E402
from repro.distributed.sharding import Sharder as JSharder  # noqa: E402
from repro_torch.configs import ARCHS, Cell, get_arch, list_cells  # noqa: E402
from repro_torch.configs.registry import ShapeDtype, sd  # noqa: E402
from repro_torch.distributed import NO_SHARD, Sharder  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.train.checkpoint import tree_flatten  # noqa: E402

LM_ARCHS = ["phi4-mini-3.8b", "granite-8b", "minicpm3-4b", "phi3.5-moe-42b",
            "dbrx-132b"]
GNN_ARCHS = ["graphsage-reddit", "graphcast", "dimenet", "equiformer-v2"]
ALL = LM_ARCHS + GNN_ARCHS + ["xdeepfm", "sgrapp"]


def dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def test_the_port_registers_the_lms_and_sgrapp():
    """Every arch of the reference's registry, with its family."""
    from repro.configs import ARCHS as J_ARCHS
    assert set(ARCHS) == set(ALL) == set(J_ARCHS)
    assert get_arch("sgrapp").family == "stream"
    assert all(get_arch(a).family == "lm" for a in LM_ARCHS)
    assert all(get_arch(a).family == J_ARCHS[a].family for a in ALL)


@pytest.mark.parametrize("arch", ALL)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_cells_match_the_reference(arch, smoke):
    got, want = list_cells(arch, smoke=smoke), j_list_cells(arch, smoke=smoke)
    assert list(got) == list(want)
    for name, cell in got.items():
        ref = want[name]
        assert isinstance(cell, Cell)
        assert (cell.name, cell.kind, cell.skip, cell.donate) == (
            ref.name, ref.kind, ref.skip, ref.donate), name
        assert cell.model_flops == ref.model_flops, name
        assert (cell.logical_out_specs is None) == (ref.logical_out_specs is None)


@pytest.mark.parametrize("arch", ALL)
def test_abstract_inputs_match_the_reference_and_allocate_nothing(arch):
    smoke = arch == "sgrapp"
    got, want = list_cells(arch, smoke=smoke), j_list_cells(arch, smoke=smoke)
    for name, cell in got.items():
        g_leaves, g_def = tree_flatten(cell.abstract_inputs())
        w_leaves, w_def = jax.tree.flatten(want[name].abstract_inputs())
        assert str(g_def) == str(w_def), name
        assert len(g_leaves) == len(w_leaves), name
        for g, w in zip(g_leaves, w_leaves):
            assert isinstance(g, ShapeDtype), name
            assert g.shape == tuple(w.shape), name
            assert dtype_name(g.dtype) == str(w.dtype), name


@pytest.mark.parametrize("arch", ALL)
def test_logical_specs_equal_the_reference_leaf_by_leaf(arch):
    smoke = arch == "sgrapp"
    is_spec = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        a is None or isinstance(a, str) for a in x)
    for name, cell in list_cells(arch, smoke=smoke).items():
        want = j_list_cells(arch, smoke=smoke)[name]
        g = jax.tree.leaves(cell.logical_specs(), is_leaf=is_spec)
        w = jax.tree.leaves(want.logical_specs(), is_leaf=is_spec)
        assert g == w, name
        if cell.logical_out_specs is not None:
            assert jax.tree.leaves(cell.logical_out_specs(), is_leaf=is_spec) \
                == jax.tree.leaves(want.logical_out_specs(), is_leaf=is_spec)


def test_sd_is_a_record():
    s = sd((2, 3))
    assert s == ShapeDtype((2, 3), torch.float32)
    assert sd([4], torch.int32).shape == (4,)


def j_mesh(shape, axes):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape)), dtype=object)
    return jax.sharding.Mesh(devs.reshape(shape), axes)


@pytest.mark.parametrize("shape,axes", [
    ((1, 1), ("data", "model")),
    ((1, 1, 1), ("pod", "data", "model")),
    ((1, 1), ("replica", "x")),
])
def test_sharder_for_mesh_matches_the_reference(shape, axes):
    mesh = make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))
    got = Sharder.for_mesh(mesh, seq_parallel=True, grad_compression="int8")
    want = JSharder.for_mesh(j_mesh(shape, axes), seq_parallel=True,
                             grad_compression="int8")
    for field in ("data_axes", "model_axis", "seq_parallel", "grad_compression"):
        assert getattr(got, field) == getattr(want, field), field
    for logical in ("batch", "model", "seq", "data", None):
        assert got.spec(logical) == tuple(want.spec(logical))
    if got.model_axis is not None:
        assert got.spec("flat") == tuple(want.spec("flat"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        got.named("batch")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        got.act(torch.zeros(2), "batch")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        got.params({"w": (None,)}, {"w": torch.zeros(2)})


def test_sharder_without_a_mesh():
    got, want = Sharder(None), JSharder(None)
    assert NO_SHARD is None
    for field in ("mesh", "data_axes", "model_axis", "seq_parallel",
                  "grad_compression"):
        assert getattr(got, field) == getattr(want, field), field
    assert Sharder.for_mesh(None) == Sharder(None)
    assert got.named("batch") is None
    x = torch.ones(3)
    assert got.act(x, "batch") is x
    assert got.params({"a": (None,), "b": [(None,)]},
                      {"a": x, "b": [x]}) == {"a": None, "b": [None]}
    cell = list_cells("phi4-mini-3.8b", smoke=True)["prefill_32k"]
    assert cell.in_shardings(got) is None and cell.out_shardings(got) is None
    with pytest.raises(ValueError, match="unknown logical axis"):
        got.spec("nope")


def test_lm_steps_refuse_a_mesh():
    mesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    cells = list_cells("phi4-mini-3.8b", smoke=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        cells["prefill_32k"].make_step(Sharder.for_mesh(mesh))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        cells["train_4k"].in_shardings(Sharder.for_mesh(mesh))


@pytest.mark.parametrize("arch", GNN_ARCHS + ["xdeepfm"])
def test_gnn_and_recsys_steps_refuse_a_mesh(arch):
    """Without a mesh each cell's step is built; on one, every step raises
    naming the item that ports sharding."""
    mesh = make_mesh((1, 1), ("data", "model"), ["cpu"])
    for cell in list_cells(arch, smoke=True).values():
        assert callable(cell.make_step(Sharder(None)))
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            cell.make_step(Sharder.for_mesh(mesh))


# -- the sgrapp cells ----------------------------------------------------------

def lanes(W, cap, n_i, n_j, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_i, (W, cap)).astype(np.int32),
            rng.integers(0, n_j, (W, cap)).astype(np.int32),
            rng.random((W, cap)) < 0.8)


def skewed_lanes(W, cap, n_i, n_j, seed):
    """Hubs on both sides: ids drawn as ``floor(n * u**3)``."""
    rng = np.random.default_rng(seed)
    return ((n_i * rng.random((W, cap)) ** 3).astype(np.int32),
            (n_j * rng.random((W, cap)) ** 3).astype(np.int32),
            rng.random((W, cap)) < 0.9)


@pytest.mark.parametrize("draw", [lanes, skewed_lanes])
def test_sgrapp_win_8k_equals_the_reference(draw):
    W, cap, n_i, n_j = get_arch("sgrapp").smoke_config()["shapes"]["win_8k"]
    ei, ej, v = draw(W, cap, n_i, n_j, 11)
    want = j_list_cells("sgrapp", smoke=True)["win_8k"].make_step(JSharder(None))(
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(v))
    step = list_cells("sgrapp", smoke=True)["win_8k"].make_step(Sharder(None),
                                                                device="cpu")
    got = step(ei, ej, v)
    assert got.dtype == torch.float32 and got.shape == (W,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want).max() > 0


@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (4, 1)])
def test_sgrapp_win_8k_over_a_cpu_mesh_equals_the_reference(grid):
    W, cap, n_i, n_j = get_arch("sgrapp").smoke_config()["shapes"]["win_8k"]
    ei, ej, v = skewed_lanes(W, cap, n_i, n_j, 12)
    want = j_list_cells("sgrapp", smoke=True)["win_8k"].make_step(JSharder(None))(
        jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(v))
    mesh = make_mesh(grid, ("data", "model"), ["cpu"] * (grid[0] * grid[1]))
    step = list_cells("sgrapp", smoke=True)["win_8k"].make_step(
        Sharder.for_mesh(mesh))
    np.testing.assert_array_equal(step(ei, ej, v).cpu().numpy(),
                                  np.asarray(want))


def test_sgrapp_chunks_windows_to_the_stack_budget(monkeypatch):
    """A budget of one window's stack counts one window per K1 launch, with
    the same counts."""
    from repro_torch.configs import registry
    W, cap, n_i, n_j = get_arch("sgrapp").smoke_config()["shapes"]["win_8k"]
    ei, ej, v = skewed_lanes(W, cap, n_i, n_j, 13)
    whole = registry.window_counter(n_i, n_j, "cpu")(ei, ej, v)
    monkeypatch.setattr(registry, "STACK_BYTES", n_i * n_j)
    calls = []
    from repro_torch.kernels.butterfly import ops
    orig = ops.butterfly_count_pallas_windows
    monkeypatch.setattr(ops, "butterfly_count_pallas_windows",
                        lambda a, **kw: calls.append(a.shape) or orig(a, **kw))
    chunked = registry.window_counter(n_i, n_j, "cpu")(ei, ej, v)
    assert calls == [(1, n_i, n_j)] * W
    assert torch.equal(whole, chunked)


def test_sgrapp_estimator_equals_the_reference():
    W, cap, n_i, n_j = get_arch("sgrapp").smoke_config()["shapes"]["estimator"]
    ei, ej, v = skewed_lanes(W, cap, n_i, n_j, 14)
    cum = np.cumsum(v.sum(1)).astype(np.float32)
    rng = np.random.default_rng(15)
    truths = (cum ** 1.5 * rng.uniform(0.5, 1.5, W)).astype(np.float32)
    tmask = np.arange(W) < W // 2
    args = (ei, ej, v, cum, truths, tmask)
    w_est, w_alpha = j_list_cells("sgrapp", smoke=True)["estimator"].make_step(
        JSharder(None))(*map(jnp.asarray, args), jnp.float32(1.02))
    est, alpha = list_cells("sgrapp", smoke=True)["estimator"].make_step(
        Sharder(None), device="cpu")(*args, 1.02)
    np.testing.assert_allclose(est.numpy(), np.asarray(w_est), rtol=1e-6)
    np.testing.assert_allclose(float(alpha), float(w_alpha), rtol=1e-6)
