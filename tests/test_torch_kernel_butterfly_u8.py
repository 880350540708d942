"""K1's uint8 layout, its two routes and its exact summation, on the CPU.

K1 reads 0/1 stacks as uint8 through TMA, which takes rows of a multiple
of 16 bytes: the pallas tier's scatter builds such a stack, anything else
goes to the kernel as one zero-padded uint8 copy.  Its partials are the
exact sums of the reference's float32 per-entry values ``w(w-1)/2``,
rounded once to float32; the plain version sums them in int64.  These
tests hold the scatter, the route rule and the plain version to the
reference (its Pallas kernel in interpret mode, as its own tests run it)
and to exact integer arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.butterfly import build_biadjacency as j_build  # noqa: E402
from repro.kernels.butterfly.butterfly_kernel import (  # noqa: E402
    butterfly_pairs_windows_kernel_call as j_k1,
)
from repro.kernels.butterfly.ops import (  # noqa: E402
    butterfly_count_pallas_windows as j_count,
)
from repro_torch.core.butterfly import (  # noqa: E402
    build_biadjacency,
    count_butterflies_np,
)
from repro_torch.core.executor import WindowExecutor  # noqa: E402
from repro_torch.core.windows import windowize  # noqa: E402
from repro_torch.kernels.butterfly import butterfly_kernel as k1  # noqa: E402
from repro_torch.kernels.butterfly.ops import (  # noqa: E402
    butterfly_count_pallas,
    butterfly_count_pallas_windows,
    oriented,
    oriented_biadjacency,
)
from repro_torch.streams import bipartite_pa_stream  # noqa: E402


def stack(b, n, k, density, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    return (rng.random((b, n, k)) < density).astype(dtype)


def lanes(b, n_i, n_j, m, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n_i, (b, m)).astype(np.int32)
    ej = rng.integers(0, n_j, (b, m)).astype(np.int32)
    valid = rng.random((b, m)) < 0.8
    return ei, ej, valid


def exact_partials(a, block_i):
    """The partials by integer arithmetic: each entry's float32
    ``w(w-1)/2`` summed per tile pair as Python ints, rounded once to
    float32 (the sums stay below 2**53, so the float64 step is exact)."""
    b, n, _ = a.shape
    nu = -(-n // block_i)
    u, v = np.triu_indices(nu)
    out = np.zeros((b, len(u)), dtype=np.float32)
    for w_ in range(b):
        ai = a[w_].astype(np.int64)
        w = (ai @ ai.T).astype(np.float32)
        p = (w * (w - np.float32(1)) * np.float32(0.5)).astype(np.int64)
        p = np.triu(p, 1)
        for t, (uu, vv) in enumerate(zip(u, v)):
            s = int(p[uu * block_i:(uu + 1) * block_i,
                      vv * block_i:(vv + 1) * block_i].sum())
            assert s < 2**53
            out[w_, t] = np.float32(float(s))
    return out


@pytest.mark.parametrize("n_i,n_j", [(40, 24), (24, 40), (33, 33)])
@pytest.mark.parametrize("stacked", [False, True])
def test_uint8_scatter_equals_oriented_build_and_reference(n_i, n_j, stacked):
    ei, ej, valid = lanes(3, n_i, n_j, 90, seed=n_i * n_j)
    ei[0, 5], valid[0, 5] = n_i + 7, False       # a padding lane past the edge
    if not stacked:
        ei, ej, valid = ei[0], ej[0], valid[0]
    t = [torch.from_numpy(x) for x in (ei, ej, valid)]
    built = oriented_biadjacency(*t, n_i, n_j)
    assert built.dtype == torch.uint8 and built.is_contiguous()
    want = oriented(build_biadjacency(*t, n_i, n_j))
    assert want.dtype == torch.float32
    assert torch.equal(built.float(), want)
    # the reference builds one window at a time
    ref = np.stack([np.asarray(j_build(*(jnp.asarray(x[w]) for x in
                                         (ei, ej, valid)), n_i, n_j))
                    for w in range(3)]) if stacked else np.asarray(
        j_build(*(jnp.asarray(x) for x in (ei, ej, valid)), n_i, n_j))
    if n_i > n_j:
        ref = np.swapaxes(ref, -2, -1)
    np.testing.assert_array_equal(built.numpy(), ref.astype(np.uint8))


@pytest.mark.parametrize("snap", [16, 0])
def test_executor_stacks_have_16_byte_rows(snap):
    """The pallas tier's capacities are multiples of ``snap`` or of 64, so
    every stack its scatter builds is read by K1 as it lies."""
    s = bipartite_pa_stream(6000, n_unique=1500, seed=4)
    wb = windowize(s.tau, s.edge_i, s.edge_j, 120)
    ex = WindowExecutor("pallas", device="cpu", snap=snap)
    plan = ex.plan(wb)
    assert len(plan) > 1
    for b in plan:
        win = b.windows[:ex.chunk]
        a = oriented_biadjacency(
            *(torch.as_tensor(x[win, :b.cap_e])
              for x in (wb.edge_i, wb.edge_j, wb.valid)), b.cap_i, b.cap_j)
        assert a.shape[-1] == max(b.cap_i, b.cap_j)
        assert a.shape[-1] % 16 == 0 and a.stride(-2) % 16 == 0
        assert k1.tma_ready(a)


@pytest.mark.parametrize("what,ready", [
    ("float32", False),              # a float32 0/1 stack from a test
    ("uint8 odd n_cols", False),     # rows of 37 bytes
    ("uint8 48 cols", True),
    ("uint8 view off 16 bytes", False),
    ("snap-aligned executor stack", True),
])
def test_route_rule(what, ready):
    a = {
        "float32": lambda: torch.from_numpy(stack(2, 20, 48, 0.3, 1, np.float32)),
        "uint8 odd n_cols": lambda: torch.from_numpy(stack(2, 20, 37, 0.3, 1)),
        "uint8 48 cols": lambda: torch.from_numpy(stack(2, 20, 48, 0.3, 1)),
        "uint8 view off 16 bytes": lambda: torch.from_numpy(
            stack(1, 1, 16 * 20 + 3, 0.3, 1)).reshape(-1)[3:].view(1, 20, 16),
        "snap-aligned executor stack": lambda: oriented_biadjacency(
            *(torch.from_numpy(x) for x in lanes(3, 80, 176, 200, 2)), 80, 176),
    }[what]()
    assert k1.tma_ready(a) is ready
    if ready:
        return
    c = k1.tma_copy(a)
    assert k1.tma_ready(c)
    assert c.shape == a.shape[:2] + (-(-a.shape[2] // 16) * 16,)
    assert torch.equal(c[..., :a.shape[2]], a.to(torch.uint8))
    assert not c[..., a.shape[2]:].any()


@pytest.mark.parametrize("b,n,k,bi,bk,density", [
    (2, 16, 16, 8, 8, 0.4),
    (3, 37, 41, 8, 16, 0.3),      # ragged rows and contraction
    (1, 100, 70, 32, 32, 0.25),
    (3, 24, 20, 8, 8, 0.0),       # empty windows
])
def test_plain_on_uint8_equals_reference_kernel(b, n, k, bi, bk, density):
    a = stack(b, n, k, density, seed=n * k)
    pad = np.pad(a.astype(np.float32),
                 ((0, 0), (0, (-n) % bi), (0, (-k) % bk)))
    want = np.asarray(j_k1(jnp.asarray(pad), block_i=bi, block_k=bk,
                           interpret=True))
    got = k1.butterfly_pairs_windows_kernel_call(torch.from_numpy(a),
                                                 block_i=bi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), exact_partials(a, bi))


def test_plain_past_2_24_is_exact_and_within_1e6_of_float64():
    """Dense windows put every off-diagonal partial past 2**24, where a
    float32 sum rounds in any order: the plain version is the exact sum
    rounded once, within 2**-24 of the float64 sum of the same values."""
    a = stack(2, 96, 2048, 0.5, seed=3)
    got = k1.butterfly_pairs_windows_plain(torch.from_numpy(a), block_i=32)
    want64 = k1.butterfly_pairs_windows_plain(torch.from_numpy(a),
                                              block_i=32, dtype=torch.float64)
    assert float(want64.min()) > 2**24
    np.testing.assert_array_equal(got.numpy(), exact_partials(a, 32))
    rel = ((got.double() - want64).abs() / want64).max()
    assert float(rel) <= 1e-6


@pytest.mark.parametrize("perm", [(2, 0, 1), (1, 2, 0), (2, 1, 0)])
def test_plain_partials_do_not_depend_on_the_tile_order(perm):
    """Permuting whole row tiles of A permutes W's tile pairs; an off-
    diagonal tile pair that crosses the diagonal is then summed as the
    transposed block, in another order.  The exact summation gives the
    same bits for each tile pair, past 2**24 too."""
    bi = 32
    a = stack(1, 3 * bi, 4096, 0.5, seed=8)
    moved = a.reshape(1, 3, bi, -1)[:, list(perm)].reshape(a.shape)
    got = k1.butterfly_pairs_windows_plain(torch.from_numpy(moved), block_i=bi)
    base = k1.butterfly_pairs_windows_plain(torch.from_numpy(a), block_i=bi)
    assert float(base.max()) > 2**24
    u, v = k1.triangle_pairs(3)
    index = {(int(x), int(y)): t for t, (x, y) in enumerate(zip(u, v))}
    for (x, y), t in index.items():
        px, py = sorted((perm[x], perm[y]))
        assert got[0, t].item() == base[0, index[(px, py)]].item()


@pytest.mark.parametrize("b,n_i,n_j,bi", [
    (3, 40, 24, 8),       # n_i > n_j: orientation flip
    (2, 33, 131, 16),     # non-tile-multiple
    (4, 50, 50, 256),     # block clamps to the matrix
])
def test_count_windows_on_uint8_equal_reference_per_window(b, n_i, n_j, bi):
    a = stack(b, n_i, n_j, 0.3, seed=b + n_i + n_j)
    a[-1] = 0                                     # one empty window
    want = np.asarray(j_count(jnp.asarray(a.astype(np.float32)), block_i=bi,
                              block_k=128, interpret=True))
    got = butterfly_count_pallas_windows(torch.from_numpy(a), block_i=bi)
    np.testing.assert_array_equal(got.numpy(), want)
    for w in range(b):
        ii, jj = np.nonzero(a[w])
        assert got[w].item() == count_butterflies_np(np.stack([ii, jj], 1))
    one = butterfly_count_pallas(torch.from_numpy(a[0]), block_i=bi)
    assert one.item() == want[0]


def test_oriented_keeps_uint8_and_k2_takes_float32_only():
    a = torch.from_numpy(stack(2, 40, 24, 0.3, seed=1))
    o = oriented(a)
    assert o.dtype == torch.uint8 and o.shape == (2, 24, 40)
    assert torch.equal(o, a.transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        k1.butterfly_pairs_windows_kernel_multiset_call(o, block_i=8)
    with pytest.raises(ValueError, match="float32 or float64"):
        k1.butterfly_pairs_windows_plain(o, block_i=8, dtype=torch.float16)


def test_route_counts_start_at_zero_and_cpu_counts_nothing():
    k1.reset_launch_count()
    a = torch.from_numpy(stack(2, 20, 37, 0.3, seed=1))
    k1.butterfly_pairs_windows_kernel_call(a, block_i=8)
    k1.butterfly_pairs_kernel_call(a[0], block_i=8)
    assert all(k1.launch_count(k, r) == 0
               for k in ("K1", "K3") for r in k1.ROUTES)
    assert k1.launch_count("K1") == k1.launch_count("K3") == 0
