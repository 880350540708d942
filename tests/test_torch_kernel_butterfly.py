"""K1's plain version and wrappers against the reference Pallas kernel.

The reference runs its Pallas kernel in interpret mode on the CPU, as its
own tests do.  On CPU tensors the port's K1 wrapper runs the plain torch
version, so these tests hold that version's ``[B, T]`` partials, and the
per-window counts of ``butterfly_count_pallas_windows``, to the reference
exactly (0/1 inputs keep every partial an exact float32 integer).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.butterfly import (  # noqa: E402
    build_biadjacency as j_build,
    count_butterflies_dense as j_dense,
    count_butterflies_np,
)
from repro.kernels.butterfly.butterfly_kernel import (  # noqa: E402
    butterfly_pairs_windows_kernel_call as j_k1,
)
from repro.kernels.butterfly.ops import (  # noqa: E402
    butterfly_count_pallas_windows as j_count,
)
from repro.kernels.butterfly.ref import butterfly_count_ref as j_ref  # noqa: E402
from repro_torch.core.butterfly import (  # noqa: E402
    build_biadjacency,
    count_butterflies_dense,
)
from repro_torch.kernels.butterfly import butterfly_kernel as k1  # noqa: E402
from repro_torch.kernels.butterfly.ops import (  # noqa: E402
    butterfly_count_pallas_windows,
    clamp_block_i,
    oriented,
    oriented_biadjacency,
)
from repro_torch.kernels.butterfly.ref import butterfly_count_ref  # noqa: E402


def stack(b, n, k, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((b, n, k)) < density).astype(np.float32)


def padded(a, bi, bk):
    """The reference kernel wants tile-multiple shapes; the port does not."""
    return np.pad(a, ((0, 0), (0, (-a.shape[1]) % bi), (0, (-a.shape[2]) % bk)))


@pytest.mark.parametrize("b,n,k,bi,bk,density", [
    (2, 16, 16, 8, 8, 0.4),
    (3, 37, 41, 8, 16, 0.3),      # ragged rows and contraction
    (2, 64, 48, 16, 16, 0.2),
    (1, 100, 70, 32, 32, 0.25),
    (2, 13, 300, 8, 128, 0.1),    # skinny: one row tile
    (3, 24, 20, 8, 8, 0.0),       # empty windows
])
def test_plain_partials_equal_reference_kernel(b, n, k, bi, bk, density):
    a = stack(b, n, k, density, seed=n * k)
    want = np.asarray(j_k1(jnp.asarray(padded(a, bi, bk)), block_i=bi,
                           block_k=bk, interpret=True))
    got = k1.butterfly_pairs_windows_kernel_call(torch.from_numpy(a),
                                                 block_i=bi)
    assert got.shape == want.shape == (b, k1.n_tile_pairs(n, bi))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        k1.butterfly_pairs_windows_plain(torch.from_numpy(a), block_i=bi,
                                         dtype=torch.float64).numpy(), want)


@pytest.mark.parametrize("b,n_i,n_j,bi", [
    (3, 40, 24, 8),       # n_i > n_j: orientation flip
    (2, 24, 40, 8),
    (2, 33, 131, 16),     # non-tile-multiple
    (4, 50, 50, 256),     # block clamps to the matrix
    (2, 9, 7, 8),
])
def test_count_windows_equal_reference_per_window(b, n_i, n_j, bi):
    a = stack(b, n_i, n_j, 0.3, seed=b + n_i + n_j)
    a[-1] = 0.0                                   # one empty window
    want = np.asarray(j_count(jnp.asarray(a), block_i=bi, block_k=128,
                              interpret=True))
    got = butterfly_count_pallas_windows(torch.from_numpy(a), block_i=bi)
    np.testing.assert_array_equal(got.numpy(), want)
    for w in range(b):
        ii, jj = np.nonzero(a[w])
        assert got[w].item() == count_butterflies_np(np.stack([ii, jj], 1))


def test_count_windows_casts_other_dtypes():
    a = stack(2, 30, 20, 0.3, seed=1)
    want = butterfly_count_pallas_windows(torch.from_numpy(a), block_i=8)
    for dt in (torch.int8, torch.int32, torch.bfloat16, torch.float64):
        got = butterfly_count_pallas_windows(torch.from_numpy(a).to(dt),
                                             block_i=8)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n_i,n_j", [(40, 24), (24, 40), (16, 16)])
def test_oriented_puts_the_smaller_side_first(n_i, n_j):
    a = torch.from_numpy(stack(2, n_i, n_j, 0.3, seed=5)).to(torch.int8)
    got = oriented(a)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (2, min(n_i, n_j), max(n_i, n_j))
    want = a.transpose(1, 2) if n_i > n_j else a
    assert torch.equal(got, want.float())
    # the scatter builds the same stack without the transpose copy
    rng = np.random.default_rng(n_i)
    ei = torch.from_numpy(rng.integers(0, n_i, (2, 60)).astype(np.int32))
    ej = torch.from_numpy(rng.integers(0, n_j, (2, 60)).astype(np.int32))
    v = torch.from_numpy(rng.random((2, 60)) < 0.8)
    built = oriented_biadjacency(ei, ej, v, n_i, n_j)
    assert built.is_contiguous()
    assert torch.equal(built, oriented(build_biadjacency(ei, ej, v, n_i, n_j)))


@pytest.mark.parametrize("tf32", [True, False])
def test_dense_tier_restores_the_tf32_setting(tf32):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        count_butterflies_dense(torch.from_numpy(stack(1, 9, 7, 0.4, 3)[0]))
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_clamp_block_i_matches_reference_rule():
    for n in (1, 7, 8, 9, 100, 255, 256, 257, 5000):
        assert clamp_block_i(256, n) == min(256, max(8, -(-n // 8) * 8))


@pytest.mark.parametrize("bad,match", [
    (torch.zeros((4, 4)), "\\[B, n, k\\]"),
    (torch.zeros((1, 2, 4, 4)), "\\[B, n, k\\]"),
    (torch.zeros((1, 4, 4), dtype=torch.float64), "float32"),
    (torch.zeros((1, 4, 4), dtype=torch.int32), "float32"),
    (torch.zeros((1, 4, 4), device="meta").transpose(1, 2), "contiguous"),
])
def test_wrapper_raises_on_what_the_kernel_does_not_take(bad, match):
    with pytest.raises(ValueError, match=match):
        k1.butterfly_pairs_windows_kernel_call(bad, block_i=8)


@pytest.mark.parametrize("block_i", [0, -8, 8.0, True])
def test_wrapper_rejects_bad_block(block_i):
    with pytest.raises(ValueError, match="block_i"):
        k1.butterfly_pairs_windows_kernel_call(torch.zeros((1, 4, 4)),
                                               block_i=block_i)


def test_cpu_path_launches_nothing():
    k1.reset_launch_count()
    k1.butterfly_pairs_windows_kernel_call(torch.ones((2, 9, 5)), block_i=8)
    assert k1.launch_count() == 0


def test_triangle_pairs_row_major():
    u, v = k1.triangle_pairs(3)
    assert list(zip(u.tolist(), v.tolist())) == [
        (0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    assert k1.n_tile_pairs(17, 8) == 6


@pytest.mark.parametrize("n_i,n_j", [(30, 20), (20, 30), (1, 5)])
def test_ref_and_dense_tier_equal_reference(n_i, n_j):
    a = stack(1, n_i, n_j, 0.35, seed=n_i)[0]
    want = float(j_ref(jnp.asarray(a)))
    assert butterfly_count_ref(torch.from_numpy(a)).item() == want
    assert count_butterflies_dense(torch.from_numpy(a)).item() == float(
        j_dense(jnp.asarray(a)))


def test_build_biadjacency_equals_reference_and_drops_padding():
    rng = np.random.default_rng(2)
    ei = rng.integers(0, 12, 40).astype(np.int32)
    ej = rng.integers(0, 9, 40).astype(np.int32)
    valid = rng.random(40) < 0.7
    ei[3], valid[3] = 99, False        # padding lane past the edge
    want = np.asarray(j_build(jnp.asarray(ei), jnp.asarray(ej),
                              jnp.asarray(valid), 12, 9))
    got = build_biadjacency(torch.from_numpy(ei), torch.from_numpy(ej),
                            torch.from_numpy(valid), 12, 9)
    np.testing.assert_array_equal(got.numpy(), want)
    stacked = build_biadjacency(torch.from_numpy(np.stack([ei, ej])),
                                torch.from_numpy(np.stack([ej, ei]) % 9),
                                torch.from_numpy(np.stack([valid, valid])),
                                12, 9)
    assert stacked.shape == (2, 12, 9) and stacked.is_contiguous()
    np.testing.assert_array_equal(stacked[0].numpy(), want)
