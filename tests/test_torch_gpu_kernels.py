"""K1, K2, K3 and K4 on the card against their plain torch versions (marked
``gpu``).

Run on a machine with a CUDA device:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_kernels.py -q

Elsewhere every test skips; whether a card is present is decided inside the
``cuda`` fixture, never while the module is imported.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.butterfly import count_butterflies_np  # noqa: E402
from repro_torch.core.executor import WindowExecutor  # noqa: E402
from repro_torch.core.windows import windowize  # noqa: E402
from repro_torch.kernels.butterfly import butterfly_kernel as k1  # noqa: E402
from repro_torch.kernels.butterfly import ops  # noqa: E402
from repro_torch.kernels.butterfly.ops import (  # noqa: E402
    butterfly_count_pallas_windows,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1, K2, K3 and K4 are CUDA kernels "
                    "with no CPU mode")
    return torch.device("cuda")


def stack(b, n, k, density, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((b, n, k)) < density).astype(np.float32))


@pytest.mark.parametrize("b,n,k,block_i,density", [
    (1, 8, 8, 8, 0.5),
    (3, 37, 41, 8, 0.3),        # ragged rows and columns
    (2, 130, 300, 64, 0.1),     # several tiles, ragged last tile
    (4, 256, 512, 256, 0.05),   # exactly one tile
    (2, 300, 129, 256, 0.2),    # ragged second tile, short contraction
    (1, 513, 700, 128, 0.02),   # tile pairs across 128-row sub-tiles
    (5, 40, 0, 8, 0.0),         # empty contraction
])
def test_kernel_partials_equal_plain(cuda, b, n, k, block_i, density):
    a = stack(b, n, k, density, seed=n + k).to(cuda)
    got = k1.butterfly_pairs_windows_kernel_call(a, block_i=block_i)
    torch.cuda.synchronize()
    want = k1.butterfly_pairs_windows_plain(a, block_i=block_i)
    assert got.shape == want.shape == (b, k1.n_tile_pairs(n, block_i))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_above_2_24_within_rtol(cuda):
    """Partials past 2**24 round in float32 in any summation order: the
    kernel is held to the float64 plain version within rtol 1e-5."""
    a = stack(2, 512, 2048, 0.3, seed=7).to(cuda)
    got = k1.butterfly_pairs_windows_kernel_call(a, block_i=256).double()
    want = k1.butterfly_pairs_windows_plain(a, block_i=256,
                                            dtype=torch.float64)
    assert float(want.max()) > 2**24
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


def test_launch_counter_counts_launches_only(cuda):
    k1.reset_launch_count()
    a = stack(2, 20, 30, 0.3, seed=1)
    k1.butterfly_pairs_windows_kernel_call(a, block_i=8)        # CPU: plain
    assert k1.launch_count() == 0
    k1.butterfly_pairs_windows_kernel_call(a.to(cuda), block_i=8)
    k1.butterfly_pairs_windows_kernel_call(a[:0].to(cuda), block_i=8)
    assert k1.launch_count() == 1


def test_kernel_rejects_non_contiguous(cuda):
    a = stack(2, 20, 30, 0.3, seed=1).to(cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        k1.butterfly_pairs_windows_kernel_call(a, block_i=8)


K1_BLOCKS = (1, 8, 64, 96, 256, 300)


@pytest.mark.parametrize("block_i", K1_BLOCKS)
@pytest.mark.parametrize("dtype,route", [
    (torch.uint8, "wgmma"), (torch.float32, "wgmma_padded")],
    ids=["uint8", "float32"])
@pytest.mark.parametrize("b,n,k,density", [
    (3, 37, 48, 0.3),           # n below 64, k not a multiple of 32
    (2, 300, 160, 0.1),         # n not a multiple of the 128 x 256 tile
    (1, 513, 704, 0.05),        # tiles across the diagonal, several slices
    (5, 40, 0, 0.0),            # empty contraction
    (2000, 20, 32, 0.3),        # thousands of windows
])
def test_k1_equals_plain_exactly_on_both_routes(cuda, block_i, dtype, route,
                                                b, n, k, density):
    a = stack(b, n, k, density, seed=n + k).to(dtype).to(cuda)
    k1.reset_launch_count()
    got = k1.butterfly_pairs_windows_kernel_call(a, block_i=block_i)
    torch.cuda.synchronize()
    assert k1.launch_count("K1", route) == 1 == k1.launch_count("K1")
    want = k1.butterfly_pairs_windows_plain(a, block_i=block_i)
    assert got.shape == want.shape == (b, k1.n_tile_pairs(n, block_i))
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [37, 129, 1000])
def test_k1_padded_copy_of_odd_uint8_rows(cuda, k):
    a = stack(2, 150, k, 0.2, seed=k).to(torch.uint8).to(cuda)
    assert not k1.tma_ready(a)
    k1.reset_launch_count()
    got = k1.butterfly_pairs_windows_kernel_call(a, block_i=64)
    torch.cuda.synchronize()
    assert k1.launch_count("K1", "wgmma_padded") == 1
    assert torch.equal(got, k1.butterfly_pairs_windows_plain(a, block_i=64))


@pytest.mark.parametrize("block_i", [256, 300])
def test_k3_at_its_main_shape_equals_plain(cuda, block_i):
    """One window at about K3's shape on the smoke stream, float32 as the
    single-matrix entries hand it (the padded copy)."""
    a = stack(1, 3969, 5389, 0.002, seed=1)[0].to(cuda)
    k1.reset_launch_count()
    got = k1.butterfly_pairs_kernel_call(a, block_i=block_i)
    torch.cuda.synchronize()
    assert k1.launch_count("K3", "wgmma_padded") == 1
    assert k1.launch_count("K1") == 0
    assert torch.equal(got, k1.butterfly_pairs_plain(a, block_i=block_i))


def test_k1_past_2_24_exact_and_within_1e5_of_float64(cuda):
    a = stack(2, 512, 2048, 0.3, seed=7).to(torch.uint8).to(cuda)
    got = k1.butterfly_pairs_windows_kernel_call(a, block_i=256)
    want = k1.butterfly_pairs_windows_plain(a, block_i=256)
    want64 = k1.butterfly_pairs_windows_plain(a, block_i=256,
                                              dtype=torch.float64)
    assert float(want64.max()) > 2**24
    assert torch.equal(got, want)
    torch.testing.assert_close(got.double(), want64, rtol=1e-5, atol=0)


def test_k1_window_partials_do_not_depend_on_the_stack(cuda):
    a = stack(6, 400, 512, 0.4, seed=3).to(torch.uint8).to(cuda)
    whole = k1.butterfly_pairs_windows_kernel_call(a, block_i=96)
    assert float(whole.max()) > 2**24
    for lo, hi in ((0, 1), (2, 5), (5, 6)):
        part = k1.butterfly_pairs_windows_kernel_call(a[lo:hi], block_i=96)
        assert torch.equal(part, whole[lo:hi])


def test_k1_rejects_what_it_does_not_take(cuda):
    k1.reset_launch_count()
    with pytest.raises(ValueError, match="contiguous"):
        k1.butterfly_pairs_windows_kernel_call(
            torch.zeros((2, 32, 20), dtype=torch.uint8,
                        device=cuda).transpose(1, 2), block_i=8)
    with pytest.raises(ValueError, match="limits"):
        k1.butterfly_pairs_windows_kernel_call(
            torch.zeros((65536, 1, 16), dtype=torch.uint8, device=cuda),
            block_i=8)
    with pytest.raises(ValueError, match="uint8 or float32"):
        k1.butterfly_pairs_windows_kernel_call(
            torch.zeros((1, 8, 16), dtype=torch.int8, device=cuda), block_i=8)
    assert k1.launch_count("K1") == 0


def test_ops_counts_equal_oracle(cuda):
    a = stack(3, 70, 45, 0.2, seed=3)
    got = butterfly_count_pallas_windows(a.to(cuda), block_i=16).cpu()
    for w in range(3):
        ii, jj = np.nonzero(a[w].numpy())
        assert float(got[w]) == count_butterflies_np(np.stack([ii, jj], 1))


@pytest.mark.parametrize("tier", ["dense", "tiled", "pallas", "sparse",
                                  "auto"])
def test_executor_tiers_equal_oracle_on_cuda(cuda, tier):
    from repro_torch.streams import bipartite_pa_stream

    s = bipartite_pa_stream(20000, n_unique=4000, seed=5)
    wb = windowize(s.tau, s.edge_i, s.edge_j, 200)
    got = WindowExecutor(tier, device=cuda, chunk=3).window_counts(wb)
    want = WindowExecutor("numpy", device="cpu").window_counts(wb)
    np.testing.assert_array_equal(got, want)


def weighted(b, n, k, density, max_mult, seed):
    rng = np.random.default_rng(seed)
    present = rng.random((b, n, k)) < density
    return torch.from_numpy((present * rng.integers(1, max_mult + 1, (b, n, k))
                             ).astype(np.float32))


@pytest.mark.parametrize("b,n,k,block_i,density", [
    (1, 8, 8, 8, 0.5),
    (3, 37, 41, 8, 0.3),        # ragged rows and columns
    (2, 130, 90, 64, 0.1),      # several tiles, ragged last tile
    (1, 200, 64, 136, 0.1),     # tile pairs across 64-column sub-tiles
    (5, 40, 0, 8, 0.0),         # empty contraction
])
def test_k2_partials_equal_plain_at_small_multiplicities(cuda, b, n, k,
                                                         block_i, density):
    a = weighted(b, n, k, density, 8, seed=n + k).to(cuda)
    want = k1.butterfly_pairs_windows_multiset_plain(a, block_i=block_i,
                                                     dtype=torch.float64)
    if want.numel():
        assert float(want.max()) < 2**24
    got = k1.butterfly_pairs_windows_kernel_multiset_call(a, block_i=block_i)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), want, rtol=0, atol=0)
    # and bit for bit the plain version of its own arithmetic
    assert torch.equal(got, k1.butterfly_pairs_windows_multiset_plain(
        a, block_i=block_i))


def test_k2_past_2_24_within_rtol(cuda):
    """Multiplicities up to 1000 put W^2 and S far past 2**24: K2 is held
    to the float64 plain version within rtol 1e-5 per partial."""
    a = weighted(2, 512, 2048, 0.05, 1000, seed=7).to(cuda)
    got = k1.butterfly_pairs_windows_kernel_multiset_call(a, block_i=256)
    want = k1.butterfly_pairs_windows_multiset_plain(a, block_i=256,
                                                     dtype=torch.float64)
    assert float(want.max()) > 2**24
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=0)


def test_k2_equals_plain_bit_for_bit_past_2_24(cuda):
    """Past 2**24 too, K2 and its plain version compute the same exact
    Grams, float32 epilogue and exact sums: the same bits."""
    a = weighted(2, 512, 2048, 0.05, 1000, seed=7).to(cuda)
    got = k1.butterfly_pairs_windows_kernel_multiset_call(a, block_i=256)
    torch.cuda.synchronize()
    want = k1.butterfly_pairs_windows_multiset_plain(a, block_i=256)
    assert float(want.max()) > 2**24
    assert torch.equal(got, want)


@pytest.mark.parametrize("value,shape", [(16.0, (1, 32, 4096)),
                                         (256.0, (1, 256, 32768)),
                                         (255.0, (2, 300, 24576))])
def test_k2_exact_sums_past_2_64(cuda, value, shape):
    """Dense windows of equal multiplicities, up to every vertex at K2's
    limit: partials up to about 2**76, the split sums rounded once."""
    a = torch.full(shape, value, device=cuda)
    got = k1.butterfly_pairs_windows_kernel_multiset_call(a, block_i=256)
    torch.cuda.synchronize()
    assert torch.equal(got, k1.butterfly_pairs_windows_multiset_plain(
        a, block_i=256))


@pytest.mark.parametrize("n_i,n_j", [(300, 700), (700, 300)])
def test_k2_limb_route_equals_copy_route_and_both_are_counted(cuda, n_i, n_j):
    a = weighted(3, n_i, n_j, 0.05, 1352, seed=n_i)
    a[1] = 0                                       # an all-zero window
    nz = [torch.nonzero(a[w]) for w in range(3)]
    cap = max(len(e) for e in nz)
    lanes = [torch.zeros((3, cap), dtype=torch.int32) for _ in range(3)]
    valid = torch.zeros((3, cap), dtype=torch.bool)
    for w, e in enumerate(nz):
        lanes[0][w, :len(e)], lanes[1][w, :len(e)] = e[:, 0], e[:, 1]
        lanes[2][w, :len(e)] = a[w][e[:, 0], e[:, 1]].int()
        valid[w, :len(e)] = True
    k1.reset_launch_count()
    got = ops.butterfly_count_pallas_windows_multiset_lanes(
        *(x.to(cuda) for x in (*lanes, valid)), n_i, n_j,
        max_mult=int(a.max()), max_vertex_sq=k1.vertex_sq(a), block_i=256)
    want = ops.butterfly_count_pallas_windows_multiset(a.to(cuda),
                                                       block_i=256)
    assert torch.equal(got, want)
    assert float(got[1]) == 0.0
    assert (k1.launch_count("K2", "wgmma_limbs"),
            k1.launch_count("K2", "wgmma_limbs_copy"),
            k1.launch_count("K2")) == (1, 1, 2)


def test_k2_window_counts_do_not_depend_on_the_stack(cuda):
    a = weighted(6, 300, 700, 0.1, 500, seed=3).to(cuda)
    whole = ops.butterfly_count_pallas_windows_multiset(a, block_i=256)
    assert float(whole.max()) > 2**24
    for w in range(6):
        one = ops.butterfly_count_pallas_windows_multiset(a[w:w + 1],
                                                          block_i=256)
        assert torch.equal(one[0], whole[w])


def test_k2_and_k3_count_their_own_launches(cuda):
    k1.reset_launch_count()
    a = weighted(2, 20, 30, 0.3, 4, seed=1)
    k1.butterfly_pairs_windows_kernel_multiset_call(a, block_i=8)  # CPU
    k1.butterfly_pairs_kernel_call(a[0], block_i=8)                # CPU
    assert k1.launch_count("K2") == k1.launch_count("K3") == 0
    k1.butterfly_pairs_windows_kernel_multiset_call(a.to(cuda), block_i=8)
    ops.butterfly_count_pallas((a[0] > 0).float().to(cuda), block_i=8)
    assert (k1.launch_count("K1"), k1.launch_count("K2"),
            k1.launch_count("K3")) == (0, 1, 1)


def test_k3_entries_equal_plain(cuda):
    a = (stack(1, 90, 130, 0.2, seed=5)[0]).to(cuda)
    want = float(k1.butterfly_pairs_plain(a.cpu(), block_i=64).double().sum())
    assert float(ops.butterfly_count_pallas(a, block_i=64)) == want
    assert ops.butterfly_count_tiles(a, block_i=64) == want
    assert ops.butterfly_count_tiles(a.cpu().numpy(), block_i=64) == want


@pytest.mark.parametrize("tier", ["dense", "pallas", "sparse"])
def test_multiset_executor_equals_oracle_on_cuda(cuda, tier):
    from repro_torch.core.windows import pack_windows

    rng = np.random.default_rng(9)
    edges, mults = [], []
    for _ in range(7):
        e = np.unique(np.stack([rng.integers(0, 50, 400),
                                rng.integers(0, 40, 400)], 1), axis=0)
        edges.append(e)
        mults.append(rng.integers(1, 9, len(e)))
    n = len(edges)
    batch = pack_windows(edges, n_sgrs=np.full(n, 400),
                         cum_sgrs=400 * np.arange(1, n + 1),
                         window_end_tau=np.arange(n, dtype=np.float64),
                         dedupe=False, per_window_mult=mults)
    got = WindowExecutor(tier, device=cuda, chunk=3).window_counts(batch)
    want = WindowExecutor("numpy", device="cpu").window_counts(batch)
    assert want.max() < 2**24
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# K4: the flash-attention kernel
# --------------------------------------------------------------------------

def qkv(b, sq, skv, h, hkv, hd, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype) for shape in (
        (b, sq, h, hd), (b, skv, hkv, hd), (b, skv, hkv, hd))]


K4_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,b,sq,skv,h,hkv,hd,q_offset", [
    (True, 2, 128, 128, 4, 2, 32, 0),
    (False, 1, 96, 200, 2, 1, 64, 0),       # cross lengths, ragged kv
    (True, 2, 100, 300, 6, 2, 128, 200),    # a later chunk, ragged q
    (True, 1, 64, 64, 3, 3, 8, 0),          # hd below a 16-byte vector
    (True, 1, 70, 70, 2, 2, 20, 0),         # hd not a multiple of 8
])
def test_k4_equals_plain(cuda, dtype, causal, b, sq, skv, h, hkv, hd, q_offset):
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    q, k, v = (t.to(cuda) for t in qkv(b, sq, skv, h, hkv, hd, dtype, sq + hd))
    got = k4.flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset)
    want = k4.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, sq, h, hd)
    torch.testing.assert_close(got.float(), want.float(), **K4_TOL[dtype])


@pytest.mark.parametrize("causal,b,sq,skv,h,hkv,hd,q_offset", [
    (True, 2, 256, 256, 6, 2, 128, 0),
    (True, 1, 100, 300, 4, 2, 64, 200),     # a later chunk, ragged q
    (False, 1, 96, 200, 2, 1, 32, 0),
])
def test_k4_bf16_is_the_rounding_of_float32(cuda, causal, b, sq, skv, h, hkv,
                                            hd, q_offset):
    """bf16 K4 within half a bf16 ulp (2**-8 of the value) plus the float32
    tolerance of the plain version's float32 output on the same inputs
    widened: K4 keeps P in fp32, as the reference does."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    q, k, v = (t.to(cuda) for t in qkv(b, sq, skv, h, hkv, hd, torch.bfloat16,
                                       sq + hd))
    got = k4.flash_attention_bshd(q, k, v, causal=causal, q_offset=q_offset)
    want = k4.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want, rtol=2.0**-8 + 2e-5,
                               atol=2e-5)


EDGES = (127, 128, 129, 191)


def hold_bf16(got, q, k, v, *, causal, q_offset):
    """bf16 K4 within one bf16 ulp of the plain version and within its
    rounding of the plain version's float32 output (the K4_ROUNDED of
    chip_smoke.py)."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    want = k4.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.bfloat16().float(),
                               **K4_TOL[torch.bfloat16])
    torch.testing.assert_close(got.float(), want, rtol=2.0**-8 + 2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("sq", EDGES)
@pytest.mark.parametrize("skv", EDGES)
def test_k4_bf16_tile_edges(cuda, sq, skv):
    """Lengths at the wgmma kernel's 128-row and 64-key tile edges, queries
    as the last ``sq`` positions of ``skv`` where they fit (a later chunk)."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    q_offset = max(0, skv - sq)
    q, k, v = (t.to(cuda) for t in qkv(2, sq, skv, 4, 2, 128, torch.bfloat16,
                                       sq * skv))
    k4.reset_launch_count()
    got = k4.flash_attention_bshd(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    assert k4.launch_count("wgmma") == 1
    hold_bf16(got, q, k, v, causal=True, q_offset=q_offset)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq,skv,q_offset", [
    (128, 165, 37),     # one 128-row tile across the diagonal, odd offset
    (256, 300, 44),     # two row tiles, the diagonal inside key tiles
])
def test_k4_bf16_diagonal_with_q_offset_through_tma(cuda, hd, sq, skv,
                                                    q_offset):
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    q, k, v = (t.to(cuda) for t in qkv(1, sq, skv, 6, 3, hd, torch.bfloat16,
                                       hd + q_offset))
    assert all(k4.tma_ready(t) for t in (q, k, v))
    k4.reset_launch_count()
    got = k4.flash_attention_bshd(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    assert k4.launch_count("wgmma") == 1
    hold_bf16(got, q, k, v, causal=True, q_offset=q_offset)


@pytest.mark.parametrize("view", ["stride", "base"])
def test_k4_bf16_view_that_breaks_tma_alignment(cuda, view):
    """A view whose head stride (68 bf16 = 136 bytes) or base (2 bytes
    past a 16-byte boundary, strides of 144 bytes) TMA cannot take reaches
    the kernel as a padded copy and gives what the contiguous tensors give,
    bit for bit."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    gen = torch.Generator().manual_seed(9)
    width = 68 if view == "stride" else 72
    wide = torch.randn((2, 150, 4 + 2 + 2, width), generator=gen).bfloat16().to(cuda)
    cut = wide[..., :64] if view == "stride" else wide[..., 1:65]
    q, k, v = cut[:, :, :4], cut[:, :, 4:6], cut[:, :, 6:]
    assert not any(k4.tma_ready(t) for t in (q, k, v))
    k4.reset_launch_count()
    got = k4.flash_attention_bshd(q, k, v, causal=True)
    want = k4.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert k4.launch_count("wgmma_padded") == 1
    assert k4.launch_count("wgmma") == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    hold_bf16(got, q, k, v, causal=True, q_offset=0)


def test_k4_reads_strided_heads_without_copies(cuda):
    """q, k and v as views into one fused projection (non-contiguous in
    every axis but the last) give the same result as contiguous copies."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    gen = torch.Generator().manual_seed(5)
    fused = torch.randn((2, 80, 4 + 2 + 2, 32), generator=gen).to(cuda)
    q, k, v = fused[:, :, :4], fused[:, :, 4:6], fused[:, :, 6:]
    got = k4.flash_attention_bshd(q, k, v, causal=True)
    want = k4.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,sq,skv,h,hkv,hd,hd_v,q_offset", [
    (2, 300, 300, 4, 4, 96, 64, 0),     # MiniCPM3's MLA head dims, ragged
    (1, 129, 191, 6, 3, 96, 64, 62),    # tile edges, a later chunk, GQA
    (1, 100, 100, 2, 2, 24, 16, 0),     # the MLA smoke config's head dims
    (1, 70, 140, 2, 1, 40, 128, 70),    # a value head wider than the query's
])
def test_k4_value_head_dim_equals_plain(cuda, dtype, b, sq, skv, h, hkv, hd,
                                        hd_v, q_offset):
    """K4 with a value head dim other than the query's (MLA) against its
    plain version at the caller's scale (the reference's float32
    1/sqrt(hd)), on the route the tensors call for: bf16 inputs with
    16-byte rows on ``wgmma`` as they lie, float32 on ``simt``; bf16 also
    within its rounding of the plain version's float32 output."""
    from repro_torch.kernels.flash_attention import flash_kernel as k4
    from repro_torch.models.transformer.attention import attention_scale

    gen = torch.Generator().manual_seed(hd * hd_v + sq)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(cuda)
               for shape in ((b, sq, h, hd), (b, skv, hkv, hd),
                             (b, skv, hkv, hd_v)))
    scale = attention_scale(hd)
    k4.reset_launch_count()
    got = k4.flash_attention_bshd(q, k, v, causal=True, q_offset=q_offset,
                                  scale=scale)
    torch.cuda.synchronize()
    route = "simt" if dtype == torch.float32 else "wgmma"
    assert k4.launch_count(route) == 1 == k4.launch_count()
    assert got.dtype == dtype and got.shape == (b, sq, h, hd_v)
    want = k4.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=True, q_offset=q_offset,
                                    scale=scale)
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               **K4_TOL[dtype])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want, rtol=2.0**-8 + 2e-5,
                                   atol=2e-5)


def test_k4_counts_launches_and_rejects(cuda):
    from repro_torch.kernels.flash_attention import flash_kernel as k4

    k4.reset_launch_count()
    q, k, v = qkv(1, 32, 32, 2, 2, 16, torch.float32, 1)
    k4.flash_attention_bshd(q, k, v)                       # CPU: plain
    assert k4.launch_count() == 0
    k4.flash_attention_bshd(q.to(cuda), k.to(cuda), v.to(cuda))
    assert k4.launch_count() == 1 == k4.launch_count("simt")
    with pytest.raises(ValueError, match="head dim up to 128"):
        big = torch.zeros((1, 8, 1, 160), device=cuda)
        k4.flash_attention_bshd(big, big, big)
    with pytest.raises(ValueError, match="head dim up to 128"):
        small = torch.zeros((1, 8, 1, 64), device=cuda)
        k4.flash_attention_bshd(small, small, torch.zeros((1, 8, 1, 160),
                                                          device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        half = torch.zeros((1, 8, 1, 16), device=cuda, dtype=torch.float16)
        k4.flash_attention_bshd(half, half, half)
    assert k4.launch_count() == 1


def test_prefill_on_cuda_equals_the_cpu_path(cuda):
    """The smoke phi4-mini in float32: prefill on the card (K4) against the
    same weights on the CPU (K4's plain version)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_kernel as k4
    from repro_torch.models.transformer import init_lm_params, prefill

    cfg = dataclasses.replace(get_arch("phi4-mini-3.8b").smoke_config(),
                              dtype="float32")
    model = init_lm_params(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 150)))
    want, cache = prefill(model, toks, cfg, 160)
    k4.reset_launch_count()
    got, gcache = prefill(model.to(cuda), toks.to(cuda), cfg, 160)
    assert k4.launch_count() == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gcache["k"].cpu(), cache["k"], rtol=1e-4,
                               atol=1e-4)
