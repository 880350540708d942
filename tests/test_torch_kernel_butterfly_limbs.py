"""K2's uint8 limb planes, its exact arithmetic and its overflow guard, on
the CPU.

K2 reads net multiplicities as uint8 limb planes (``A = sum_p 256^p a_p``,
``A∘A = sum_p 256^p x_p``), computes the Grams ``W`` and ``S`` exactly,
applies the reference's float32 epilogue ``(w * w - s) * 0.5`` per entry
and sums the per-entry values exactly.  These tests hold the limb scatter
and split, the limb-count rule, the plain version (which the wrapper runs
on CPU tensors) and the pallas tier's multiset path to exact integer
arithmetic and to the reference (its Pallas kernel in interpret mode, as
its own tests run it).
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.executor as jex  # noqa: E402
import repro.core.windows as jwin  # noqa: E402
from repro.kernels.butterfly.butterfly_kernel import (  # noqa: E402
    butterfly_pairs_windows_kernel_multiset_call as j_k2,
)
import repro_torch.core.executor as tex  # noqa: E402
from repro_torch.core import windows as twin  # noqa: E402
from repro_torch.core.butterfly import (  # noqa: E402
    build_biadjacency_limbs,
    build_biadjacency_multiset,
    count_butterflies_multiset_np,
    join_limbs,
    limb_block_masks,
    n_limbs,
    split_limbs,
)
from repro_torch.kernels.butterfly import butterfly_kernel as kk  # noqa: E402
from repro_torch.kernels.butterfly import ops  # noqa: E402

# (multiplicity, lw, ls): the limbs A and A∘A need at each byte edge
EDGES = [(1, 1, 1), (15, 1, 1), (16, 1, 2), (255, 1, 2), (256, 2, 3),
         (1352, 2, 3), (4095, 2, 3), (4096, 2, 4), (65535, 2, 4)]


def weighted(b, n, k, density, max_mult, seed):
    """``[b, n, k]`` float32 net multiplicities in ``[1, max_mult]``."""
    rng = np.random.default_rng(seed)
    present = rng.random((b, n, k)) < density
    return (present * rng.integers(1, max_mult + 1, (b, n, k))
            ).astype(np.float32)


def lanes_of(a):
    """A ``[b, n_i, n_j]`` weighted stack -> its lanes ``(edge_i, edge_j,
    mult, valid)``, ``[b, cap]``, one distinct edge per valid lane, with a
    few invalid lanes of garbage at the end."""
    b = a.shape[0]
    nz = [np.argwhere(a[w] > 0) for w in range(b)]
    cap = max(len(e) for e in nz) + 3
    ei = np.full((b, cap), 7, np.int32)
    ej = np.full((b, cap), 5, np.int32)
    mm = np.full((b, cap), 99, np.int32)
    valid = np.zeros((b, cap), bool)
    for w, e in enumerate(nz):
        ei[w, :len(e)], ej[w, :len(e)] = e[:, 0], e[:, 1]
        mm[w, :len(e)] = a[w][e[:, 0], e[:, 1]]
        valid[w, :len(e)] = True
    return [torch.from_numpy(x) for x in (ei, ej, mm, valid)]


def rounded(x: int) -> np.float32:
    """The float32 nearest the integer ``x`` (ties to even), by exact
    rational comparison."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - x) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - x) == best]
    if len(near) == 1:
        return near[0]
    return next(c for c in near if c.view(np.int32) % 2 == 0)


def exact_partials(a, block_i):
    """The partials by integer arithmetic: W and S as Python ints, the
    reference's float32 ``w * w - s`` per entry (twice its value), summed
    per tile pair as Python ints, rounded once to float32, halved."""
    b, n, _ = a.shape
    nu = -(-n // block_i)
    u, v = np.triu_indices(nu)
    out = np.zeros((b, len(u)), dtype=np.float32)
    for w_ in range(b):
        ai = a[w_].astype(np.int64)
        w = ai @ ai.T
        s = (ai * ai) @ (ai * ai).T
        wf = w.astype(np.float32)
        twice = np.triu((wf * wf - s.astype(np.float32)).astype(np.int64), 1)
        for t, (uu, vv) in enumerate(zip(u, v)):
            tot = sum(int(x) for x in twice[uu * block_i:(uu + 1) * block_i,
                                            vv * block_i:(vv + 1) * block_i
                                            ].ravel())
            out[w_, t] = rounded(tot) * np.float32(0.5)
    return out


@pytest.mark.parametrize("mult,lw,ls", EDGES)
def test_limb_planes_recompose_the_stack_and_the_count_rule(mult, lw, ls):
    assert (n_limbs(mult), n_limbs(mult * mult)) == (lw, ls)
    assert kk.stack_limbs(mult) == (lw, ls)
    a = weighted(2, 90, 37, 0.3, 8, seed=mult)
    a[0, 3, 5] = mult                       # one edge at the edge of a limb
    a[1, 89, 36] = mult - 1
    lanes = lanes_of(a)
    planes, masks = build_biadjacency_limbs(*lanes, 90, 37, lw, ls)
    assert planes.dtype == torch.uint8 and planes.shape == (2, lw + ls, 90, 48)
    assert not planes[..., 37:].any()
    want = build_biadjacency_multiset(*lanes, 90, 37)
    m = join_limbs(planes, lw)
    assert torch.equal(m[..., :37], want.long())
    x = sum(planes[:, lw + p].long() << (8 * p) for p in range(ls))
    assert torch.equal(x[..., :37], want.long() ** 2)
    assert torch.equal(split_limbs(want, lw, ls), planes)
    # the masks: the planes each 64-row block holds, from the lanes alone
    assert masks.dtype == torch.int32 and masks.shape == (2, 2)
    assert torch.equal(masks, limb_block_masks(planes))
    top = sum(1 << p for p in range(lw) if (mult >> (8 * p)) & 255)
    top |= sum(1 << (lw + p) for p in range(ls)
               if (mult * mult >> (8 * p)) & 255)
    assert int(masks[0, 0]) & top == top    # the nonzero limbs of row 3
    # the oriented twin puts the smaller side (37) on the rows
    o_planes, o_masks = ops.oriented_biadjacency_limbs(*lanes, 90, 37, lw, ls)
    assert o_planes.shape == (2, lw + ls, 37, 96) and o_masks.shape == (2, 1)
    assert torch.equal(join_limbs(o_planes, lw)[..., :90],
                       want.long().transpose(1, 2))
    assert torch.equal(o_masks, limb_block_masks(o_planes))


def test_block_masks_mark_the_planes_each_64_rows_hold():
    a = np.zeros((2, 150, 40), np.float32)
    a[0, 5, 1] = 1          # block 0: a_0, x_0
    a[0, 70, 2] = 20        # block 1: a_0, x_0, x_1 (400 = 0x190)
    a[0, 149, 3] = 300      # block 2: every plane (90000 = 0x15F90)
    a[1, 64, 0] = 256       # block 1: a_1 and x_2 only (65536 = 0x10000)
    planes, masks = build_biadjacency_limbs(*lanes_of(a), 150, 40, 2, 3)
    # bits: a_0 1, a_1 2, x_0 4, x_1 8, x_2 16
    assert masks.tolist() == [[1 | 4, 1 | 4 | 8, 31], [0, 2 | 16, 0]]
    assert torch.equal(limb_block_masks(planes), masks)
    assert limb_block_masks(planes[..., :0]).abs().sum() == 0


@pytest.mark.parametrize("b,n,k,block_i,density,max_mult", [
    (2, 16, 48, 8, 0.3, 8),
    (3, 37, 41, 16, 0.2, 300),          # ragged rows, W^2 and S past 2**24
    (2, 64, 128, 32, 0.1, 4000),        # four limbs of A∘A
    (3, 24, 20, 8, 0.0, 5),             # empty windows
])
def test_plain_on_limbs_equals_plain_on_float32(b, n, k, block_i, density,
                                                max_mult):
    a = weighted(b, n, k, density, max_mult, seed=n * k)
    f32 = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(a),
                                                    block_i=block_i)
    lw, ls = kk.stack_limbs(int(a.max()))
    for extra in (0, 1):                 # spare zero planes change nothing
        planes = split_limbs(torch.from_numpy(a), lw, ls + extra)
        got = kk.butterfly_pairs_windows_multiset_plain(planes,
                                                        block_i=block_i, lw=lw)
        assert torch.equal(got, f32)
        assert torch.equal(kk.butterfly_pairs_windows_multiset_limbs_call(
            planes, limb_block_masks(planes), lw=lw, block_i=block_i), f32)
    np.testing.assert_array_equal(f32.numpy(), exact_partials(a, block_i))


@pytest.mark.parametrize("b,n,k,block_i,block_k,density,max_mult", [
    (2, 16, 128, 8, 128, 0.3, 8),
    (3, 32, 256, 16, 128, 0.2, 8),
    (1, 64, 128, 32, 128, 0.5, 3),
    (2, 32, 128, 16, 128, 0.05, 20),
])
def test_plain_equals_reference_exactly_below_2_24(b, n, k, block_i, block_k,
                                                   density, max_mult):
    a = weighted(b, n, k, density, max_mult, seed=n * k + max_mult)
    want = np.asarray(j_k2(jnp.asarray(a), block_i=block_i, block_k=block_k,
                           interpret=True))
    assert want.max() < 2**24
    got = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(a),
                                                    block_i=block_i)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_mult,seed", [(300, 9), (1000, 4), (1352, 5)])
def test_plain_within_1e5_of_reference_past_2_24(max_mult, seed):
    """Past 2**24 the reference's float32 Grams round in the MXU's order
    and the plain version's are exact: they agree within rtol 1e-5."""
    a = weighted(2, 32, 256, 0.3, max_mult, seed=seed)
    want = np.asarray(j_k2(jnp.asarray(a), block_i=16, block_k=128,
                           interpret=True))
    assert want.max() > 2**24
    got = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(a),
                                                    block_i=16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("perm", [(2, 0, 1), (1, 2, 0), (2, 1, 0)])
def test_partials_do_not_depend_on_the_tile_order(perm):
    """Permuting whole row tiles of A permutes the tile pairs; a pair that
    crosses the diagonal is then summed as the transposed block, in another
    order.  The exact sums give the same bits, past 2**24 too."""
    bi = 16
    a = weighted(1, 3 * bi, 512, 0.4, 900, seed=8)
    moved = a.reshape(1, 3, bi, -1)[:, list(perm)].reshape(a.shape)
    got = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(moved),
                                                    block_i=bi)
    base = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(a),
                                                     block_i=bi)
    assert float(base.max()) > 2**24
    u, v = kk.triangle_pairs(3)
    index = {(int(x), int(y)): t for t, (x, y) in enumerate(zip(u, v))}
    for (x, y), t in index.items():
        px, py = sorted((perm[x], perm[y]))
        assert got[0, t].item() == base[0, index[(px, py)]].item()


@pytest.mark.parametrize("hi,lo", [
    (0, 5), (3, 2**32 + 7), (-1, 2**32 - 1), (2**31 - 1, 2**32 - 1),
    (2**31, 1), (2**40 + 3, 2**31), (-2**31 - 1, 0), (-(2**45) + 5, 12345),
    (2**52 + 1, 2**33 + 1), (12345678901, 0),
])
def test_split_sums_round_once_to_nearest(hi, lo):
    got = kk.round_split_sums(torch.tensor([hi]), torch.tensor([lo]))
    assert got.dtype == torch.float32
    assert got.item() == rounded(hi * 2**32 + lo)


def test_sums_past_2_64_are_exact():
    """Dense windows of equal multiplicities: partials past 2**24, and
    past 2**64, are still the exact sums rounded once."""
    a = np.full((1, 32, 4096), 16.0, np.float32)
    got = kk.butterfly_pairs_windows_multiset_plain(torch.from_numpy(a),
                                                    block_i=16)
    np.testing.assert_array_equal(got.numpy(), exact_partials(a, 16))
    big = torch.full((1, 256, 1024), 256.0)
    w, s = 1024 * 256**2, 1024 * 256**4
    twice = int(np.float32(w) * np.float32(w) - np.float32(s))
    got = kk.butterfly_pairs_windows_multiset_plain(big, block_i=256)
    assert got.item() == rounded(256 * 255 // 2 * twice) * np.float32(0.5)
    assert got.item() > 2**64


def test_overflow_guard_raises_with_its_message():
    a = torch.zeros((2, 4, 64))
    a[1, 2, 3] = 46341.0                       # one edge: 46341**2 > 2**31
    with pytest.raises(ValueError, match=r"2\*\*31"):
        kk.butterfly_pairs_windows_kernel_multiset_call(a, block_i=8)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        ops.butterfly_count_pallas_windows_multiset(a, block_i=8)
    a[1, 2, 3] = 46340.0
    assert kk.butterfly_pairs_windows_kernel_multiset_call(
        a, block_i=8).abs().sum() == 0
    # the bound is per vertex, on either side: many edges at one column
    b = torch.zeros((1, 64, 8))
    b[0, :, 0] = 6000.0                        # 64 * 6000**2 > 2**31
    with pytest.raises(ValueError, match="one vertex|a vertex"):
        kk.butterfly_pairs_windows_multiset_plain(b, block_i=8)
    planes = split_limbs(b, 2, 4)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        kk.butterfly_pairs_windows_multiset_plain(planes, block_i=8, lw=2)
    lanes = lanes_of(b.numpy())
    with pytest.raises(ValueError, match=r"2\*\*31"):
        ops.butterfly_count_pallas_windows_multiset_lanes(
            *lanes, 64, 8, max_mult=6000, max_vertex_sq=64 * 6000**2,
            block_i=8)
    with pytest.raises(ValueError, match="non-negative integers"):
        kk.butterfly_pairs_windows_kernel_multiset_call(
            torch.full((1, 4, 4), 1.5), block_i=8)
    with pytest.raises(ValueError, match="non-negative integers"):
        kk.butterfly_pairs_windows_kernel_multiset_call(
            torch.full((1, 4, 4), -2.0), block_i=8)


@pytest.mark.parametrize("n_i,n_j", [(40, 24), (24, 40)])
def test_lane_entry_equals_float32_entry(n_i, n_j):
    a = weighted(3, n_i, n_j, 0.3, 2000, seed=n_i)
    a[2] = 0                                      # an empty window
    lanes = lanes_of(a)
    m = np.where(lanes[3].numpy(), lanes[2].numpy(), 0).astype(np.int64)
    got = ops.butterfly_count_pallas_windows_multiset_lanes(
        *lanes, n_i, n_j, max_mult=int(m.max()),
        max_vertex_sq=kk.vertex_sq(torch.from_numpy(a)), block_i=16)
    want = ops.butterfly_count_pallas_windows_multiset(torch.from_numpy(a),
                                                       block_i=16)
    assert torch.equal(got, want)
    assert got[2].item() == 0


def test_mult_range_bounds_every_vertex():
    """The executor's host bound is the largest sum of squared
    multiplicities at one vertex of either side, per window."""
    edges, mults = multiset_windows()
    tb = pack(twin, edges, mults)
    ex = tex.WindowExecutor("pallas", device="cpu", align=8)
    for b in ex.plan(tb):
        top, vsq = tex._mult_range(tb, b)
        want_vsq = 0
        for k in b.windows:
            e, m = edges[k], mults[k].astype(np.int64)
            for side in (0, 1):
                for vert in np.unique(e[:, side]):
                    want_vsq = max(want_vsq, int((m[e[:, side] == vert] ** 2
                                                  ).sum()))
        assert top == max(int(mults[k].max()) for k in b.windows)
        assert vsq == want_vsq


def multiset_windows(hub_joins: bool = True):
    """Three multiset windows of distinct edges; window 1 has a hub edge
    (0, 0) repeated 1,234 times.  With ``hub_joins`` its row and column
    carry edges of multiplicity 1-3, so the hub sits in butterflies and
    W^2 and S pass 10**6 on its pairs; without, it is the only edge at
    either end, and every float32 step of every tier stays exact."""
    rng = np.random.default_rng(21)
    edges, mults = [], []
    for w in range(3):
        raw = np.stack([rng.integers(0, 30, 160), rng.integers(0, 25, 160)], 1)
        if w == 1:
            if hub_joins:
                raw = np.concatenate([[[i, 0] for i in range(1, 30)],
                                      [[0, j] for j in range(1, 25)], raw])
            else:
                raw = raw[(raw[:, 0] != 0) & (raw[:, 1] != 0)]
            raw = np.concatenate([[[0, 0]], raw])
        e, first = np.unique(raw, axis=0, return_index=True)
        m = rng.integers(1, 4, len(e))
        if w == 1:
            m[first == 0] = 1234                # the hub edge (0, 0)
        edges.append(e)
        mults.append(m)
    return edges, mults


def pack(mod, edges, mults):
    n = len(edges)
    return mod.pack_windows(
        edges, n_sgrs=np.array([len(e) for e in edges]),
        cum_sgrs=np.cumsum([len(e) for e in edges]),
        window_end_tau=np.arange(n, dtype=np.float64), align=8,
        dedupe=False, per_window_mult=mults)


@pytest.mark.parametrize("hub_joins", [False, True])
def test_pallas_multiset_path_equals_dense_and_the_reference_executor(
        hub_joins):
    """The pallas tier's multiset path equals the reference executor's
    pallas tier (its Pallas kernel in interpret mode) and the int64 oracle
    exactly, and the dense tier wherever the dense tier is exact.  Where
    the hub sits in butterflies, the dense tier's whole-matrix float32 sum
    takes the hub's diagonal term past 2**24, so it is held within rtol
    1e-5 (the reference's own dense tier is off by as much)."""
    edges, mults = multiset_windows(hub_joins)
    assert max(m.max() for m in mults) > 1000
    tb, jb = pack(twin, edges, mults), pack(jwin, edges, mults)
    oracle = [count_butterflies_multiset_np(e, m) for e, m in zip(edges, mults)]
    assert max(oracle) < 2**24
    kk.reset_launch_count()
    got = tex.WindowExecutor("pallas", device="cpu", align=8).window_counts(tb)
    assert kk.launch_count("K2") == 0          # CPU tensors: the plain version
    dense = tex.WindowExecutor("dense", device="cpu",
                               align=8).window_counts(tb)
    ref = jex.WindowExecutor("pallas", align=8).window_counts(jb)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, oracle)
    if hub_joins:
        assert oracle[1] > oracle[0] + 10**6       # the hub's butterflies
        np.testing.assert_allclose(dense, got, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(dense, got)
