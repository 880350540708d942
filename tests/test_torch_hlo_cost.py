"""The port's per-position cost model (``repro_torch.launch.hlo_cost``):
flops as the reference's ``analyze_hlo`` counts dots, collective bytes by
kind and position, and live bytes on known sequences of allocations."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed.collectives import (  # noqa: E402
    all_to_all,
    ring_pair_count,
)
from repro_torch.distributed.observe import (  # noqa: E402
    at_position,
    current_position,
    note_move,
)
from repro_torch.kernels.butterfly.butterfly_kernel import (  # noqa: E402
    k1_operations,
)
from repro_torch.kernels.butterfly.ops import (  # noqa: E402
    butterfly_count_pallas_windows,
)
from repro_torch.launch.hlo_cost import traced  # noqa: E402

META = torch.device("meta")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matmul_flops_are_two_m_n_k(device):
    a = torch.ones((6, 5), device=device)
    b = torch.ones((5, 7), device=device)
    x = torch.ones((3, 4, 5), device=device)
    y = torch.ones((3, 5, 2), device=device)
    with traced(2) as model:
        torch.matmul(a, b)
        with at_position(1):
            torch.bmm(x, y)
            torch.matmul(x, y)
        a + 1.0
    assert model.flops == [2 * 6 * 7 * 5, 2 * (2 * 3 * 4 * 2 * 5)]
    s = model.summary()
    assert s["busiest_position"] == 1 and s["flops"] == 2 * 3 * 4 * 2 * 5 * 2
    assert s["mesh"]["flops"] == sum(model.flops)
    assert s["n_ops"] >= 4


def test_bytes_are_operands_plus_results_and_views_are_free():
    a = torch.empty((10, 10), device=META)               # 400 bytes
    with traced(1) as model:
        v = a[:5]                                       # a view: nothing
        t = a.t()
        b = a * 2.0                                     # 400 in, 400 out
        b.add_(1.0)                                     # in place: 400 + 400
        torch.empty((100,), device=META)                # an allocation
    assert v.shape == (5, 10) and t.shape == (10, 10)
    assert model.bytes == [4 * 400]


def test_peak_of_a_known_sequence_of_allocations():
    with traced(2) as model:
        a = torch.zeros(100, device=META)               # 400 live at 0
        with at_position(1):
            b = torch.zeros(50, device=META)            # 200 live at 1
        c = torch.zeros(200, device=META)               # 400 + 800 at 0
        d = c[:10]                                      # a view: no bytes
        c.mul_(2.0)                                     # in place: no bytes
        del a                                           # 800 at 0
        e = torch.zeros(150, device=META)               # 800 + 600 at 0
        del c                                           # d keeps c alive
        f = d * 1.0                                     # + 40 at 0
    assert model.peaks() == [1400 + 40, 200]
    mem = model.memory([7, 9], (f, b))
    # position 0: temp without its output f; its arguments 7
    assert mem == {"argument_size_bytes": 7, "output_size_bytes": 40,
                   "temp_size_bytes": 1400, "generated_code_size_bytes": None,
                   "position": 0}
    del d, e
    assert model.peaks() == [1440, 200]   # a peak stays a peak


def test_peak_leaves_out_only_the_live_outputs():
    """A step's outputs are left out of the peak by their storages' keys;
    a storage freed earlier may have had one of those keys (an address
    reused), and it still counts while it lived."""
    with traced(1) as model:
        a = torch.zeros(100, device=META)               # 400 live
        key = a.untyped_storage()._cdata
        del a                                           # freed: 0 live
        b = torch.zeros(10, device=META)                # 40 live
    assert model.peaks() == [400]
    assert model.peaks({key}) == [400]
    assert model.peaks({b.untyped_storage()._cdata}) == [400]


def test_repeat_counts_the_work_since_a_mark_again():
    """``note_repeat``: the work since the last mark, flops, bytes, ops and
    live bytes, as if it ran twice more in a row; each repetition keeps
    what the traced one kept, so the peak rises with each."""
    from repro_torch.distributed.observe import note_repeat, note_stage

    w = torch.empty((4, 4), device=META)
    with traced(1) as model:
        note_stage("layer")
        kept = [w @ w]                                  # 64 B kept
        tmp = torch.zeros(32, device=META)              # 128 B, freed
        del tmp
        note_repeat("layer", 2)
    assert len(kept) == 1
    assert model.flops == [3 * 2 * 4 * 4 * 4]
    assert model.n_ops == 3 * 2
    assert model.live == [3 * 64]
    # the last repetition starts at 2 * 64 and rises by 64 + 128
    assert model.peaks() == [2 * 64 + 64 + 128]
    with pytest.raises(ValueError, match="not the last mark"):
        with traced(1) as again:
            note_stage("a")
            note_stage("b")
            note_repeat("a", 1)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_ring_collectives_are_the_half_rings_hops(n):
    """Each permute step moves every block one hop; the half ring runs
    n // 2 + 1 steps, so n // 2 permutes of n blocks in the wire dtype;
    the partials' sum moves n - 1 float32 scalars to the first."""
    rows, cols = 8, 24
    blocks = [torch.ones((rows, cols), device=META) for _ in range(n)]
    positions = [10 + k for k in range(n)]
    at = []

    def pair(mine, theirs, me, their, symmetric):
        at.append((current_position(), me))
        return (mine @ theirs.T).sum()

    with traced(10 + n) as model:
        ring_pair_count(blocks, [META] * n, pair, half_ring=True,
                        wire_dtype=torch.int8, positions=positions)
    assert all(p == positions[me] for p, me in at)
    hops = n // 2
    for k, p in enumerate(positions):
        got = model.collectives(p)
        assert got["collective-permute"] == hops * rows * cols
        assert got.get("all-reduce", 0) == (4 * (n - 1) if k == 0 else 0)
    mesh = model.collectives()
    assert mesh["collective-permute"] == n * hops * rows * cols
    assert mesh["total"] == n * hops * rows * cols + 4 * (n - 1)
    assert model.summary()["mesh"]["flops"] == len(at) * 2 * rows * rows * cols
    assert model.collectives(0) == {"total": 0}


def test_full_ring_moves_every_block_n_minus_one_times():
    n, rows, cols = 4, 4, 8
    blocks = [torch.ones((rows, cols), device=META) for _ in range(n)]
    with traced(n) as model:
        ring_pair_count(blocks, [META] * n,
                        lambda m, t, *_: (m @ t.T).sum(), half_ring=False)
    assert model.collectives()["collective-permute"] == \
        n * (n - 1) * rows * cols * 4


def test_all_to_all_reports_every_chunk():
    n = 3
    sends = [torch.zeros((n, 5), device=META) for _ in range(n)]
    with traced(n) as model:
        out = all_to_all(sends, [META] * n)
    assert [tuple(o.shape) for o in out] == [(n, 5)] * n
    assert [model.collectives(p)["all-to-all"] for p in range(n)] == [60] * n


def test_k1_on_meta_counts_its_operations():
    adjs = torch.empty((3, 40, 64), dtype=torch.uint8, device=META)
    with traced(2) as model:
        with at_position(1):
            got = butterfly_count_pallas_windows(adjs)
    assert got.shape == (3,) and got.device == META
    ops = k1_operations(adjs)
    assert ops == 2 * 3 * 40 * 39 / 2 * 64
    assert model.flops == [0.0, ops]
    assert model.kernels == {"K1": {"launches": 1, "flops": ops}}


def test_k1_on_cpu_is_not_a_traced_kernel():
    adjs = torch.from_numpy((np.random.default_rng(0).random((2, 9, 12)) < .5)
                            .astype(np.uint8))
    with traced(1) as model:
        butterfly_count_pallas_windows(adjs)
    assert model.kernels == {} and model.flops[0] > 0   # the plain version's bmm


def test_notes_without_an_observer_go_nowhere():
    assert current_position() is None
    note_move("all-gather", 0, 1, 8)
    with at_position(3):
        assert current_position() == 3
    assert current_position() is None
    with pytest.raises(ValueError, match="outside a mesh of 2"):
        with traced(2):
            with at_position(2):
                torch.zeros(1, device=META) + 1
