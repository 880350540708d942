"""The port's KONECT-style loader (``repro_torch.streams.datasets``) against
the reference's ``repro.streams.datasets``: the same streams from the same
files in every layout (4 columns, 3 columns as timestamps or as weights, 2
columns, comment headers, ``max_edges``), the same dataset discovery and the
same missing-file error."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.streams import datasets as jd  # noqa: E402
from repro_torch.streams import datasets as td  # noqa: E402

LAYOUTS = {
    "four_columns": ["% bip", "1 1 1 100.5", "1 2 1 101.0", "2 1 1 103.0"],
    "three_timestamps": ["% sym", "1 1 10", "1 2 11", "2 1 15", "2 2 15"],
    "three_weights": ["1 1 5", "1 2 1", "2 1 3", "3 2 4"],
    "three_constant": ["1 1 1", "1 2 1", "2 1 1"],
    "two_columns": ["# plain", "7 9", "3 9", "7 4", "", "12 1"],
    "mixed": ["1 1 1 50", "2 2 60", "3 3"],
}


def write_random(path, seed, n=400):
    rng = np.random.default_rng(seed)
    i = rng.integers(1, 60, n)
    j = rng.integers(1, 40, n)
    t = np.sort(rng.integers(0, 10_000, n))
    lines = ["% random temporal"] + [f"{a} {b} 1 {c}"
                                     for a, b, c in zip(i, j, t)]
    path.write_text("\n".join(lines) + "\n")


def assert_same_stream(a, b):
    np.testing.assert_array_equal(a.tau, b.tau)
    np.testing.assert_array_equal(a.edge_i, b.edge_i)
    np.testing.assert_array_equal(a.edge_j, b.edge_j)
    assert a.tau.dtype == b.tau.dtype and a.edge_i.dtype == b.edge_i.dtype


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kw", [{}, {"has_timestamps": False},
                                {"max_edges": 2}],
                         ids=["default", "no_timestamps", "max_edges"])
def test_load_edge_tsv_equals_the_reference(tmp_path, layout, kw):
    p = tmp_path / f"out.{layout}"
    p.write_text("\n".join(LAYOUTS[layout]) + "\n")
    assert_same_stream(td.load_edge_tsv(str(p), **kw),
                       jd.load_edge_tsv(str(p), **kw))


@pytest.mark.parametrize("seed", [0, 1])
def test_random_konect_dirs_load_and_list_as_the_reference(tmp_path, seed):
    for name in ("alpha", "beta"):
        (tmp_path / name).mkdir()
        write_random(tmp_path / name / f"out.{name}", seed)
    (tmp_path / "gamma").mkdir()
    write_random(tmp_path / "gamma" / "out.other", seed + 7)
    (tmp_path / "empty").mkdir()
    assert td.available_datasets(str(tmp_path)) == \
        jd.available_datasets(str(tmp_path)) == ["alpha", "beta", "gamma"]
    for name in ("alpha", "gamma"):
        assert_same_stream(td.load_konect(str(tmp_path), name),
                           jd.load_konect(str(tmp_path), name))
    with pytest.raises(FileNotFoundError):
        td.load_konect(str(tmp_path), "empty")
    assert td.available_datasets(str(tmp_path / "none")) == []
