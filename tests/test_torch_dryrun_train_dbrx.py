"""The port's dry-run of dbrx-132b's ``train_4k`` cell on the tiny meshes:
each record held to its analytic values as
``tests/test_torch_dryrun_train.py`` holds the dense GQA archs' (see its
docstring), in a file of its own so that ``--dist loadfile`` runs its
traces beside the other archs'.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_train import (  # noqa: E402
    TINY,
    check_train_record,
    train_records,
)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return train_records(tmp_path_factory, ["dbrx-132b"])


@pytest.mark.parametrize("mesh", TINY)
def test_dryrun_lm_train_is_ok(records, mesh):
    recs, launches = records
    assert launches == 0
    check_train_record(recs[("dbrx-132b", mesh)], "dbrx-132b", mesh)
