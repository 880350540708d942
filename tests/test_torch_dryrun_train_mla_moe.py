"""The port's dry-run of minicpm3-4b's (MLA) and phi3.5-moe-42b's (MoE)
``train_4k`` cells on the tiny meshes: each record held to its analytic
values as ``tests/test_torch_dryrun_train.py`` holds the dense GQA archs'
(see its docstring), in a file of its own (dbrx-132b's in
``tests/test_torch_dryrun_train_dbrx.py``) so that ``--dist loadfile``
runs the traces on several workers.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun_train import (  # noqa: E402
    TINY,
    check_train_record,
    train_records,
)

ARCHS = ["minicpm3-4b", "phi3.5-moe-42b"]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return train_records(tmp_path_factory, ARCHS)


@pytest.mark.parametrize("mesh", TINY)
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_lm_train_is_ok(records, arch, mesh):
    recs, launches = records
    assert launches == 0
    check_train_record(recs[(arch, mesh)], arch, mesh)
