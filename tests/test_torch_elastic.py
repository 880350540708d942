"""The elastic re-shard restore of the port (``restore_checkpoint`` /
``restore_latest_valid`` with ``shardings=``) against the reference's.

A checkpoint saved from one mesh layout restores onto another
value-exactly: saved from (2, 4) ("data", "model"), restored onto (4, 2)
with transposed specs, as ``tests/test_launchers_distributed.py``'s
``test_elastic_resharding_restore`` does it for the reference.  A
checkpoint the reference wrote from arrays sharded over 8 CPU devices (in
a subprocess: the XLA device-count flag is set in the child only) restores
in the port, and one the port wrote from its shards restores in the
reference.  Every comparison is exact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import NamedSharding, ShardedTensor  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def meshes():
    return (make_mesh((2, 4), ("data", "model"), ["cpu"] * 8),
            make_mesh((4, 2), ("data", "model"), ["cpu"] * 8))


def params(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.integers(-9, 9, 12).astype(np.int32)),
            "h": torch.from_numpy(rng.standard_normal((8, 16)).astype(
                np.float32)).to(torch.bfloat16)}


def saved_layout(mesh_a) -> dict:
    return {"w": NamedSharding(mesh_a, ("model", None)),
            "b": NamedSharding(mesh_a, ("data",)),
            "h": NamedSharding(mesh_a, (None, ("data", "model")))}


def transposed_layout(mesh_b) -> dict:
    return {"w": NamedSharding(mesh_b, (None, "data")),
            "b": NamedSharding(mesh_b, ("model",)),
            "h": NamedSharding(mesh_b, (("model", "data"), None))}


def assert_placed_exactly(got, want: torch.Tensor, sharding: NamedSharding):
    assert isinstance(got, ShardedTensor) and got.sharding == sharding
    assert got.shape == tuple(want.shape) and got.dtype == want.dtype
    devs = sharding.mesh.devices.ravel()
    for p, shard in enumerate(got.shards):
        assert shard.device == devs[p]
        assert torch.equal(shard, want[sharding.shard_slices(p, want.shape)])
    assert torch.equal(got.gather(), want)


def test_elastic_resharding_restore(tmp_path):
    """Saved from (2, 4), restored onto (4, 2) with transposed specs, by
    both restore entries; every shard and the gathered leaf exact."""
    mesh_a, mesh_b = meshes()
    p = params()
    sharded = {k: s.put(p[k]) for k, s in saved_layout(mesh_a).items()}
    tck.save_checkpoint(str(tmp_path / "ck"), 1, sharded, extra={"e": 1})
    shardings = transposed_layout(mesh_b)
    restored, extra = tck.restore_checkpoint(str(tmp_path / "ck"), p,
                                             shardings=shardings)
    assert extra == {"e": 1}
    for k in p:
        assert_placed_exactly(restored[k], p[k], shardings[k])
    assert restored["w"].sharding.spec == (None, "data")
    latest, _, step, skipped = tck.restore_latest_valid(
        str(tmp_path / "ck"), p, shardings=shardings)
    assert (step, skipped) == (1, [])
    for k in p:
        assert_placed_exactly(latest[k], p[k], shardings[k])


def test_sharded_save_writes_the_gathered_leaves(tmp_path):
    """A tree of shards saves as the tree of its global tensors: the same
    arrays and manifest (but its CRC) as the plain tree's save."""
    mesh_a, _ = meshes()
    p = params(4)
    sharded = {k: s.put(p[k]) for k, s in saved_layout(mesh_a).items()}
    tck.save_checkpoint(str(tmp_path / "a"), 2, sharded)
    tck.save_checkpoint(str(tmp_path / "b"), 2, p)
    ma, mb = (tck.verify_checkpoint(str(tmp_path / d), 2) for d in "ab")
    ma.pop("crc32_arrays")
    mb.pop("crc32_arrays")
    assert ma == mb
    with np.load(tmp_path / "a" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "b" / "step_00000002" / "arrays.npz") as b:
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k].view(np.uint8),
                                          b[k].view(np.uint8))


def test_shardings_place_none_leaves_and_refuse_misuse(tmp_path):
    mesh_a, mesh_b = meshes()
    p = params(5)
    tck.save_checkpoint(str(tmp_path / "ck"), 3, p)
    restored, _ = tck.restore_checkpoint(
        str(tmp_path / "ck"), p,
        shardings={"w": NamedSharding(mesh_b, ("data", "model")), "b": None,
                   "h": None})
    assert isinstance(restored["b"], torch.Tensor)
    assert restored["b"].device == mesh_b.devices.flat[0]
    assert torch.equal(restored["b"], p["b"]) and torch.equal(restored["h"],
                                                               p["h"])
    assert_placed_exactly(restored["w"], p["w"],
                          NamedSharding(mesh_b, ("data", "model")))
    layout = transposed_layout(mesh_b)
    with pytest.raises(ValueError, match="pass no device="):
        tck.restore_checkpoint(str(tmp_path / "ck"), p, shardings=layout,
                               device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive with shardings"):
        tck.restore_checkpoint(str(tmp_path / "ck"), p, shardings=layout,
                               host=True)
    with pytest.raises(ValueError, match="shardings has 2 leaves"):
        tck.restore_checkpoint(str(tmp_path / "ck"), p,
                               shardings={"w": None, "b": None})
    with pytest.raises(ValueError, match="does not divide"):
        tck.restore_checkpoint(
            str(tmp_path / "ck"), p,
            shardings={**layout, "b": NamedSharding(mesh_b,
                                                    (("data", "model"),))})
    # restore_latest_valid skips a step that does not load, as the reference
    with pytest.raises(tck.CheckpointCorruption, match="all of \\[3\\] failed"):
        tck.restore_latest_valid(str(tmp_path / "ck"), p,
                                 shardings={"w": None})


CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.train.checkpoint import save_checkpoint, restore_checkpoint
from repro.launch.mesh import make_mesh_compat

port_dir, ref_dir, src = sys.argv[1], sys.argv[2], np.load(sys.argv[3])
mesh_a = make_mesh_compat((2, 4), ("data", "model"))
mesh_b = make_mesh_compat((4, 2), ("data", "model"))
# the port's checkpoint, saved from its (2, 4) shards, onto (4, 2)
template = {"w": jnp.zeros((8, 8), jnp.float32), "b": jnp.zeros(12, jnp.int32)}
got, _ = restore_checkpoint(port_dir, template, shardings={
    "w": NamedSharding(mesh_b, P(None, "data")),
    "b": NamedSharding(mesh_b, P("model"))})
np.testing.assert_array_equal(np.asarray(got["w"]), src["w"])
np.testing.assert_array_equal(np.asarray(got["b"]), src["b"])
assert got["w"].sharding.spec == P(None, "data")
# the reference's own, from arrays sharded over (2, 4)
save_checkpoint(ref_dir, 7, {
    "w": jax.device_put(jnp.asarray(src["w"]), NamedSharding(mesh_a, P("model", None))),
    "b": jax.device_put(jnp.asarray(src["b"]), NamedSharding(mesh_a, P("data"))),
    "h": jax.device_put(jnp.asarray(src["h"]).astype(jnp.bfloat16),
                        NamedSharding(mesh_a, P(None, ("data", "model"))))},
    extra={"from": "reference"})
print("CROSS_OK")
"""


def test_elastic_restore_across_the_packages(tmp_path):
    """The port's (2, 4)-sharded checkpoint restores onto (4, 2) in the
    reference, and the reference's onto (4, 2) in the port, value-exactly
    (the bf16 leaf only the port's way: the reference's restore cannot
    cast the stored bits back to bfloat16)."""
    mesh_a, mesh_b = meshes()
    p = params(6)
    layout = saved_layout(mesh_a)
    tck.save_checkpoint(str(tmp_path / "port"), 5,
                        {k: layout[k].put(p[k]) for k in ("w", "b")})
    np.savez(tmp_path / "src.npz", w=p["w"].numpy(), b=p["b"].numpy(),
             h=p["h"].float().numpy())
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path / "port"),
                        str(tmp_path / "ref"), str(tmp_path / "src.npz")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode == 0 and "CROSS_OK" in r.stdout, r.stderr[-3000:]
    shardings = transposed_layout(mesh_b)
    for restore in (tck.restore_checkpoint, tck.restore_latest_valid):
        restored, extra, *_ = restore(str(tmp_path / "ref"), p,
                                      shardings=shardings)
        assert extra == {"from": "reference"}
        for k in p:
            assert_placed_exactly(restored[k], p[k], shardings[k])
