"""Gradient compression of the port (``repro_torch.distributed.collectives``:
``compress_grads``, ``decompress_grads``, ``psum_mean_compressed``) against
the JAX package's.

The reference's mean runs under ``shard_map`` on 8 CPU devices in a
subprocess (the XLA device-count flag must precede jax's start, so it is
set in the child only), over (2, 4) ("data", "model") and (2, 2, 2)
("pod", "data", "model") meshes, every axis and tuple of axes named below,
for each method.  The port runs the same per-position trees over a mesh of
the same shape whose positions all lie on the CPU.

Tolerances: ``None`` and ``int8`` exact (int8's quantised values, its
scales and the means built from them; the float32 sums run in the
reference's order), ``bf16`` within one bfloat16 rounding of each input
(``2**-8`` of the leaf's largest magnitude) against the reference and the
float64 mean of the bfloat16-cast inputs.  The reference runs compiled, as
its mean always does: XLA turns ``max|g| / 127.0`` into a product with the
reciprocal, which the port computes too.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed.collectives import (  # noqa: E402
    compress_grads as j_compress,
    decompress_grads as j_decompress,
)
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import observe  # noqa: E402
from repro_torch.launch.mesh import make_tiny_mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METHODS = (None, "bf16", "int8")
# (mesh, the axes reduced over); names as the child script spells them
CASES = [("tiny", "data"), ("tiny", "model"), ("tiny", ("data", "model")),
         ("tiny_multipod", ("pod", "data")), ("tiny_multipod", "model"),
         ("tiny_multipod", ("pod", "data", "model"))]

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import psum_mean_compressed
from repro.distributed.sharding import shard_map_compat
from repro.launch.mesh import make_mesh_compat

src = np.load(sys.argv[1])
cases = eval(sys.argv[3])
meshes = {"tiny": ((2, 4), ("data", "model")),
          "tiny_multipod": ((2, 2, 2), ("pod", "data", "model"))}
out = {}
for mesh_name, axis in cases:
    shape, names = meshes[mesh_name]
    mesh = make_mesh_compat(shape, names)
    spec = P(names)
    for method in (None, "bf16", "int8"):
        def body(w, b, method=method, axis=axis):
            m = psum_mean_compressed({"w": w[0], "b": b[0]}, axis, method)
            return m["w"][None], m["b"][None]
        f = jax.jit(shard_map_compat(body, mesh, in_specs=(spec, spec),
                                     out_specs=(spec, spec)))
        w, b = f(src["w"], src["b"])
        key = f"{mesh_name}|{axis}|{method}"
        out[key + "|w"] = np.asarray(w)
        out[key + "|b"] = np.asarray(b)
np.savez(sys.argv[2], **out)
print("REFERENCE_OK")
"""


def per_position_inputs(seed: int = 5) -> dict:
    """One ``w`` [6, 5] and one ``b`` [7] float32 leaf per position (8),
    spanning a few binary orders of magnitude."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 6, 5)) * np.exp2(rng.integers(-4, 5, (8, 1, 1)))
    b = rng.standard_normal((8, 7)) * np.exp2(rng.integers(-4, 5, (8, 1)))
    return {"w": w.astype(np.float32), "b": b.astype(np.float32)}


@pytest.fixture(scope="module")
def reference_means(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compress")
    src = per_position_inputs()
    np.savez(tmp / "in.npz", **src)
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    r = subprocess.run([sys.executable, "-c", CHILD, str(tmp / "in.npz"),
                        str(tmp / "out.npz"), repr(CASES)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-3000:]
    with np.load(tmp / "out.npz") as data:
        return src, {k: data[k] for k in data.files}


def port_means(src: dict, mesh_name: str, axis, method):
    mesh = make_tiny_mesh(multi_pod=mesh_name == "tiny_multipod",
                          devices=["cpu"] * 8)
    trees = [{"w": torch.from_numpy(src["w"][p]),
              "b": torch.from_numpy(src["b"][p])} for p in range(8)]
    return mesh, col.psum_mean_compressed(trees, mesh, axis, method)


@pytest.mark.parametrize("method", METHODS, ids=str)
@pytest.mark.parametrize("mesh_name,axis", CASES, ids=str)
def test_psum_mean_compressed_equals_the_reference(reference_means, mesh_name,
                                                   axis, method):
    src, ref = reference_means
    _, got = port_means(src, mesh_name, axis, method)
    for leaf in ("w", "b"):
        want = ref[f"{mesh_name}|{axis}|{method}|{leaf}"]
        have = np.stack([g[leaf].numpy() for g in got])
        assert have.dtype == np.float32 and have.shape == want.shape
        if method == "bf16":
            tol = 2.0 ** -8 * np.abs(src[leaf]).max()
            np.testing.assert_allclose(have, want, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(have, want)


@pytest.mark.parametrize("mesh_name,axis", CASES, ids=str)
def test_psum_mean_groups_and_float64_mean(mesh_name, axis):
    """Every member of a group holds its group's mean: for ``None`` the
    mean of the members' trees, for bf16 that of their bfloat16 casts, each
    against its float64 mean within the float32 sum's rounding: ``k - 1``
    additions and one division, at most ``2**-23 * sum|x|``."""
    src = per_position_inputs(9)
    mesh, plain = port_means(src, mesh_name, axis, None)
    _, bf16 = port_means(src, mesh_name, axis, "bf16")
    for group in col.axis_groups(mesh, axis):
        for leaf in ("w", "b"):
            x = torch.from_numpy(src[leaf][group]).double()
            xb = torch.from_numpy(src[leaf][group]).to(torch.bfloat16).double()
            for p in group:
                for got, xs in ((plain[p][leaf], x), (bf16[p][leaf], xb)):
                    err = (got.double() - xs.mean(dim=0)).abs()
                    assert (err <= 2 ** -23 * xs.abs().sum(dim=0)).all()


def test_axis_groups_follow_the_shard_order():
    mesh = make_tiny_mesh(multi_pod=True, devices=["cpu"] * 8)
    assert col.axis_groups(mesh, ("pod", "data")).tolist() == [
        [0, 2, 4, 6], [1, 3, 5, 7]]
    assert col.axis_groups(mesh, ("data", "pod")).tolist() == [
        [0, 4, 2, 6], [1, 5, 3, 7]]
    assert col.axis_groups(mesh, "model").tolist() == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    tiny = make_tiny_mesh(devices=["cpu"] * 8)
    assert col.axis_groups(tiny, "data").tolist() == [[0, 4], [1, 5], [2, 6],
                                                      [3, 7]]
    with pytest.raises(ValueError, match="no axis 'pod'"):
        col.axis_groups(tiny, "pod")


def test_psum_mean_refuses_misfit_trees():
    mesh = make_tiny_mesh(devices=["cpu"] * 8)
    tree = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="7 trees for a mesh of 8"):
        col.psum_mean_compressed([tree] * 7, mesh, "data")
    with pytest.raises(ValueError, match="differ in structure"):
        col.psum_mean_compressed([tree] * 7 + [{"v": torch.ones(3)}], mesh,
                                 "data")
    with pytest.raises(ValueError, match="unknown compression"):
        col.psum_mean_compressed([tree] * 8, mesh, "data", "fp8")


def test_psum_mean_reports_its_moves():
    """Each non-first member sends its compressed leaf (and its scale) to
    the group's first position and receives the float32 mean back, as
    ``all-reduce`` moves."""
    mesh = make_tiny_mesh(devices=["meta"] * 8)
    trees = [{"w": torch.empty((64, 32), device="meta")}] * 8

    class Moves:
        def __init__(self):
            self.seen = []

        def move(self, kind, src, dst, nbytes):
            self.seen.append((kind, src, dst, nbytes))

        def kernel(self, name, flops, nbytes):
            raise AssertionError(name)

    for method, wire in ((None, 64 * 32 * 4), ("bf16", 64 * 32 * 2),
                         ("int8", 64 * 32 + 4)):
        with observe.observing(Moves()) as obs:
            out = col.psum_mean_compressed(trees, mesh, "data", method)
        assert out[5]["w"].dtype == torch.float32
        assert sorted(obs.seen) == sorted(
            [("all-reduce", p + 4, p, wire) for p in range(4)]
            + [("all-reduce", p, p + 4, 64 * 32 * 4) for p in range(4)])


# -- compress / decompress, leaf by leaf --------------------------------------------

def test_compress_grads_equals_the_reference():
    """Quantised values and scales exactly as the compiled reference's, on
    float32 and bfloat16 leaves; the decompressed trees too."""
    rng = np.random.default_rng(11)
    tree = {"a": rng.standard_normal((33, 7)).astype(np.float32) * 40,
            "z": {"b": rng.standard_normal(129).astype(np.float32) * 1e-3,
                  "c": np.zeros(5, np.float32)}}
    port = {"a": torch.from_numpy(tree["a"]),
            "z": {k: torch.from_numpy(v) for k, v in tree["z"].items()}}
    for method in METHODS:
        jq, js = jax.jit(j_compress, static_argnums=1)(tree, method)
        q, s = col.compress_grads(port, method)
        for path in (("a",), ("z", "b"), ("z", "c")):
            def at(t, path=path):
                for k in path:
                    t = t[k]
                return t
            want = np.asarray(at(jq).astype(jnp.float32))
            got = at(q)
            assert got.dtype == {None: torch.float32, "bf16": torch.bfloat16,
                                 "int8": torch.int8}[method]
            np.testing.assert_array_equal(got.float().numpy(), want)
            if method == "int8":
                assert at(s).dtype == torch.float32 and at(s).dim() == 0
                assert float(at(s)) == float(at(js))
            back = at(col.decompress_grads(q, s, method))
            assert back.dtype == torch.float32
            np.testing.assert_array_equal(
                back.numpy(), np.asarray(at(j_decompress(jq, js, method))))
        if method != "int8":
            assert s is None
    bq, bs = col.compress_grads(torch.from_numpy(tree["a"]).to(torch.bfloat16),
                                "int8")
    jq, js = jax.jit(j_compress, static_argnums=1)(
        jnp.asarray(tree["a"]).astype(jnp.bfloat16), "int8")
    assert bs.dtype == torch.bfloat16
    np.testing.assert_array_equal(bq.numpy(), np.asarray(jq))
    assert float(bs) == float(js)
    with pytest.raises(ValueError, match="unknown compression"):
        col.compress_grads(port, "fp8")
    with pytest.raises(ValueError, match="unknown compression"):
        col.decompress_grads(port, None, "fp8")


@pytest.mark.parametrize("method", METHODS, ids=str)
def test_grad_compression_roundtrip(method):
    """``tests/test_substrate_units.py``'s roundtrip on the port."""
    g = {"w": torch.from_numpy(np.linspace(-3, 3, 64, dtype=np.float32))}
    q, scales = col.compress_grads(g, method)
    back = col.decompress_grads(q, scales, method)
    rtol = {None: 0, "bf16": 1e-2, "int8": 5e-2}[method]
    np.testing.assert_allclose(back["w"].numpy(), g["w"].numpy(), rtol=rtol,
                               atol=0.06)
