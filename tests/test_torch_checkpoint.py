"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's ``repro.train.checkpoint``.

A checkpoint directory written by either package restores in the other:
the engines' v4 ``state_dict`` (fleet and single stream) round-trips with
equal leaves and dtypes, and the restored engine goes on counting as the
saving one does.  The port's flatten gives ``jax.tree.flatten``'s leaf
order and structure string; the CRC fallback skips a bit-flipped and a
truncated newest step; ``gc_tmp_dirs`` sweeps stale tmp dirs.
"""
import collections
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.streams.config import EngineConfig as JConfig  # noqa: E402
from repro.streams.engine import StreamingSGrapp as JEngine  # noqa: E402
from repro.streams.multi import MultiStreamSGrapp as JFleet  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    EngineConfig,
    MultiStreamSGrapp,
    StreamingSGrapp,
    bipartite_pa_stream,
)
from repro_torch.train import checkpoint as tck  # noqa: E402

NT_W = 30
ALPHA0 = 0.95
RTOL = 1e-6
N = 600
CUT = 330


def streams(n):
    return [bipartite_pa_stream(N, temporal="uniform", n_unique=150,
                                seed=60 + s) for s in range(n)]


def make(kind: str, port: bool):
    cfg = (EngineConfig(tier="dense", device="cpu") if port
           else JConfig(tier="dense"))
    if kind == "single":
        return (StreamingSGrapp if port else JEngine)(NT_W, ALPHA0,
                                                     config=cfg)
    return (MultiStreamSGrapp if port else JFleet)(3, NT_W, ALPHA0,
                                                  config=cfg)


def feed(eng, kind, ss, lo, hi):
    for sid, s in enumerate(ss):
        cols = (s.tau[lo:hi], s.edge_i[lo:hi], s.edge_j[lo:hi])
        if kind == "single":
            eng.push(*cols)
        else:
            eng.push(sid, *cols)
    return eng


def finish(eng, kind):
    return [eng.finalize()] if kind == "single" else eng.finalize()


PKGS = {"port": tck, "reference": jck}


@pytest.mark.parametrize("kind", ["single", "fleet"])
@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_state_dict_checkpoint_restores_across_packages(tmp_path, kind,
                                                        writer, reader):
    ss = streams(1 if kind == "single" else 3)
    saver = feed(make(kind, writer == "port"), kind, ss, 0, CUT)
    sd = saver.state_dict()
    path = PKGS[writer].save_checkpoint(str(tmp_path), 3, sd,
                                        extra={"watermarks": [4, 5, 6]})
    assert os.path.basename(path) == "step_00000003"
    fresh = make(kind, reader == "port")
    got, extra = PKGS[reader].restore_checkpoint(
        str(tmp_path), fresh.state_dict(), host=True)
    assert extra == {"watermarks": [4, 5, 6]}
    assert sorted(got) == sorted(sd)
    for key in sd:
        want = np.asarray(sd[key])
        assert got[key].dtype == want.dtype, key
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    # the restored engine goes on as the saving one does
    fresh.restore(got)
    res = finish(feed(fresh, kind, ss, CUT, N), kind)
    ref = finish(feed(saver, kind, ss, CUT, N), kind)
    for r, e in zip(res, ref):
        np.testing.assert_array_equal(r.window_counts, e.window_counts)
        np.testing.assert_array_equal(r.cum_edges, e.cum_edges)
        np.testing.assert_allclose(r.estimates, e.estimates, rtol=RTOL)


@pytest.mark.parametrize("kind", ["single", "fleet"])
def test_manifests_equal_the_reference(tmp_path, kind):
    ss = streams(1 if kind == "single" else 3)
    sd = feed(make(kind, True), kind, ss, 0, CUT).state_dict()
    tck.save_checkpoint(str(tmp_path / "t"), 0, sd)
    jck.save_checkpoint(str(tmp_path / "j"), 0, sd)
    t = tck.verify_checkpoint(str(tmp_path / "t"), 0)
    j = jck.verify_checkpoint(str(tmp_path / "j"), 0)
    assert t == j   # treedef string, shapes, dtypes and the arrays' CRC


NT = collections.namedtuple("NT", "a b")


@pytest.mark.parametrize("tree", [
    {"z": np.int64(3), "a": [1, None, (2.0,)], "m": {"q": np.ones(2),
                                                      "b": None}},
    [None, (), {"k": NT(np.zeros(3), 4)}],
    (np.arange(4), {"b": 1, "a": 2}, [[], [5]]),
], ids=["dict", "list", "tuple"])
def test_flatten_order_equals_jax(tree):
    leaves, treedef = tck.tree_flatten(tree)
    jleaves, jdef = jax.tree.flatten(tree)
    assert len(leaves) == len(jleaves)
    assert all(a is b for a, b in zip(leaves, jleaves))
    assert str(treedef) == str(jdef)
    back = tck.tree_unflatten(treedef, leaves)
    assert str(tck.tree_flatten(back)[1]) == str(jdef)


def test_device_restore_gives_tensors_and_keeps_64_bit(tmp_path):
    tree = {"i": np.arange(3, dtype=np.int64) + 2**40,
            "f": np.linspace(0, 1, 4), "s": None}
    tck.save_checkpoint(str(tmp_path), 0, tree)
    host, _ = tck.restore_checkpoint(str(tmp_path), tree, host=True)
    assert host["i"].dtype == np.int64 and host["f"].dtype == np.float64
    np.testing.assert_array_equal(host["i"], tree["i"])
    dev, _ = tck.restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert isinstance(dev["i"], torch.Tensor) and dev["s"] is None
    assert dev["i"].dtype == torch.int64 and dev["f"].dtype == torch.float64
    np.testing.assert_array_equal(dev["i"].numpy(), tree["i"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        tck.restore_checkpoint(str(tmp_path), tree, host=True, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_checkpoint(str(tmp_path), {"i": 0}, host=True)


def _bit_flip(path):
    arrays = os.path.join(path, "arrays.npz")
    with open(arrays, "r+b") as f:
        f.seek(os.path.getsize(arrays) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0x40]))


def _truncate(path):
    arrays = os.path.join(path, "arrays.npz")
    with open(arrays, "r+b") as f:
        f.truncate(os.path.getsize(arrays) // 3)


def _torn_manifest(path):
    man = os.path.join(path, "manifest.json")
    with open(man, "r+b") as f:
        f.truncate(os.path.getsize(man) // 2)


@pytest.mark.parametrize("corrupt", [_bit_flip, _truncate, _torn_manifest],
                         ids=["bit_flip", "truncated", "torn_manifest"])
@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_crc_fallback_past_a_corrupt_newest_step(tmp_path, corrupt, pkg):
    """The port's ``restore_latest_valid`` skips a corrupt newest step of a
    directory written by either package."""
    w = PKGS[pkg]
    trees = [{"x": np.full(4096, float(k)), "n": np.int64(k)}
             for k in range(3)]
    for k, tree in enumerate(trees):
        w.save_checkpoint(str(tmp_path), k, tree, extra={"k": k})
    corrupt(str(tmp_path / "step_00000002"))
    with pytest.raises(tck.CheckpointCorruption):
        tck.verify_checkpoint(str(tmp_path), 2)
    state, extra, step, skipped = tck.restore_latest_valid(
        str(tmp_path), trees[0], host=True)
    assert (step, skipped, extra) == (1, [2], {"k": 1})
    np.testing.assert_array_equal(state["x"], trees[1]["x"])
    # every step corrupt: no silent restore
    corrupt(str(tmp_path / "step_00000001"))
    corrupt(str(tmp_path / "step_00000000"))
    with pytest.raises(tck.CheckpointCorruption, match="no valid"):
        tck.restore_latest_valid(str(tmp_path), trees[0], host=True)
    with pytest.raises(FileNotFoundError):
        tck.restore_latest_valid(str(tmp_path / "none"), trees[0], host=True)


def test_gc_tmp_dirs_and_valid_steps(tmp_path):
    tree = {"x": np.arange(3)}
    for k in (0, 4):
        tck.save_checkpoint(str(tmp_path), k, tree)
    stale = [tmp_path / ".tmp_step_00000007", tmp_path / ".tmp_step_00000009"]
    for d in stale:
        d.mkdir()
        (d / "arrays.npz").write_bytes(b"partial")
    assert tck.valid_steps(str(tmp_path)) == [0, 4]
    assert tck.latest_step(str(tmp_path)) == 4
    assert sorted(tck.gc_tmp_dirs(str(tmp_path))) == sorted(map(str, stale))
    assert not any(d.exists() for d in stale)
    assert tck.gc_tmp_dirs(str(tmp_path)) == []
    assert tck.gc_tmp_dirs(str(tmp_path / "missing")) == []
    assert tck.valid_steps(str(tmp_path)) == [0, 4]


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path), keep=2)
    for k in range(4):
        ck.save(k, {"x": torch.full((3,), float(k)), "n": np.int64(k)},
                extra={"k": k})
    ck.wait()
    assert tck.valid_steps(str(tmp_path)) == [2, 3]
    state, extra = jck.restore_checkpoint(
        str(tmp_path), {"x": np.zeros(3), "n": np.int64(0)}, host=True)
    assert extra == {"k": 3}
    np.testing.assert_array_equal(state["x"], np.full(3, 3.0))
