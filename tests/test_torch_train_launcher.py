"""The port's training launcher on the CPU (``--device cpu``): it trains an
LM, GNN or xDeepFM smoke config, checkpoints the reference's tree
``(params, AdamWState(step, m, v))`` with the layers stacked on ``[L]``,
and a checkpoint restores across the packages in both directions with
equal leaves.

The launcher's ``train_4k`` cell is cut to 32-token sequences here (the
smoke run shrinks the batch to 64 sequences as the reference's does; 4,096
tokens a sequence is the card's size).  The reference's
``restore_checkpoint`` cannot cast the ``|V2`` records that ``np.savez``
writes for its own bf16 leaves to bfloat16 ("No cast function
available"), so its side reads them with ``host=True`` as 2-byte records
and the bits are compared."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models.transformer import init_lm_params as j_init  # noqa: E402
from repro.train.checkpoint import (  # noqa: E402
    restore_checkpoint as j_restore,
    save_checkpoint as j_save,
)
from repro.train.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro.train.optimizer import adamw_update as j_adamw_update  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.train.checkpoint import latest_step  # noqa: E402

BF16 = np.dtype("V2")


@pytest.fixture
def short_sequences(monkeypatch):
    shapes = dict(registry.LM_SHAPES)
    shapes["train_4k"] = (32, 256, "train")
    monkeypatch.setattr(registry, "LM_SHAPES", shapes)


def bits(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vf":
        return a.view(np.uint16)
    return a


def j_state(arch, seed):
    """The reference's ``(params, AdamWState)`` after one update, so the
    moments are not zero."""
    cfg = j_get_arch(arch).smoke_config()
    params = j_init(jax.random.PRNGKey(seed), cfg)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = j_adamw_update(grads, j_adamw_init(params), params)
    return params, opt


def host_template(tree):
    return jax.tree.map(lambda x: np.zeros(0, BF16 if x.dtype == jnp.bfloat16
                                           else np.asarray(x).dtype), tree)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "phi3.5-moe-42b",
                                  "minicpm3-4b"])
def test_a_port_checkpoint_restores_in_the_reference(tmp_path, short_sequences,
                                                     capsys, arch):
    d = str(tmp_path / "ck")
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "3",
                         "--ckpt", d, "--ckpt_every", "1", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "[train] step 0 loss" in printed and "[train] done: 3 steps" in printed
    assert latest_step(d) == 3 and out["start"] == 0
    assert np.isfinite(float(out["metrics"]["loss"]))
    template = host_template(j_state(arch, 0))
    restored, extra = j_restore(d, template, host=True)
    assert extra == {"step": 3}
    mine = launcher.state_to_reference(out["state"])
    got, want = jax.tree.leaves(restored), jax.tree.leaves(mine)
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))
    assert int(restored[1].step) == 3


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "dbrx-132b"])
def test_a_reference_checkpoint_restores_in_the_port(tmp_path, short_sequences,
                                                     capsys, arch):
    d = str(tmp_path / "ck")
    params, opt = j_state(arch, 4)
    j_save(d, 5, (params, opt), extra={"step": 5})
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "5",
                         "--ckpt", d, "--device", "cpu"])
    assert "[train] restored step 5" in capsys.readouterr().out
    assert out["start"] == 5
    got = jax.tree.leaves(launcher.state_to_reference(out["state"]))
    want = jax.tree.leaves((params, opt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g), bits(w))
    # and it trains on from there
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "6",
                         "--ckpt", d, "--device", "cpu"])
    assert out["metrics"]["step"].shape == ()
    assert int(out["metrics"]["step"]) == int(opt.step) + 1


def test_synth_batch_draws_the_references_numbers():
    from repro.launch.train import synth_batch as j_synth
    abstract = {"tokens": registry.sd((3, 5), torch.int32),
                "mask": registry.sd((3,), torch.bool),
                "x": registry.sd((2, 2), torch.float32)}
    j_abstract = {"tokens": jax.ShapeDtypeStruct((3, 5), jnp.int32),
                  "mask": jax.ShapeDtypeStruct((3,), jnp.bool_),
                  "x": jax.ShapeDtypeStruct((2, 2), jnp.float32)}
    got = launcher.synth_batch(abstract, np.random.default_rng(9), "cpu")
    want = j_synth(j_abstract, np.random.default_rng(9))
    for k in abstract:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # a cell's batch, whose keys are not sorted: the draws follow
    # jax.tree.map's order (keys sorted)
    from repro.configs import list_cells as j_list_cells
    from repro_torch.configs import list_cells
    for arch, shape in (("dimenet", "molecule"), ("phi4-mini-3.8b", "train_4k")):
        g_abs = list_cells(arch, smoke=True)[shape].abstract_inputs()[1]
        w_abs = j_list_cells(arch, smoke=True)[shape].abstract_inputs()[1]
        assert list(g_abs) != sorted(g_abs)
        small = lambda t: {k: type(v)((3,) + tuple(v.shape[1:]), v.dtype)  # noqa: E731
                           for k, v in t.items()}
        got = launcher.synth_batch(small(g_abs), np.random.default_rng(2), "cpu")
        want = j_synth(small(w_abs), np.random.default_rng(2))
        for k in g_abs:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch", ["graphcast", "xdeepfm"])
def test_gnn_and_recsys_wait_for_their_slice(arch, capsys):
    """They waited for their slice (ROADMAP Queue 1 item 4); now they train:
    the launcher steps them with a finite loss."""
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "2",
                         "--device", "cpu"])
    assert "[train] done: 2 steps" in capsys.readouterr().out
    assert int(out["metrics"]["step"]) == 2
    assert np.isfinite(float(out["metrics"]["loss"]))


@functools.lru_cache(maxsize=None)
def j_tree_state(arch, seed):
    """The reference's GNN or xDeepFM ``(params, AdamWState)`` after one
    update, so the moments are not zero (under ``jax.jit``: one compile,
    kept for both directions' tests)."""
    from repro.configs import registry as j_registry
    from repro.models.recsys import init_xdeepfm as j_init_xdeepfm

    arch_ = j_get_arch(arch)
    cell = next(c for c in arch_.cells(arch_.smoke_config()).values()
                if c.kind == "train")
    if arch_.family == "gnn":
        key = {"graphsage-reddit": "graphsage", "equiformer-v2": "equiformer"}.get(
            arch, arch)
        init = j_registry._GNN_INIT[key]
    else:
        init = j_init_xdeepfm

    @jax.jit
    def make(k):
        params = init(k, cell.config or arch_.smoke_config())
        grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
        params, opt, _ = j_adamw_update(grads, j_adamw_init(params), params)
        return params, opt
    return make(jax.random.PRNGKey(seed))


TREE_ARCHS = ["graphsage-reddit", "graphcast", "dimenet", "equiformer-v2",
              "xdeepfm"]


@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_a_gnn_or_recsys_port_checkpoint_restores_in_the_reference(
        tmp_path, capsys, arch):
    d = str(tmp_path / "ck")
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "3",
                         "--ckpt", d, "--ckpt_every", "3", "--device", "cpu"])
    assert "[train] done: 3 steps" in capsys.readouterr().out
    assert latest_step(d) == 3 and np.isfinite(float(out["metrics"]["loss"]))
    template = jax.tree.map(np.asarray, j_tree_state(arch, 0))
    restored, extra = j_restore(d, template)
    assert extra == {"step": 3}
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    got = jax.tree.leaves(restored)
    want = jax.tree.leaves(launcher.state_to_reference(out["state"]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
    assert int(restored[1].step) == 3


@pytest.mark.parametrize("arch", TREE_ARCHS)
def test_a_gnn_or_recsys_reference_checkpoint_restores_in_the_port(
        tmp_path, capsys, arch):
    d = str(tmp_path / "ck")
    params, opt = j_tree_state(arch, 0)
    j_save(d, 5, (params, opt), extra={"step": 5})
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "5",
                         "--ckpt", d, "--device", "cpu"])
    assert "[train] restored step 5" in capsys.readouterr().out
    got = jax.tree.leaves(launcher.state_to_reference(out["state"]))
    want = jax.tree.leaves((params, opt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    out = launcher.main(["--arch", arch, "--smoke", "--steps", "6",
                         "--ckpt", d, "--device", "cpu"])
    assert int(out["metrics"]["step"]) == int(opt.step) + 1
    assert np.isfinite(float(out["metrics"]["loss"]))
