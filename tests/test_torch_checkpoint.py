"""The port's checkpoint store against ``repro.checkpoint.store``.

Each case of tests/test_checkpoint.py runs on the port (round trip with
bf16, keep-N, atomicity, corruption, structure mismatch, empty store,
stray entries, corrupt-newest fallback, all corrupt, two-phase restore,
exact float64); JAX's reshard-on-load case becomes placement on load.
The two packages share one on-disk format, so a checkpoint written by
either loads in the other, bit for bit, with the same manifest
``paths``, ``dtypes`` and ``shapes`` (f32, f64, int32 and bf16 leaves
in nested LM param dicts).
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro_torch.checkpoint.store import (CheckpointManager, latest_step,
                                          load_checkpoint, save_checkpoint)
from repro_torch.convert import params_from_numpy
from tests.test_torch_lm import np_params, stacks

jax.config.update("jax_platform_name", "cpu")


def _tree(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 16, generator=g),
                   "b": torch.randn(16, generator=g).to(torch.bfloat16)},
        "opt": {"m": torch.zeros(8, 16),
                "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bits(leaf) -> np.ndarray:
    """The raw bits of a tensor or array leaf (bf16 as int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(leaf)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        bx, by = _bits(x), _bits(y)
        assert bx.dtype == by.dtype and bx.shape == by.shape
        assert bx.tobytes() == by.tobytes()


def _corrupt(payload) -> None:
    with open(payload, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")


def test_roundtrip(tmp_path):
    tree = _tree(0)
    save_checkpoint(str(tmp_path), 3, tree, extra={"note": "x"})
    out = load_checkpoint(str(tmp_path), 3, tree)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype and a.device == b.device
    assert_trees_equal(tree, out)


def test_latest_and_keep_n(tmp_path):
    tree = _tree(0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]
    assert latest_step(str(tmp_path)) == 4


def test_atomic_no_partial(tmp_path):
    """A stray .tmp dir (simulated crash) is never picked up."""
    save_checkpoint(str(tmp_path), 1, _tree(0))
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1


def test_corruption_detected(tmp_path):
    tree = _tree(0)
    path = save_checkpoint(str(tmp_path), 1, tree)
    _corrupt(os.path.join(path, "arrays.npz"))
    with pytest.raises(IOError, match="corrupt"):
        load_checkpoint(str(tmp_path), 1, tree)


def test_structure_mismatch(tmp_path):
    tree = _tree(0)
    save_checkpoint(str(tmp_path), 1, tree)
    other = {"params": {"w": tree["params"]["w"]}}
    with pytest.raises(ValueError, match="mismatch"):
        load_checkpoint(str(tmp_path), 1, other)


def test_restore_latest_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    step, restored = mgr.restore_latest({"a": torch.zeros(3)})
    assert step is None and restored is None


def test_stray_entries_ignored(tmp_path):
    tree = _tree(0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, tree)
    (tmp_path / "step_notes.txt").write_text("operator scribbles")
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_abc")
    assert latest_step(str(tmp_path)) == 1
    mgr.save(2, tree)
    mgr.save(3, tree)     # GC of step 1 must skip the strays
    assert latest_step(str(tmp_path)) == 3
    assert (tmp_path / "step_notes.txt").exists()
    assert (tmp_path / "step_abc").exists()


def test_corrupt_newest_falls_back(tmp_path):
    t1, t2 = _tree(1), _tree(2)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, t1)
    mgr.save(2, t2)
    _corrupt(tmp_path / "step_00000002" / "arrays.npz")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        step, restored = mgr.restore_latest(t1)
    assert step == 1
    assert_trees_equal(t1, restored)


def test_all_corrupt_raises(tmp_path):
    tree = _tree(0)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, tree)
    _corrupt(tmp_path / "step_00000001" / "arrays.npz")
    with pytest.warns(RuntimeWarning, match="unreadable"):
        with pytest.raises(IOError):
            mgr.restore_latest(tree)


def test_restore_latest_with_extra(tmp_path):
    tree = _tree(0)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, tree, extra={"fleet": ["a", "b"], "wall": 1.25})
    seen = {}

    def like_fn(step, extra):
        seen["step"], seen["extra"] = step, extra
        return tree

    step, restored, extra = mgr.restore_latest_with(like_fn)
    assert step == 5 and seen["step"] == 5
    assert extra["fleet"] == ["a", "b"] and extra["wall"] == 1.25
    assert_trees_equal(tree, restored)


def test_float64_roundtrip_exact(tmp_path):
    """f64 leaves (the loop's profile rows) come back as the exact host
    arrays that were saved."""
    rng = np.random.default_rng(0)
    tree = {"L_f": rng.random((3, 5)), "L_b": rng.random((3, 5))}
    save_checkpoint(str(tmp_path), 1, tree)
    out = load_checkpoint(str(tmp_path), 1,
                          {k: np.zeros_like(v) for k, v in tree.items()})
    for k in tree:
        assert isinstance(out[k], np.ndarray) and out[k].dtype == np.float64
        np.testing.assert_array_equal(out[k], tree[k])


def test_placement_on_load(tmp_path):
    """A tensor leaf of ``like`` names the device its leaf comes back on,
    a numpy leaf stays host numpy; ``device`` puts every leaf there."""
    tree = {**_tree(0), "rows": np.arange(6.0).reshape(2, 3)}
    save_checkpoint(str(tmp_path), 1, tree)
    out = load_checkpoint(str(tmp_path), 1, tree)
    assert isinstance(out["rows"], np.ndarray)
    assert all(t.device.type == "cpu" for t in _leaves(out["params"]))
    placed = load_checkpoint(str(tmp_path), 1, tree, device="cpu")
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in _leaves(placed))
    assert_trees_equal(out, placed)
    assert placed["rows"].dtype == torch.float64


def test_paths_follow_the_jax_tree_order(tmp_path):
    """Dict keys sorted, lists in order, ``None`` holding no leaf."""
    tree = {"params": [{"w": torch.zeros(1), "b": torch.zeros(1)},
                       {"ln": {"z": torch.zeros(1), "a": torch.zeros(1)}}],
            "none": None, "prof": {"L_u": np.zeros(1)}}
    path = save_checkpoint(str(tmp_path), 1, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        got = json.load(f)["paths"]
    assert got == ["params/0/b", "params/0/w", "params/1/ln/a",
                   "params/1/ln/z", "prof/L_u"]
    jpath = jstore.save_checkpoint(str(tmp_path / "jax"), 1, tree)
    with open(os.path.join(jpath, "manifest.json")) as f:
        assert json.load(f)["paths"] == got


# ---------------------------------------------------------------------------
# Across the package boundary
# ---------------------------------------------------------------------------


def _cross_trees():
    """The same tree in both packages: the bf16 oracle-zamba LM params
    (nested dicts; matrices bf16, vectors f32), float64 profile rows and
    an int32 scalar."""
    js, _ = stacks("ref", "bfloat16")
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(
        a, jnp.bfloat16 if a.ndim >= 2 else jnp.float32)), np_params(js, 4))
    rng = np.random.default_rng(1)
    prof = {"L_f": rng.random((3, 6)), "L_b": rng.random((3, 6))}
    jtree = {"params": jax.tree.map(jnp.asarray, p), "prof": prof,
             "step": jnp.int32(7)}
    ttree = {"params": params_from_numpy(p),
             "prof": {k: v.copy() for k, v in prof.items()},
             "step": torch.tensor(7, dtype=torch.int32)}
    return jtree, ttree


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return {k: m[k] for k in ("paths", "dtypes", "shapes", "extra")}


def test_jax_writes_port_loads(tmp_path):
    jtree, ttree = _cross_trees()
    jpath = jstore.save_checkpoint(str(tmp_path / "j"), 3, jtree,
                                   extra={"wall": 0.5})
    tpath = save_checkpoint(str(tmp_path / "t"), 3, ttree,
                            extra={"wall": 0.5})
    assert _manifest(jpath) == _manifest(tpath)
    assert "bfloat16" in _manifest(jpath)["dtypes"].values()
    out = load_checkpoint(str(tmp_path / "j"), 3, ttree)
    assert_trees_equal(ttree, out)
    assert any(t.dtype == torch.bfloat16 for t in _leaves(out["params"]))
    assert out["prof"]["L_f"].dtype == np.float64


def test_port_writes_jax_loads(tmp_path):
    jtree, ttree = _cross_trees()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(4, ttree, extra={"seed": 3})
    step, out, extra = jstore.CheckpointManager(
        str(tmp_path)).restore_latest_with(lambda s, e: jtree)
    assert step == 4 and extra == {"seed": 3}
    assert_trees_equal(jtree, out)
    assert any(np.asarray(a).dtype.name == "bfloat16"
               for a in jax.tree.leaves(out["params"]))
