"""The port's synthetic data pipelines against ``repro.data.pipeline``.

Every batch is byte-equal to the JAX package's (same numpy Philox
streams, same order), over seeds, steps and shard counts; the port draws
``SyntheticImages``' class prototypes once per instance, which gives the
same bytes.  The cases of tests/test_data.py are mirrored on the port.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.configs import get_arch
from repro.configs.base import ShapeSpec
from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from tests._compat import given, settings, st


def assert_same_bytes(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_images_byte_equal(seed, num_shards):
    args = ((8, 8, 3), 5, 16, seed)
    tp, jp = tpipe.SyntheticImages(*args), jpipe.SyntheticImages(*args)
    for step in (0, 1, 7, 1000):
        for shard in range(num_shards):
            assert_same_bytes(tp.batch(step, shard, num_shards),
                              jp.batch(step, shard, num_shards))


def test_image_prototypes_drawn_once_same_bytes():
    """The port memoizes the prototypes: the same bytes as the
    reference's per-call draw, read-only, and equal batches over steps."""
    args = ((16, 16, 3), 7, 8, 5)
    tp, jp = tpipe.SyntheticImages(*args), jpipe.SyntheticImages(*args)
    protos = tp._prototypes()
    assert protos is tp._prototypes()
    assert not protos.flags.writeable
    assert protos.tobytes() == jp._prototypes().tobytes()
    for step in range(6):
        assert_same_bytes(tp.batch(step), jp.batch(step))
    assert protos.tobytes() == jp._prototypes().tobytes()


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_tokens_byte_equal(seed, num_shards):
    args = (64, 40, 8, seed)
    tp, jp = tpipe.SyntheticTokens(*args), jpipe.SyntheticTokens(*args)
    for step in (0, 5, 321):
        for shard in range(num_shards):
            assert_same_bytes(tp.batch(step, shard, num_shards),
                              jp.batch(step, shard, num_shards))


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b",
                                  "qwen2.5-3b"])
def test_lm_batch_fn_byte_equal(arch):
    cfg = get_arch(arch).smoke
    shape = ShapeSpec("t", 32, 4, "train")
    tfn = tpipe.make_lm_batch_fn(cfg, shape, seed=2)
    jfn = jpipe.make_lm_batch_fn(cfg, shape, seed=2)
    for step in (0, 3):
        for shard, n in ((0, 1), (1, 2)):
            assert_same_bytes(tfn(step, shard, n), jfn(step, shard, n))


# ---------------------------------------------------------------------------
# tests/test_data.py, on the port
# ---------------------------------------------------------------------------


def test_deterministic():
    s = tpipe.SyntheticTokens(vocab=100, seq_len=32, global_batch=8, seed=3)
    a = s.batch(5)
    b = s.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = s.batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])


@settings(max_examples=20, deadline=None)
@given(step=st.integers(0, 1000),
       num_shards=st.sampled_from([1, 2, 4, 8]))
def test_shard_invariance(step, num_shards):
    s = tpipe.SyntheticTokens(vocab=64, seq_len=16, global_batch=8, seed=0)
    whole = s.batch(step)["tokens"]
    parts = [s.batch(step, shard, num_shards)["tokens"]
             for shard in range(num_shards)]
    np.testing.assert_array_equal(whole, np.concatenate(parts, axis=0))


def test_targets_are_shifted_tokens():
    s = tpipe.SyntheticTokens(vocab=50, seq_len=16, global_batch=2, seed=1)
    b = s.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_images_learnable_structure():
    s = tpipe.SyntheticImages((8, 8, 3), num_classes=4, global_batch=64,
                              seed=0)
    b = s.batch(0)
    protos = s._prototypes()
    d_own, d_other = [], []
    for i in range(64):
        x, y = b["x"][i], b["labels"][i]
        d = np.linalg.norm((protos - x).reshape(4, -1), axis=1)
        d_own.append(d[y])
        d_other.append(np.delete(d, y).min())
    assert np.mean(d_own) < np.mean(d_other)


def test_lm_batch_fn_families():
    shape = ShapeSpec("t", 32, 4, "train")
    for arch in ("whisper-base", "pixtral-12b", "qwen2.5-3b"):
        cfg = get_arch(arch).smoke
        b = tpipe.make_lm_batch_fn(cfg, shape, seed=0)(0)
        assert b["tokens"].shape[0] == 4
        if cfg.family == "encdec":
            assert b["frames"].shape == (4, 32, cfg.d_model)
        if cfg.n_frontend_tokens:
            assert "embeds" in b
