"""Deterministic synthetic data pipelines.

The port of :mod:`repro.data.pipeline`: the same numpy Philox streams in
the same order, so every batch is byte-equal to the JAX package's.

Properties required by the fault-tolerant trainer:

* **Stateless indexing** — batch ``i`` is a pure function of ``(seed, i)``
  (counter-based PRNG), so restart-after-failure resumes at step ``k`` by
  simply asking for batch ``k``: no pipeline state to checkpoint, no
  skip-ahead replay cost.
* **Shardable** — batches are produced host-locally per data shard:
  ``batch(i, shard, num_shards)`` returns that shard's rows only, and
  rows are assigned shard-major so the global batch is independent of
  the shard count (elastic rescaling keeps the data order).

The LM stream synthesizes token sequences from a mixture of Zipf-like
unigram draws and periodic motifs, so cross-entropy decreases during the
example runs (there is structure to learn) while everything stays
offline and reproducible.

Batches are numpy arrays on the host; the training loop moves them to
the device.  :class:`SyntheticImages` draws its class prototypes (a pure
function of the seed) once per instance rather than once per batch: at
AlexNet's 224x224x3 and 200 classes that is 30 M normals a call.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np


def _fold(seed: int, *idx: int) -> np.random.Generator:
    counter = (list(idx) + [0, 0, 0, 0])[:4]
    return np.random.Generator(np.random.Philox(key=seed, counter=counter))


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """Batch i, shard s: tokens/targets [rows, seq_len] int32."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64

    def _motifs(self) -> np.ndarray:
        rng = _fold(self.seed, 0xA0)
        return rng.integers(0, self.vocab, (self.n_motifs, self.motif_len),
                            dtype=np.int64)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        assert self.global_batch % num_shards == 0
        rows = self.global_batch // num_shards
        motifs = self._motifs()
        out = np.empty((rows, self.seq_len + 1), np.int64)
        for r in range(rows):
            grow = shard * rows + r
            rng = _fold(self.seed, 1, step, grow)
            # zipf-ish unigram noise
            u = rng.random(self.seq_len + 1)
            seq = (self.vocab * u ** 3).astype(np.int64)
            # paste periodic motifs (learnable structure)
            m = motifs[rng.integers(0, self.n_motifs)]
            period = self.motif_len * 2
            for start in range(rng.integers(0, period),
                               self.seq_len + 1 - self.motif_len, period):
                seq[start:start + self.motif_len] = m
            out[r] = seq
        return {"tokens": out[:, :-1].astype(np.int32),
                "targets": out[:, 1:].astype(np.int32)}


@dataclasses.dataclass(frozen=True)
class SyntheticImages:
    """Class-conditional Gaussian blobs: learnable image classification.

    Used by the HierTrain CNN examples (LeNet-5 / AlexNet stand-ins for
    CIFAR-10 / tiny-ImageNet).  Batch ``i`` is pure in ``(seed, i)``.
    """
    input_shape: Tuple[int, ...]
    num_classes: int
    global_batch: int
    seed: int = 0
    noise: float = 0.6

    @functools.cached_property
    def _protos(self) -> np.ndarray:
        rng = _fold(self.seed, 2)
        protos = rng.normal(0.0, 1.0, (self.num_classes,) +
                            tuple(self.input_shape)).astype(np.float32)
        protos.flags.writeable = False
        return protos

    def _prototypes(self) -> np.ndarray:
        """The class prototypes (read-only; drawn on first use)."""
        return self._protos

    def batch(self, step: int, shard: int = 0, num_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        assert self.global_batch % num_shards == 0
        rows = self.global_batch // num_shards
        protos = self._prototypes()
        rng = _fold(self.seed, 3, step, shard)
        labels = rng.integers(0, self.num_classes, rows)
        x = protos[labels] + rng.normal(
            0.0, self.noise, (rows,) + tuple(self.input_shape)
        ).astype(np.float32)
        return {"x": x, "labels": labels.astype(np.int32)}


def make_lm_batch_fn(cfg, shape, seed: int = 0):
    """Batch function for an LM config (``family``, ``vocab``,
    ``d_model``, ``n_frontend_tokens``) and a shape with ``global_batch``
    and ``seq_len`` (adds the stub frontend inputs for vlm/encdec
    families)."""
    B, T = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        stream = SyntheticTokens(cfg.vocab, T, B, seed)

        def fn(step, shard=0, num_shards=1):
            b = stream.batch(step, shard, num_shards)
            rows = b["tokens"].shape[0]
            rng = _fold(seed, 4, step, shard)
            b["frames"] = rng.normal(0, 1, (rows, T, cfg.d_model)).astype(
                np.float32)
            return b
        return fn
    if cfg.n_frontend_tokens > 0:
        P = min(cfg.n_frontend_tokens, T // 2)
        stream = SyntheticTokens(cfg.vocab, T - P, B, seed)

        def fn(step, shard=0, num_shards=1):
            b = stream.batch(step, shard, num_shards)
            rows = b["tokens"].shape[0]
            rng = _fold(seed, 5, step, shard)
            b["embeds"] = rng.normal(0, 1, (rows, P, cfg.d_model)).astype(
                np.float32)
            return b
        return fn
    stream = SyntheticTokens(cfg.vocab, T, B, seed)
    return stream.batch
