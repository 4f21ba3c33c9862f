"""Shared architecture-spec plumbing: shape catalogue + input specs.

The port of :mod:`repro.configs.base`.  Every ported architecture module
exports an :class:`ArchSpec` with the exact published full config, a
reduced smoke config of the same family, and the shape cells it runs
(``long_500k`` only for sub-quadratic archs; skips carry their reason).
``input_specs`` / ``decode_token_spec`` give ``(shape, dtype)`` pairs
where the reference gives ``jax.ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.lm.model import LMConfig

Spec = Tuple[Tuple[int, ...], torch.dtype]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

FULL_ATTENTION_SKIP = ("full-attention arch: 524k-token KV would be a "
                       "quadratic-prefill / full-cache cost; long_500k is "
                       "reserved for sub-quadratic (SSM/hybrid) archs per "
                       "the assignment")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    lm: LMConfig                      # the exact published configuration
    smoke: LMConfig                   # reduced same-family config for CPU
    optimizer: str = "adamw"          # adamw | sgdm (giant models)
    microbatches: int = 8             # train_4k grad-accumulation factor
    smoke_seq: int = 64
    smoke_batch: int = 2
    notes: str = ""

    @property
    def shapes(self) -> Tuple[str, ...]:
        names = ["train_4k", "prefill_32k", "decode_32k"]
        if self.lm.sub_quadratic:
            names.append("long_500k")
        return tuple(names)

    @property
    def skips(self) -> Dict[str, str]:
        if self.lm.sub_quadratic:
            return {}
        return {"long_500k": FULL_ATTENTION_SKIP}


def _token_specs(B: int, T: int, targets: bool) -> Dict[str, Spec]:
    s = {"tokens": ((B, T), torch.int32)}
    if targets:
        s["targets"] = ((B, T), torch.int32)
    return s


def input_specs(cfg: LMConfig, shape: ShapeSpec,
                smoke: bool = False) -> Dict[str, Spec]:
    """``(shape, dtype)`` of each input of one batch of the given shape
    cell.  For ``decode`` cells this is the *prompt-side* spec."""
    B, T = shape.global_batch, shape.seq_len
    want_targets = shape.kind == "train"
    if cfg.family == "encdec":
        s = _token_specs(B, T, want_targets)
        s["frames"] = ((B, T, cfg.d_model), torch.bfloat16)
        return s
    if cfg.n_frontend_tokens > 0:
        P = min(cfg.n_frontend_tokens, T // 2)
        s = _token_specs(B, T - P, want_targets)
        s["embeds"] = ((B, P, cfg.d_model), torch.bfloat16)
        return s
    return _token_specs(B, T, want_targets)


def decode_token_spec(shape: ShapeSpec) -> Dict[str, Spec]:
    B = shape.global_batch
    return {"tok": ((B, 1), torch.int32), "pos": ((), torch.int32)}
