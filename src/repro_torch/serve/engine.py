"""Serving runtime: prefill + decode step builders and a batched
generation driver.

The port of :mod:`repro.serve.engine`.  Serving is *inference* and sits
outside the ``Fleet``/``Plan`` training facade: this module is the
serving front door (``generate`` + the step builders in ``__all__``),
and it consumes ``build_model(LMConfig)`` models directly.

The reference caches one compiled decode step per model; PyTorch runs
eagerly, so what is cached here is the step closure, in the same
bounded, id-keyed LRU whose entry pins its model (a live key's id cannot
be reused by a new model, and an evicted entry releases it).
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

__all__ = ["GenerationResult", "clear_decode_cache", "generate",
           "make_decode_step", "make_prefill_step", "sample_token"]

Tree = Any

STEP_CACHE_SIZE = 32


class _StepCache:
    """Bounded LRU of step functions keyed by ``(kind, id(model))``; each
    entry holds the function and the model it closed over."""

    def __init__(self, maxsize: int = STEP_CACHE_SIZE) -> None:
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._entries: "OrderedDict[Tuple, Tuple[Callable, Any]]" = \
            OrderedDict()

    def get(self, key: Tuple) -> Optional[Callable]:
        entry = self._entries.get(key)
        if entry is None:
            return None
        self._entries.move_to_end(key)
        return entry[0]

    def put(self, key: Tuple, fn: Callable, model: Any) -> None:
        self._entries[key] = (fn, model)
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple) -> bool:
        return key in self._entries

    def clear(self) -> None:
        self._entries.clear()


_DECODE_CACHE = _StepCache()


def _decode_step_for(model) -> Callable:
    key = ("decode", id(model))
    fn = _DECODE_CACHE.get(key)
    if fn is None:
        fn = make_decode_step(model)
        _DECODE_CACHE.put(key, fn, model)
    return fn


def clear_decode_cache() -> None:
    """Drop every cached decode step (releases pinned models)."""
    _DECODE_CACHE.clear()


def make_prefill_step(model, max_len: int) -> Callable:
    def prefill_step(params: Tree, batch: Dict[str, torch.Tensor]):
        return model.prefill(params, batch, max_len)
    return prefill_step


def make_decode_step(model) -> Callable:
    def decode_step(params: Tree, tok: torch.Tensor, cache: Tree, pos: int):
        return model.decode_step(params, tok, cache, pos)
    return decode_step


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits [B, V] -> token [B, 1] int32 (greedy when temperature ==
    0; else a draw from ``softmax(logits / temperature)`` with
    ``generator``, on the logits' device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # [B, n_new]
    prefill_logits: torch.Tensor


def generate(model, params: Tree, batch: Dict[str, torch.Tensor], *,
             max_len: int, n_new: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0) -> GenerationResult:
    """Batched prefill-then-decode driver (the serving example path), run
    under ``torch.inference_mode()``.  Decode positions are absolute: a
    prefix of ``embeds`` counts."""
    prompt_len = batch["tokens"].shape[1]
    if "embeds" in batch:
        prompt_len += batch["embeds"].shape[1]
    with torch.inference_mode():
        logits, cache = model.prefill(params, batch, max_len)
        decode = _decode_step_for(model)
        toks = []
        tok = sample_token(logits, generator, temperature)
        for i in range(n_new):
            toks.append(tok)
            step_logits, cache = decode(params, tok, cache, prompt_len + i)
            tok = sample_token(step_logits, generator, temperature)
    return GenerationResult(tokens=torch.cat(toks, dim=1),
                            prefill_logits=logits)
