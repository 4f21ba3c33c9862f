"""Grouped-query self-attention with RoPE and sliding windows.

The port of :mod:`repro.models.lm.attention`: ``init_attention``,
``_project_qkv``, the quadratic reference ``mha`` (the oracle of the
flash kernel) with its memory-bounded blocked form, ``self_attention``,
whose ``use_flash`` switch routes onto the CUDA flash-attention kernel,
the encdec family's ``cross_attention`` (plain, as in the reference) and
the serving path's ``decode_self_attention``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.device import is_dtensor
from repro_torch.models.lm.common import (Params, ambient_abstract_mesh,
                                          apply_rope, merge_heads,
                                          shard_hint, split_shardable,
                                          truncated_normal_init)


def _qkv_hints(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Megatron-style activation sharding of ``[B, T, H, hd]``: heads
    over ``model`` where they divide it; K/V with too few KV heads
    replicate over ``model`` (:func:`shard_hint` drops the entry), so the
    score contraction is never sharded.

    When the query heads do not divide the model axis, the query
    *sequence* goes over ``model`` instead (context parallelism), as in
    the reference.  The identity without a mesh in scope and on plain
    tensors."""
    mesh = ambient_abstract_mesh()
    if mesh is None:
        return q, k, v
    from repro_torch.distrib.sharding import axis_size
    model = axis_size(mesh, "model")
    if q.shape[2] % model == 0 and q.shape[2] >= model or q.shape[1] == 1:
        q = shard_hint(q, ("pod", "data"), None, "model", None)
    else:
        q = shard_hint(q, ("pod", "data"), "model", None, None)
    k = shard_hint(k, ("pod", "data"), None, "model", None)
    v = shard_hint(v, ("pod", "data"), None, "model", None)
    return q, k, v


def init_attention(generator: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   qkv_bias: bool = False, device=None) -> Params:
    p = {
        "wq": truncated_normal_init(generator, (d_model, n_heads * head_dim),
                                    1.0, dtype, device),
        "wk": truncated_normal_init(generator,
                                    (d_model, n_kv_heads * head_dim), 1.0,
                                    dtype, device),
        "wv": truncated_normal_init(generator,
                                    (d_model, n_kv_heads * head_dim), 1.0,
                                    dtype, device),
        "wo": truncated_normal_init(generator, (n_heads * head_dim, d_model),
                                    1.0, dtype, device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


def _project_qkv(p: Params, x: torch.Tensor, kv_src: torch.Tensor,
                 n_heads: int, n_kv_heads: int, head_dim: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, T = x.shape[:2]
    S = kv_src.shape[1]
    q = x @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (split_shardable(q, -1, n_heads).reshape(B, T, n_heads, head_dim),
            split_shardable(k, -1, n_kv_heads).reshape(B, S, n_kv_heads,
                                                       head_dim),
            split_shardable(v, -1, n_kv_heads).reshape(B, S, n_kv_heads,
                                                       head_dim))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        window: int = 0, q_offset: int = 0, block_q: int = 0
        ) -> torch.Tensor:
    """Reference attention.  q: [B,T,H,hd]; k/v: [B,S,KV,hd].

    ``window > 0`` = sliding window (each query sees the previous
    ``window`` keys inclusive).  ``q_offset`` is the absolute position of
    q[.,0] minus that of k[.,0].  ``block_q > 0`` switches to the blocked
    evaluation when it divides a longer T, so the scores never hold more
    than ``block_q`` query rows.  Grouped einsum: no materialized
    head-repeat of K/V.  DTensors take the flash kernel's layout
    (:func:`repro_torch.kernels.ops.attention_on_shards`), the plain
    attention run on each rank's local heads."""
    if block_q and q.shape[1] > block_q and q.shape[1] % block_q == 0:
        return _mha_blocked(q, k, v, causal=causal, window=window,
                            block_q=block_q)
    if is_dtensor(q):
        from repro_torch.kernels import ops as kops
        return kops.attention_on_shards(q, k, v, lambda a, b, c: mha(
            *(kops.DenseGrad.apply(t) for t in (a, b, c)), causal=causal,
            window=window, q_offset=q_offset))
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    rep = H // KV
    qf = (split_shardable(q, 2, KV).float() / math.sqrt(hd)
          ).reshape(B, T, KV, rep, hd)
    logits = torch.einsum("btkrh,bskh->bktrs", qf, k.float())
    qpos = torch.arange(T, device=q.device) + q_offset
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask[None, None, :, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bktrs,bskh->btkrh", probs, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def _mha_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int, block_q: int) -> torch.Tensor:
    """Query blocks one after another; each block takes a full softmax row
    against all of K/V (no online accumulation needed)."""
    T = q.shape[1]
    outs = []
    for i in range(0, T, block_q):
        # re-hinted per block, as the reference re-hints its scan body
        qi, ki, vi = _qkv_hints(q[:, i:i + block_q], k, v)
        outs.append(mha(qi, ki, vi, causal=causal, window=window,
                        q_offset=i))
    return torch.cat(outs, dim=1)


def self_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                   n_kv_heads: int, head_dim: int, causal: bool,
                   rope_theta: float = 0.0, window: int = 0,
                   positions: Optional[torch.Tensor] = None,
                   use_flash: bool = False, block_q: int = 0
                   ) -> torch.Tensor:
    B, T, _ = x.shape
    q, k, v = _qkv_hints(*_project_qkv(p, x, x, n_heads, n_kv_heads,
                                       head_dim))
    if rope_theta > 0:
        pos = positions if positions is not None \
            else torch.arange(T, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if use_flash:
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = mha(q, k, v, causal=causal, window=window, block_q=block_q)
    return merge_heads(out) @ p["wo"]


def cross_attention(p: Params, x: torch.Tensor, enc_out: torch.Tensor, *,
                    n_heads: int, n_kv_heads: int, head_dim: int,
                    block_q: int = 0) -> torch.Tensor:
    """Decoder queries over encoder keys: the plain ``mha``, non-causal."""
    B, T, _ = x.shape
    q, k, v = _qkv_hints(*_project_qkv(p, x, enc_out, n_heads, n_kv_heads,
                                       head_dim))
    out = mha(q, k, v, causal=False, block_q=block_q)
    return merge_heads(out) @ p["wo"]


# ---------------------------------------------------------------------------
# Decode path (single new token against a KV cache)
# ---------------------------------------------------------------------------

def decode_self_attention(p: Params, x: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, pos: int, *, n_heads: int,
                          n_kv_heads: int, head_dim: int,
                          rope_theta: float = 0.0, window: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """x: [B, 1, D]; cache_k/v: [B, S, KV, hd]; pos: the absolute position
    being written.  The new K/V row is written into the caches in place
    (no copy of the cache per token); returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    pos = int(pos)
    q, k, v = _project_qkv(p, x, x, n_heads, n_kv_heads, head_dim)
    if rope_theta > 0:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, rope_theta)
        k = apply_rope(k, posv, rope_theta)
    cache_k[:, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v[:, 0].to(cache_v.dtype)
    S, KV = cache_k.shape[1], cache_k.shape[2]
    rep = n_heads // KV
    qf = (q.float() / math.sqrt(head_dim)).reshape(B, 1, KV, rep, head_dim)
    logits = torch.einsum("btkrh,bskh->bktrs", qf, cache_k.float())
    kpos = torch.arange(S, device=x.device)
    valid = kpos <= pos
    if window > 0:
        valid &= kpos > pos - window
    logits = torch.where(valid[None, None, None, None, :], logits,
                         torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bktrs,bskh->btkrh", probs, cache_v.float())
    out = out.to(x.dtype).reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"], cache_k, cache_v
