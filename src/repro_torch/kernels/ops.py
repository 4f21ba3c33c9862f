"""Public wrappers around the port's kernels, in model layout.

* :func:`flash_attention` — GQA flash attention over ``[B, T, H, hd]``,
  a ``torch.autograd.Function`` whose backward is the chunked pass over K
  blocks that consumes the kernel's log-sum-exp.  On DTensors it runs on
  each rank's local shard (:func:`attention_on_shards`).
* :func:`gla_scan` — the chunked gated linear recurrence over
  ``[B, T, H, d]``; its backward is the gradient of the plain
  ``chunked_gla``.  On DTensors it runs on each rank's local shard
  (:func:`_gla_on_shards`).
* :func:`wire_qdq_int8` — the deterministic cut-point wire round trip
  (per-sample rows, round to nearest).
* :func:`quantize_int8` / :func:`dequantize_int8` — unbiased int8
  compression with stochastic rounding.

The JAX package has no backward Pallas kernel: flash attention's
backward is jnp code and the GLA backward the VJP of its plain
recurrence.  So here both backwards are plain PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gs
from repro_torch.kernels import int8_quant as iq
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.lm.gla import chunked_gla

# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def _pick_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    b = min(target, n)
    while n % b:
        b -= 1
    return b


class _FlashAttention(torch.autograd.Function):
    """Head-major flash attention: the kernel forward, and the chunked
    backward of ``repro/kernels/ops.py`` (one pass over K blocks of
    ``_pick_block(S, 512)`` keys, rebuilding each block's probabilities
    from the saved lse, in f32)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        BH, T, hd = q.shape
        BKV, S, _ = k.shape
        rep = BH // BKV
        bk = _pick_block(S, 512)
        scale = 1.0 / (hd ** 0.5)
        qf = q.float().reshape(BKV, rep, T, hd)
        dof = do.float().reshape(BKV, rep, T, hd)
        of = o.float().reshape(BKV, rep, T, hd)
        lsef = lse.reshape(BKV, rep, T)
        delta = (dof * of).sum(dim=-1)                    # [BKV, rep, T]
        kf, vf = k.float(), v.float()
        qpos = torch.arange(T, device=q.device)
        dq = torch.zeros_like(qf)
        dk = torch.empty_like(kf)
        dv = torch.empty_like(vf)
        for j0 in range(0, S, bk):
            kj, vj = kf[:, j0:j0 + bk], vf[:, j0:j0 + bk]  # [BKV, bk, hd]
            kpos = j0 + torch.arange(bk, device=q.device)
            s = torch.einsum("brth,bkh->brtk", qf, kj) * scale
            mask = torch.ones((T, bk), dtype=torch.bool, device=q.device)
            if ctx.causal:
                mask &= qpos[:, None] >= kpos[None, :]
            if ctx.window > 0:
                mask &= kpos[None, :] > qpos[:, None] - ctx.window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            p = torch.exp(s - lsef[..., None])            # [BKV, rep, T, bk]
            dv[:, j0:j0 + bk] = torch.einsum("brtk,brth->bkh", p, dof)
            dp = torch.einsum("brth,bkh->brtk", dof, vj)
            ds = p * (dp - delta[..., None])
            dq = dq + scale * torch.einsum("brtk,bkh->brth", ds, kj)
            dk[:, j0:j0 + bk] = scale * torch.einsum("brtk,brth->bkh", ds,
                                                     qf)
        return (dq.reshape(BH, T, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model layout: q [B, T, H, hd]; k/v [B, S, KV, hd] -> [B, T, H, hd].
    DTensors go through :func:`attention_on_shards`."""
    if is_dtensor(q):
        causal, window = bool(causal), int(window)
        return attention_on_shards(q, k, v, lambda a, b, c: flash_attention(
            a, b, c, causal=causal, window=window))
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2).contiguous().reshape(B * H, T, hd)
    kh = k.transpose(1, 2).contiguous().reshape(B * KV, S, hd)
    vh = v.transpose(1, 2).contiguous().reshape(B * KV, S, hd)
    o = _FlashAttention.apply(qh, kh, vh, bool(causal), int(window))
    return o.reshape(B, H, T, hd).transpose(1, 2)


def _kv_group(k: torch.Tensor, h0: int, heads: int, rep: int
              ) -> torch.Tensor:
    """The KV heads that query heads ``[h0, h0 + heads)`` read (head ``h``
    reads KV head ``h // rep``), as ``[B, S, KV', hd]`` whose head ``j``
    the kernel pairs with local query head ``j * KV' // heads``: a slice
    when the heads cover their groups evenly, else one KV head per query
    head."""
    idx = [(h0 + j) // rep for j in range(heads)]
    g0, n = idx[0], idx[-1] + 1 - idx[0]
    if heads % n == 0 and idx == [g0 + j * n // heads for j in range(heads)]:
        return k[:, :, g0:g0 + n]
    return k[:, :, idx]


def attention_on_shards(q, k, v, attend) -> torch.Tensor:
    """Attention of DTensors, ``attend(q, k, v)`` (the flash kernel, or
    the plain ``mha``) run on each rank's local shard of the model
    layout.

    q goes to batch over the DP axes and heads over ``model``; k and v to
    the same batch split and KV heads over ``model`` where they divide
    it.  On the layout :func:`repro_torch.models.lm.attention._qkv_hints`
    gives, those are no-ops: no collective.  Where the KV heads are
    replicated over ``model`` and the query heads sharded (GQA or MQA
    with few KV heads), each rank slices the KV heads its own query
    heads read, and their gradient comes back ``Partial`` over
    ``model``.  Where the query heads do not divide ``model`` (the hints
    then shard q's sequence), q's sequence is gathered first, every rank
    computes all heads, and o is re-sharded to q's layout after: a
    causal offset of the rank's query rows is a kernel change left
    undone."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.distrib.sharding import (axis_names, axis_size,
                                              placements)
    from repro_torch.models.lm.common import head_split
    mesh = q.device_mesh
    B, T, H, hd = q.shape
    KV = k.shape[2]
    model = axis_size(mesh, "model")
    dp, by_heads = head_split(mesh, B, H)
    kv_heads = by_heads and KV % model == 0 and KV >= model
    qp = placements(mesh, (dp, None, "model" if by_heads else None, None))
    kp = placements(mesh, (dp, None, "model" if kv_heads else None, None))
    layout = q.placements
    ql = q.redistribute(mesh, qp).to_local()
    if by_heads and not kv_heads:
        # each rank's slice of the replicated K/V: its gradient is this
        # rank's share of the sum over ``model``
        kg = list(kp)
        kg[axis_names(mesh).index("model")] = Partial()
        kl, vl = (t.redistribute(mesh, kp).to_local(grad_placements=kg)
                  for t in (k, v))
        Hl = H // model
        h0 = mesh.get_local_rank("model") * Hl
        kl, vl = (_kv_group(t, h0, Hl, H // KV) for t in (kl, vl))
    else:
        kl, vl = (t.redistribute(mesh, kp).to_local() for t in (k, v))
    o = DTensor.from_local(attend(ql, kl, vl), mesh, qp, run_check=False)
    # back to q's layout: a local slice where q's sequence was sharded
    return o.redistribute(mesh, tuple(Replicate() if p.is_partial() else p
                                      for p in layout))


# ---------------------------------------------------------------------------
# GLA scan
# ---------------------------------------------------------------------------


class _GlaScan(torch.autograd.Function):
    """Head-major GLA: the kernel forward; the backward recomputes the
    plain ``chunked_gla`` under autograd and returns its gradient.

    Not the step loop of ``ref_gla``, whose VJP the JAX package takes:
    autograd through a per-step loop keeps every step's state, ``T x BH x
    dk x dv x 4`` bytes (about 7.5 GB per block at zamba2-7b's shapes),
    and launches ``T`` steps of small operations.  ``chunked_gla`` is
    the same function and keeps ``O(T W)`` per head."""

    @staticmethod
    def forward(ctx, q, k, v, a, chunk: int, normalize: bool):
        y, S, n = gs.gla_scan_fwd(q, k, v, a, chunk, normalize)
        ctx.save_for_backward(q, k, v, a)
        ctx.set_materialize_grads(False)   # Mamba2 drops S and n
        ctx.chunk, ctx.normalize = chunk, normalize
        return y, S, n

    @staticmethod
    def backward(ctx, gy, gS, gn):
        q, k, v, a = ctx.saved_tensors
        if gy is None and gS is None and gn is None:
            return None, None, None, None, None, None
        ins = [t.detach().requires_grad_(True) for t in (q, k, v, a)]
        with torch.enable_grad():
            qm, km, vm, am = (t.unsqueeze(2) for t in ins)  # H = 1
            y, (S, n) = chunked_gla(qm, km, vm, am, chunk=ctx.chunk,
                                    normalize=ctx.normalize)
            outs = [(y.squeeze(2), gy), (S.squeeze(1), gS),
                    (n.squeeze(1), gn)]
            outs = [(t, g) for t, g in outs if g is not None]
            grads = torch.autograd.grad([t for t, _ in outs],
                                        ins, [g for _, g in outs],
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(ins, grads)]
        return (*grads, None, None)


def gla_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_decay: torch.Tensor, *, chunk: int = 128,
             normalize: bool = False,
             initial_state: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None):
    """Model layout: q/k [B, T, H, dk]; v [B, T, H, dv];
    log_decay [B, T, H].  Contract matches ``chunked_gla``; a nonzero
    ``initial_state`` stays on the plain ``chunked_gla``, as in JAX."""
    if initial_state is not None:
        return chunked_gla(q, k, v, log_decay, chunk=chunk,
                           normalize=normalize, initial_state=initial_state)
    if is_dtensor(q):
        return _gla_on_shards(q, k, v, log_decay, chunk, bool(normalize))
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    qh = q.transpose(1, 2).contiguous().reshape(B * H, T, dk)
    kh = k.transpose(1, 2).contiguous().reshape(B * H, T, dk)
    vh = v.transpose(1, 2).contiguous().reshape(B * H, T, dv)
    ah = log_decay.float().transpose(1, 2).contiguous().reshape(B * H, T)
    y, S, n = _GlaScan.apply(qh, kh, vh, ah, min(chunk, T), bool(normalize))
    return (y.reshape(B, H, T, dv).transpose(1, 2),
            (S.reshape(B, H, dk, dv), n.reshape(B, H, dk)))


def _gla_on_shards(q, k, v, log_decay, chunk: int, normalize: bool):
    """The GLA scan of DTensors, the kernel run on each rank's local
    shard of the model layout.

    Every input goes to batch over the DP axes and heads over ``model``
    where they divide it (:func:`repro_torch.models.lm.common.head_split`),
    else heads replicated, every rank computing all heads of its batch
    block.  Heads the model already shards stay put: no collective.
    Inputs replicated over ``model`` -- Mamba2's q and k, computed once
    for all heads -- are sliced to the rank's heads, their gradient a
    pending sum over ``model``
    (:func:`repro_torch.models.lm.common.local_heads`).  y, S and n come
    back as DTensors of that layout; the backward's recomputed
    ``chunked_gla`` runs on the local shards too."""
    from repro_torch.models.lm.common import (from_heads, head_split,
                                              local_heads)
    mesh = q.device_mesh
    dp, by_heads = head_split(mesh, q.shape[0], q.shape[2])
    ql, kl, vl, al = (local_heads(t, 2, by_heads, dp)
                      for t in (q, k, v, log_decay))
    y, (S, n) = gla_scan(ql, kl, vl, al, chunk=chunk, normalize=normalize)
    return (from_heads(y, mesh, 2, by_heads, dp),
            (from_heads(S, mesh, 1, by_heads, dp),
             from_heads(n, mesh, 1, by_heads, dp)))


# ---------------------------------------------------------------------------
# Int8 compression
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantizes the rows of ``x [M, N]`` with stochastic rounding, the
    uniform noise drawn from ``generator`` (on ``x``'s device).  Returns
    ``(q int8 [M, N], scale f32 [M])``; :func:`dequantize_int8` inverts.
    A tensor of any shape goes in by the rowing rule that
    :func:`repro_torch.core.wire.int8_leaf_bytes` charges: ``ndim >= 2``
    as ``prod(shape[:-1])`` rows of ``shape[-1]``, anything smaller as one
    row (:func:`repro_torch.distrib.tiered_sync._as_2d`), so a call ships
    ``M * N`` code bytes and ``4 * M`` scale bytes."""
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device)
    return iq.quantize_int8(x, noise)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return iq.dequantize_int8(q, scale)


def wire_qdq_int8(x: torch.Tensor) -> torch.Tensor:
    """Deterministic int8 wire round trip: per-*sample* rows (leading
    axis), absmax scaling, round to nearest (the noise pinned at 0.5).
    Returns the dequantized tensor in ``x``'s shape and dtype — exactly
    what the receiving worker reconstructs from ``elems + 4`` wire
    bytes/sample (see :mod:`repro_torch.core.wire`)."""
    flat = x.reshape(x.shape[0], -1).contiguous()
    return iq.wire_qdq_int8(flat).reshape(x.shape)
