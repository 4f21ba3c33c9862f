"""Chunked gated linear recurrence ("GLA/SSD" primitive), plain PyTorch.

The port of :mod:`repro.models.lm.gla` (``chunked_gla`` and the serving
path's ``gla_decode_step``).  One primitive covers Mamba2's SSD and
xLSTM's mLSTM::

    S_t = exp(a_t) * S_{t-1} + k_t^T v_t          (state  [dk, dv])
    n_t = exp(a_t) * n_{t-1} + k_t                (normalizer, optional)
    y_t = q_t @ S_t  [ / max(|q_t @ n_t|, 1) ]

with ``a_t <= 0`` log-decay.  Quadratic inside a chunk, recurrent
across chunks.  ``use_kernel=True`` routes to the CUDA kernel through
:func:`repro_torch.kernels.ops.gla_scan`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def chunked_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_decay: torch.Tensor, *, chunk: int = 128,
                normalize: bool = False,
                initial_state: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                use_kernel: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q,k: [B,T,H,dk]; v: [B,T,H,dv]; log_decay: [B,T,H] (<= 0, f32).

    Returns y: [B,T,H,dv] (dtype of v) and final (S: [B,H,dk,dv],
    n: [B,H,dk]) in f32 (f64 for f64 inputs).
    """
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.gla_scan(q, k, v, log_decay, chunk=chunk,
                             normalize=normalize,
                             initial_state=initial_state)
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    W = min(chunk, T)
    if T % W:
        # pad to a chunk multiple with zero k/v and zero log-decay: padded
        # steps leave the state untouched and their outputs are dropped.
        pad = W - T % W

        def padt(a: torch.Tensor) -> torch.Tensor:
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))

        y, state = chunked_gla(padt(q), padt(k), padt(v), padt(log_decay),
                               chunk=W, normalize=normalize,
                               initial_state=initial_state)
        return y[:, :T], state
    nc = T // W

    wide = torch.promote_types(q.dtype, torch.float32)   # f64 stays f64
    qf = q.to(wide).reshape(B, nc, W, H, dk)
    kf = k.to(wide).reshape(B, nc, W, H, dk)
    vf = v.to(wide).reshape(B, nc, W, H, dv)
    af = log_decay.to(wide).reshape(B, nc, W, H)
    ca = torch.cumsum(af, dim=2)                      # [B,nc,W,H]
    tot = ca[:, :, -1, :]                             # [B,nc,H]

    # Intra-chunk quadratic term: D[i,j] = exp(ca_i - ca_j) for j <= i.
    # The masked exponents (j > i) are positive and overflow exp once the
    # decays within a chunk sum below about -89; they are set to -inf
    # before the exp, so their gradient is 0 and not 0 * inf = NaN.
    rel = ca[:, :, :, None, :] - ca[:, :, None, :, :]      # [B,nc,W,W,H]
    causal = torch.tril(torch.ones((W, W), dtype=torch.bool,
                                   device=q.device))
    D = torch.exp(torch.where(causal[None, None, :, :, None], rel,
                              torch.full((), float("-inf"), dtype=wide,
                                         device=q.device)))
    scores = torch.einsum("bcihd,bcjhd->bcijh", qf, kf) * D
    y_intra = torch.einsum("bcijh,bcjhd->bcihd", scores, vf)

    # Per-chunk summaries for the cross-chunk recurrence.
    kd = kf * torch.exp(tot[:, :, None, :, None] - ca[..., None])
    chunk_S = torch.einsum("bcihk,bcihv->bchkv", kd, vf)   # [B,nc,H,dk,dv]
    chunk_n = kd.sum(dim=2)                                # [B,nc,H,dk]

    if initial_state is None:
        S = qf.new_zeros((B, H, dk, dv))
        n = qf.new_zeros((B, H, dk))
    else:
        S = initial_state[0].to(wide)
        n = initial_state[1].to(wide)
    S_in, n_in = [], []
    for c in range(nc):                 # emit the state *entering* chunk c
        S_in.append(S)
        n_in.append(n)
        g = torch.exp(tot[:, c])        # [B,H]
        S = g[:, :, None, None] * S + chunk_S[:, c]
        n = g[:, :, None] * n + chunk_n[:, c]
    S_in_t = torch.stack(S_in, dim=1)   # [B,nc,H,dk,dv]
    n_in_t = torch.stack(n_in, dim=1)   # [B,nc,H,dk]

    q_dec = qf * torch.exp(ca)[..., None]
    y = y_intra + torch.einsum("bcihk,bchkv->bcihv", q_dec, S_in_t)
    if normalize:
        denom = scores.sum(dim=3) + torch.einsum("bcihk,bchk->bcih", q_dec,
                                                 n_in_t)
        y = y / torch.clamp_min(denom.abs(), 1.0)[..., None]
    return y.reshape(B, T, H, dv).to(v.dtype), (S, n)


def gla_decode_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_decay: torch.Tensor,
                    state: Tuple[torch.Tensor, torch.Tensor], *,
                    normalize: bool = False
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                   torch.Tensor]]:
    """Single-token recurrent step, in f32.  q,k: [B,H,dk]; v: [B,H,dv];
    log_decay: [B,H]; state: (S [B,H,dk,dv], n [B,H,dk])."""
    S, n = state
    qf, kf, vf = (t.float() for t in (q, k, v))
    a = torch.exp(log_decay.float())
    S = a[..., None, None] * S + kf[..., :, None] * vf[..., None, :]
    n = a[..., None] * n + kf
    y = torch.einsum("bhk,bhkv->bhv", qf, S)
    if normalize:
        denom = torch.einsum("bhk,bhk->bh", qf, n).abs()
        y = y / torch.clamp_min(denom, 1.0)[..., None]
    return y.to(v.dtype), (S, n)
