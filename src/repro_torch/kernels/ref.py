"""Plain PyTorch versions of the port's kernels (kernel-native layouts).

Each function is the simplest correct implementation of its kernel's
contract.  The wrappers use it for tensors on the CPU, and the chip
smoke run holds each kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

NEG_INF = -1e30


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or wider if it already is (f64 for gradcheck)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def ref_quantize_int8(x: torch.Tensor, noise: Union[torch.Tensor, float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise absmax int8 quantization of ``x [M, N]`` with supplied
    uniform noise (an f32 ``[M, N]`` tensor, or one constant).  Returns
    ``(q int8 [M, N], scale f32 [M])``.

    Every division is by a tensor: PyTorch turns a division by a Python
    scalar into a multiply by its reciprocal on the card, which is not
    the IEEE quotient the kernel computes."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-30) / torch.full_like(absmax, 127.0)
    u = noise.float() if isinstance(noise, torch.Tensor) else float(noise)
    q = torch.floor(xf / scale + u).clamp_(-127.0, 127.0).nan_to_num_(0.0)
    return q.to(torch.int8), scale[:, 0]


def ref_wire_qdq_int8(x: torch.Tensor) -> torch.Tensor:
    """The int8 wire's round trip on ``x [M, N]``: quantize with the
    noise pinned at 0.5, dequantize in f32, round back to ``x``'s
    dtype."""
    q, scale = ref_quantize_int8(x, 0.5)
    return (q.float() * scale[:, None]).to(x.dtype)


def ref_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax attention with GQA.  q: [BH, T, hd]; k/v: [BKV, S, hd]
    (query head ``h`` reads KV head ``h // rep``).  Masked scores are
    -1e30.  Returns (o [BH, T, hd] in q's dtype, lse f32 [BH, T])."""
    BH, T, hd = q.shape
    BKV, S, _ = k.shape
    rep = BH // BKV
    scale = 1.0 / (hd ** 0.5)
    qf = _wide(q).reshape(BKV, rep, T, hd) * scale
    s = torch.einsum("brth,bsh->brts", qf, _wide(k))
    qpos = torch.arange(T, device=q.device)
    kpos = torch.arange(S, device=q.device)
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("brts,bsh->brth", p, _wide(v))
    return o.reshape(BH, T, hd).to(q.dtype), lse.reshape(BH, T)


def ref_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            log_decay: torch.Tensor, *, normalize: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gated linear recurrence step by step (its definition), zero
    initial state.  q/k: [BH, T, dk]; v: [BH, T, dv]; log_decay: [BH, T].
    Returns (y [BH, T, dv] in v's dtype, S f32 [BH, dk, dv], n f32
    [BH, dk])."""
    BH, T, dk = q.shape
    dv = v.shape[-1]
    qf, kf, vf = _wide(q), _wide(k), _wide(v)
    g = torch.exp(_wide(log_decay))
    S = qf.new_zeros((BH, dk, dv))
    n = qf.new_zeros((BH, dk))
    ys = []
    for t in range(T):
        gt = g[:, t, None]
        S = gt[..., None] * S + kf[:, t, :, None] * vf[:, t, None, :]
        n = gt * n + kf[:, t]
        y = torch.einsum("bk,bkv->bv", qf[:, t], S)
        if normalize:
            den = torch.einsum("bk,bk->b", qf[:, t], n).abs()
            y = y / torch.clamp_min(den, 1.0)[:, None]
        ys.append(y)
    y = torch.stack(ys, dim=1) if ys else vf.new_zeros((BH, 0, dv))
    return y.to(v.dtype), S, n
