"""Mamba2 (SSD) block on top of the chunked GLA primitive.

The port of :mod:`repro.models.lm.ssm`: the training path, and the
serving path's prefill, cache and single-token decode.  Structure per
block (pre-norm residual):
in_proj -> [z | xBC | dt]; depthwise causal conv4 + silu on xBC; SSD
recurrence (q=C, k=dt*B, v=x heads, decay=exp(-exp(A_log)*dt)); skip
D*x; gate y*silu(z); RMSNorm; out_proj.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import (Params, rms_norm,
                                          truncated_normal_init)
from repro_torch.models.lm.gla import chunked_gla, gla_decode_step


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128


def d_inner(d_model: int, cfg: SSMConfig) -> int:
    return cfg.expand * d_model


def n_ssm_heads(d_model: int, cfg: SSMConfig) -> int:
    return d_inner(d_model, cfg) // cfg.head_dim


def init_mamba2(generator: torch.Generator, d_model: int, cfg: SSMConfig,
                dtype: torch.dtype, device=None) -> Params:
    di = d_inner(d_model, cfg)
    nh = n_ssm_heads(d_model, cfg)
    conv_ch = di + 2 * cfg.d_state

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)
    return {
        "in_proj": truncated_normal_init(
            generator, (d_model, 2 * di + 2 * cfg.d_state + nh), 1.0, dtype,
            device),
        "conv_w": truncated_normal_init(generator, (cfg.d_conv, conv_ch),
                                        1.0, dtype, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": full(nh, 0.0),                     # A = -exp(A_log) = -1
        "dt_bias": full(nh, -2.0),
        "D_skip": full(nh, 1.0),
        "norm_w": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": truncated_normal_init(generator, (di, d_model), 1.0,
                                          dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along T.  x: [B,T,C]; w: [K,C]; prev:
    [B,K-1,C] carried state.  Returns (y [B,T,C], new_state [B,K-1,C])."""
    K = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)                 # [B, T+K-1, C]
    T = x.shape[1]
    # a sum of shifted scalings (K is tiny, e.g. 4), in the JAX order
    y = xp[:, 0:T, :] * w[0][None, None, :]
    for i in range(1, K):
        y = y + xp[:, i:i + T, :] * w[i][None, None, :]
    return y + b, xp[:, T:, :]


def _mamba2_forward(p: Params, x: torch.Tensor, cfg: SSMConfig,
                    conv_prev: Optional[torch.Tensor] = None,
                    use_kernel: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared fwd path.  Returns (y, new_conv_state, final_S)."""
    B, T, D = x.shape
    di = d_inner(D, cfg)
    nh = di // cfg.head_dim
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * cfg.d_state]
    dt_pre = zxbcdt[..., -nh:].float()
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 prev=conv_prev)
    xBC = F.silu(xBC.float()).to(x.dtype)
    xin = xBC[..., :di]
    Bmat = xBC[..., di:di + cfg.d_state]
    Cmat = xBC[..., di + cfg.d_state:]
    dt = F.softplus(dt_pre + p["dt_bias"])                    # [B,T,nh]
    log_decay = -torch.exp(p["A_log"])[None, None, :] * dt    # [B,T,nh]

    v = xin.reshape(B, T, nh, cfg.head_dim)
    # the broadcasts over heads become copies in the kernel's [B*H, T, d]
    # layout (ops.gla_scan)
    k = (Bmat[:, :, None, :] * dt[..., None]).to(x.dtype)
    q = Cmat[:, :, None, :].to(x.dtype).expand(B, T, nh, cfg.d_state)
    y, (S_fin, _) = chunked_gla(q, k.expand(B, T, nh, cfg.d_state), v,
                                log_decay, chunk=cfg.chunk,
                                use_kernel=use_kernel)
    y = y + v * p["D_skip"][None, None, :, None].to(v.dtype)
    y = y.reshape(B, T, di)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y, p["norm_w"])
    return y @ p["out_proj"], new_conv, S_fin


def apply_mamba2(p: Params, x: torch.Tensor, cfg: SSMConfig,
                 use_kernel: bool = False) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D] (training path)."""
    y, _, _ = _mamba2_forward(p, x, cfg, use_kernel=use_kernel)
    return y


def prefill_mamba2(p: Params, x: torch.Tensor, cfg: SSMConfig,
                   use_kernel: bool = False) -> Tuple[torch.Tensor, Params]:
    """Prefill path: also return the recurrent cache for decode."""
    y, conv, S = _mamba2_forward(p, x, cfg, use_kernel=use_kernel)
    return y, {"conv": conv, "S": S}


def init_mamba2_cache(batch: int, d_model: int, cfg: SSMConfig,
                      dtype: torch.dtype, device=None) -> Params:
    """conv ``[B, d_conv-1, di+2*d_state]`` in ``dtype``; S ``[B, nh,
    d_state, head_dim]`` in f32."""
    di = d_inner(d_model, cfg)
    nh = di // cfg.head_dim
    conv_ch = di + 2 * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "S": torch.zeros((batch, nh, cfg.d_state, cfg.head_dim),
                         dtype=torch.float32, device=device),
    }


def decode_mamba2(p: Params, x: torch.Tensor, cache: Params, cfg: SSMConfig
                  ) -> Tuple[torch.Tensor, Params]:
    """x: [B, 1, D] single-token step with recurrent state."""
    B, _, D = x.shape
    di = d_inner(D, cfg)
    nh = di // cfg.head_dim
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * cfg.d_state]
    dt_pre = zxbcdt[..., -nh:].float()
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                 prev=cache["conv"])
    xBC = F.silu(xBC.float()).to(x.dtype)
    xin = xBC[..., :di]
    Bmat = xBC[..., di:di + cfg.d_state]
    Cmat = xBC[..., di + cfg.d_state:]
    dt = F.softplus(dt_pre + p["dt_bias"])[:, 0]              # [B,nh]
    log_decay = -torch.exp(p["A_log"])[None, :] * dt

    v = xin.reshape(B, nh, cfg.head_dim)
    k = (Bmat[:, 0, None, :] * dt[..., None]).to(x.dtype)
    q = Cmat[:, 0, None, :].to(x.dtype).expand(B, nh, cfg.d_state)
    n_dummy = torch.zeros((B, nh, cfg.d_state), dtype=torch.float32,
                          device=x.device)
    y, (S_new, _) = gla_decode_step(q, k, v, log_decay,
                                    (cache["S"], n_dummy))
    y = y + v * p["D_skip"][None, :, None].to(v.dtype)
    y = y.reshape(B, 1, di)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rms_norm(y, p["norm_w"])
    return y @ p["out_proj"], {"conv": new_conv, "S": S_new}
