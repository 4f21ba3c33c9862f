"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel via GLA) and sLSTM
(scalar memory, strictly recurrent over time).

The port of :mod:`repro.models.lm.xlstm`, with the reference's
simplifications (DESIGN.md): the mLSTM input gate is clamped to [-8, 8]
instead of carrying the running max-stabilizer (the GLA normalizer
bounds the output); the sLSTM keeps the standard log-space stabilizer.
The mLSTM runs ``chunked_gla`` with ``normalize=True`` (the CUDA GLA
kernel under ``use_kernel``) and ``gla_decode_step``; the sLSTM is a
loop over time steps where the reference scans.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import (Params, rms_norm,
                                          truncated_normal_init)
from repro_torch.models.lm.gla import chunked_gla, gla_decode_step
from repro_torch.models.lm.ssm import _causal_conv


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    expand: int = 2          # mLSTM inner expansion
    d_conv: int = 4
    slstm_every: int = 6     # every k-th block is an sLSTM (0 = never)
    chunk: int = 128


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(generator: torch.Generator, d_model: int, cfg: XLSTMConfig,
               dtype: torch.dtype, device=None) -> Params:
    di = cfg.expand * d_model
    H = cfg.n_heads

    def normal(shape, dt=dtype):
        return truncated_normal_init(generator, shape, 1.0, dt, device)

    def full(n, value, dt):
        return torch.full((n,), value, dtype=dt, device=device)
    return {
        "up_proj": normal((d_model, 2 * di)),
        "conv_w": normal((cfg.d_conv, di)),
        "conv_b": full(di, 0.0, dtype),
        "wq": normal((di, di)),
        "wk": normal((di, di)),
        "wv": normal((di, di)),
        "w_gates": normal((di, 2 * H), torch.float32),
        "b_igate": full(H, 0.0, torch.float32),
        "b_fgate": full(H, 3.0, torch.float32),
        "norm_w": full(di, 0.0, dtype),
        "down_proj": normal((di, d_model)),
    }


def _mlstm_qkv_gates(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
                     conv_state: Optional[torch.Tensor] = None):
    B, T, D = x.shape
    H = cfg.n_heads
    di = cfg.expand * D
    hd = di // H
    up = x @ p["up_proj"]
    xin, z = up[..., :di], up[..., di:]
    cx, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                prev=conv_state)
    cx = F.silu(cx.float()).to(x.dtype)
    q = (cx @ p["wq"]).reshape(B, T, H, hd)
    # k / sqrt(hd) in the model dtype, by a divisor on the device (CUDA
    # turns a division by a host scalar into a multiply by its reciprocal)
    root = torch.sqrt(torch.full((), hd, dtype=torch.float32,
                                 device=x.device)).to(x.dtype)
    k = (cx @ p["wk"]).reshape(B, T, H, hd) / root
    v = (xin @ p["wv"]).reshape(B, T, H, hd)
    gates = xin.float() @ p["w_gates"]                     # [B, T, 2H]
    ig = torch.clamp(gates[..., :H] + p["b_igate"], -8.0, 8.0)
    fg = gates[..., H:] + p["b_fgate"]
    log_decay = F.logsigmoid(fg)
    k = k * torch.exp(ig).to(k.dtype)[..., None]
    return q, k, v, log_decay, z, new_conv


def _mlstm_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    B, T = y.shape[:2]
    y = rms_norm(y.reshape(B, T, -1), p["norm_w"])
    y = y * F.silu(z.float()).to(y.dtype)
    return y @ p["down_proj"]


def apply_mlstm(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
                use_kernel: bool = False) -> torch.Tensor:
    q, k, v, log_decay, z, _ = _mlstm_qkv_gates(p, x, cfg)
    y, _ = chunked_gla(q, k, v, log_decay, chunk=cfg.chunk, normalize=True,
                       use_kernel=use_kernel)
    return _mlstm_out(p, y, z)


def prefill_mlstm(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
                  use_kernel: bool = False) -> Tuple[torch.Tensor, Params]:
    """Prefill: also return the recurrent cache for decode."""
    q, k, v, log_decay, z, new_conv = _mlstm_qkv_gates(p, x, cfg)
    y, (S, n) = chunked_gla(q, k, v, log_decay, chunk=cfg.chunk,
                            normalize=True, use_kernel=use_kernel)
    return _mlstm_out(p, y, z), {"conv": new_conv, "S": S, "n": n}


def init_mlstm_cache(batch: int, d_model: int, cfg: XLSTMConfig,
                     dtype: torch.dtype, device=None) -> Params:
    di = cfg.expand * d_model
    hd = di // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "S": torch.zeros((batch, cfg.n_heads, hd, hd), **f32),
        "n": torch.zeros((batch, cfg.n_heads, hd), **f32),
    }


def decode_mlstm(p: Params, x: torch.Tensor, cache: Params,
                 cfg: XLSTMConfig) -> Tuple[torch.Tensor, Params]:
    q, k, v, log_decay, z, new_conv = _mlstm_qkv_gates(
        p, x, cfg, conv_state=cache["conv"])
    y, (S, n) = gla_decode_step(q[:, 0], k[:, 0], v[:, 0], log_decay[:, 0],
                                (cache["S"], cache["n"]), normalize=True)
    return _mlstm_out(p, y[:, None], z), {"conv": new_conv, "S": S, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(generator: torch.Generator, d_model: int, cfg: XLSTMConfig,
               dtype: torch.dtype, device=None) -> Params:
    hd = d_model // cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": truncated_normal_init(generator, (d_model, 4 * d_model), 1.0,
                                      torch.float32, device),
        "r": truncated_normal_init(generator, (cfg.n_heads, hd, 4 * hd), 1.0,
                                   torch.float32, device),
        "b": torch.cat([torch.zeros((d_model,), **f32),       # i
                        torch.full((d_model,), 3.0, **f32),   # f
                        torch.zeros((2 * d_model,), **f32)]),  # z, o
        "norm_w": torch.zeros((d_model,), dtype=dtype, device=device),
        "out_proj": truncated_normal_init(generator, (d_model, d_model), 1.0,
                                          dtype, device),
    }


def _slstm_cell(carry, gates_x: torch.Tensor, r: torch.Tensor):
    """One time step.  carry = (c, n, h, m), each [B, nh, hd] f32."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hdg->bhg", h, r)              # [B, nh, 4hd]
    it, ft, zt, ot = (gates_x + rec).chunk(4, dim=-1)
    m_new = torch.maximum(ft + m, it)
    i = torch.exp(it - m_new)
    f = torch.exp(ft + m - m_new)
    c_new = f * c + i * torch.tanh(zt)
    n_new = f * n + i
    h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_gates(p: Params, x: torch.Tensor, nh: int) -> torch.Tensor:
    """Input gates [B, T, nh, 4 hd] in f32, regrouped per head."""
    B, T, D = x.shape
    hd = D // nh
    gx = x.float() @ p["w_in"] + p["b"]                    # [B, T, 4D]
    return gx.reshape(B, T, 4, nh, hd).permute(0, 1, 3, 2, 4).reshape(
        B, T, nh, 4 * hd)


def _slstm_out(p: Params, hs: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
    B, T = hs.shape[:2]
    y = rms_norm(hs.reshape(B, T, -1).to(dtype), p["norm_w"])
    return y @ p["out_proj"]


def _slstm_forward(p: Params, x: torch.Tensor, cfg: XLSTMConfig,
                   carry: Optional[Tuple] = None):
    """Strictly sequential over T.  Returns (y, final_carry)."""
    B, _, D = x.shape
    nh = cfg.n_heads
    gx = _slstm_gates(p, x, nh)
    if carry is None:
        zeros = x.new_zeros((B, nh, D // nh), dtype=torch.float32)
        carry = (zeros, zeros, zeros, zeros)
    hs = []
    # unbind, not gx[:, t]: under autograd each indexed step's backward
    # writes a zero tensor of gx's full size, T of them a sequence
    for gxt in gx.unbind(1):
        carry, h = _slstm_cell(carry, gxt, p["r"])
        hs.append(h)
    return _slstm_out(p, torch.stack(hs, dim=1), x.dtype), carry


def apply_slstm(p: Params, x: torch.Tensor, cfg: XLSTMConfig
                ) -> torch.Tensor:
    y, _ = _slstm_forward(p, x, cfg)
    return y


def prefill_slstm(p: Params, x: torch.Tensor, cfg: XLSTMConfig
                  ) -> Tuple[torch.Tensor, Params]:
    y, (c, n, h, m) = _slstm_forward(p, x, cfg)
    return y, {"c": c, "n": n, "h": h, "m": m}


def init_slstm_cache(batch: int, d_model: int, cfg: XLSTMConfig,
                     device=None) -> Params:
    shape = (batch, cfg.n_heads, d_model // cfg.n_heads)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("c", "n", "h", "m")}


def decode_slstm(p: Params, x: torch.Tensor, cache: Params,
                 cfg: XLSTMConfig) -> Tuple[torch.Tensor, Params]:
    gx = _slstm_gates(p, x, cfg.n_heads)[:, 0]
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, h, m), h_out = _slstm_cell(carry, gx, p["r"])
    return _slstm_out(p, h_out[:, None], x.dtype), \
        {"c": c, "n": n, "h": h, "m": m}
