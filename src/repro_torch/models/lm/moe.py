"""Mixture-of-Experts layer: top-k routing, grouped dense dispatch.

The port of :mod:`repro.models.lm.moe`.  Tokens are processed in groups
of ``group_size``; dispatch and combine are one-hot products (the
Switch / Mesh-TF formulation), with capacity dropping and renormalized
top-k gates; optional shared experts (Qwen-MoE) are a plain SwiGLU
applied to every token.  The expert products are plain matmuls: the
reference runs them outside any kernel.

Two details keep the port equal to the reference:

* ``jax.lax.top_k`` puts the lower index first among equal values.  The
  router's logits are computed in the model dtype before the f32
  softmax, so equal probabilities are common in bf16; ``_top_k`` takes
  a stable descending sort, which keeps that order on every device
  (``torch.topk`` does not promise it).
* Dispatch and combine are the reference's one-hot tensors, with no
  intermediate larger than the ``[ng, G, K, E, C]`` position one-hot:
  its sum over the K choices is ``dispatch`` (the expert one-hot the
  reference also multiplies in is 1 wherever the position one-hot is
  nonzero), and the same sum weighted by the gates is ``combine``.
  Each (token, expert) takes at most one choice, so the sums add one
  nonzero term and equal the reference's contractions exactly.

``routing`` lets a check see and set the experts each layer chooses, so
that two runs of one model (a kernel route against the plain one, decode
steps against the forward) can be compared with the same routing: a
last-bit difference in a router logit flips a token's choice, which
moves its output as far as a wrong model would.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.lm.common import (Params, apply_swiglu, init_swiglu,
                                          truncated_normal_init)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared experts (always-on)
    d_ff_shared: int = 0         # total shared ff width
    capacity_factor: float = 1.25
    group_size: int = 1024       # tokens per dispatch group


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype, device=None) -> Params:
    E, Fe = cfg.n_experts, cfg.d_ff_expert
    p: Params = {
        "router": truncated_normal_init(generator, (d_model, E), 1.0,
                                        torch.float32, device),
        "w_gate": truncated_normal_init(generator, (E, d_model, Fe), 1.0,
                                        dtype, device),
        "w_up": truncated_normal_init(generator, (E, d_model, Fe), 1.0,
                                      dtype, device),
        "w_down": truncated_normal_init(generator, (E, Fe, d_model), 1.0,
                                        dtype, device),
    }
    if cfg.n_shared > 0:
        width = cfg.d_ff_shared or cfg.n_shared * Fe
        p["shared"] = init_swiglu(generator, d_model, width, dtype, device)
    return p


# The hook of ``routing``; None outside it.
_route: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@contextlib.contextmanager
def routing(hook: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, every ``apply_moe`` call passes its choices
    (expert ids ``[B, T, K]``, best first) to ``hook`` and routes by the
    ids it returns, each gated by its renormalized probability.  A hook
    that returns its argument changes nothing."""
    global _route
    prev, _route = _route, hook
    try:
        yield
    finally:
        _route = prev


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, the lower index first among equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: MoEConfig, group: int) -> int:
    """Slots per expert and group."""
    return max(int(group * cfg.top_k * cfg.capacity_factor / cfg.n_experts),
               1)


def apply_moe(p: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D]."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = min(cfg.group_size, B * T)
    n_tok = B * T
    if n_tok % G:
        raise ValueError(f"tokens {n_tok} % group {G} != 0")
    ng = n_tok // G
    xg = x.reshape(ng, G, D)

    logits = (xg @ p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                  # [ng, G, E]
    gate_vals, gate_idx = _top_k(probs, K)                 # [ng, G, K]
    if _route is not None:
        gate_idx = _route(gate_idx.reshape(B, T, K)).reshape(ng, G, K)
        gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    C = capacity(cfg, G)
    # one-hot over experts for each of the K choices: [ng, G, K, E]
    onehot = F.one_hot(gate_idx, E).float()
    # position of each (token, choice) within its expert's buffer
    flat = onehot.reshape(ng, G * K, E)
    pos = (torch.cumsum(flat, dim=1) * flat - 1.0).reshape(ng, G, K, E)
    keep = (pos >= 0) & (pos < C)
    pos = pos.clamp(0, C - 1).long()
    pos_onehot = F.one_hot(pos, C).float() * keep[..., None].float()
    # dispatch / combine [ng, G, E, C]: sum_k onehot * pos_onehot (times
    # the choice's gate); pos_onehot is already 0 where onehot is
    dispatch = pos_onehot.sum(dim=2)
    combine = (gate_vals[..., None, None] * pos_onehot).sum(dim=2)
    del pos_onehot

    expert_in = torch.einsum("gsec,gsd->gecd", dispatch.to(xg.dtype), xg)
    h_gate = F.silu(torch.einsum("gecd,edf->gecf", expert_in,
                                 p["w_gate"]).float()).to(xg.dtype)
    h_up = torch.einsum("gecd,edf->gecf", expert_in, p["w_up"])
    h = torch.einsum("gecf,efd->gecd", h_gate * h_up, p["w_down"])
    out = torch.einsum("gsec,gecd->gsd", combine.to(xg.dtype), h)

    if "shared" in p:
        out = out + apply_swiglu(p["shared"], xg)
    return out.reshape(B, T, D)


def router_aux_loss(p: Params, x: torch.Tensor, cfg: MoEConfig
                    ) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean over tokens)."""
    D = x.shape[-1]
    logits = (x.reshape(-1, D) @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    _, idx = _top_k(probs, cfg.top_k)
    frac_tokens = F.one_hot(idx[..., 0], cfg.n_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.n_experts * (frac_tokens * frac_probs).sum()
