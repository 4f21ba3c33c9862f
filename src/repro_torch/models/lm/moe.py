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
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor
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


def _groups(x: torch.Tensor, ng: int, G: int) -> torch.Tensor:
    """``x [B, T, D]`` as ``ng`` groups of ``G`` consecutive tokens of the
    global batch, ``[ng, G, D]``.  A DTensor whose batch split cuts a
    group is gathered over the axes that split it first: each rank then
    routes whole groups, as the reference's, never a per-rank part of
    one (which would change the capacity and the dropped tokens)."""
    B, T, D = x.shape
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        mesh = x.device_mesh
        split = [i for i, p in enumerate(x.placements) if p.is_shard(0)]
        whole = ng % math.prod(mesh.size(i) for i in split) == 0
        # whole sequences (a sequence-parallel T is gathered), and the
        # batch split kept only where it cuts no group
        pl = tuple(p if p.is_shard(0) and whole else Replicate()
                   for p in x.placements)
        if pl != x.placements:
            x = x.redistribute(mesh, pl)
    return x.reshape(ng, G, D)


def _dispatch(probs: torch.Tensor, cfg: MoEConfig, route=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dispatch`` and ``combine`` ``[ng, G, E, C]`` of plain router
    probabilities ``[ng, G, E]``: the top-k choices (or those ``route``
    returns, given them as ``[ng, G, K]`` ids), their renormalized gates,
    each (token, choice)'s slot in its expert's buffer and the capacity
    drop."""
    ng, G, E = probs.shape
    K = cfg.top_k
    gate_vals, gate_idx = _top_k(probs, K)                 # [ng, G, K]
    if route is not None:
        gate_idx = route(gate_idx)
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
    return dispatch, combine


def _dispatch_on_shards(probs: torch.Tensor, B: int, T: int,
                        cfg: MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_dispatch` of DTensor probabilities on each rank's local
    groups: the experts gathered (a rank routes a token over all of
    them), the groups as :func:`_groups` laid them out.  The routing
    hook sees the global ``[B, T, K]`` ids (gathered) and each rank takes
    its groups' rows of what it returns.  dispatch and combine come back
    as DTensors of the groups' layout; combine's gradient reaches the
    router through the local probabilities."""
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)
    mesh = probs.device_mesh
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(2) else p
               for p in probs.placements)
    route = None
    if _route is not None:
        def route(idx):
            full = DTensor.from_local(idx, mesh, pl, run_check=False)
            got = _route(full.full_tensor().reshape(B, T, -1))
            return distribute_tensor(got.reshape(full.shape), mesh, pl,
                                     src_data_rank=None).to_local()
    dispatch, combine = _dispatch(probs.redistribute(mesh, pl).to_local(),
                                  cfg, route)
    return tuple(DTensor.from_local(t, mesh, pl, run_check=False)
                 for t in (dispatch, combine))


def apply_moe(p: Params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D].  On DTensors the routing runs on each
    rank's local groups (:func:`_dispatch_on_shards`) and the expert
    products on DTensors, the weights as the sharding rules lay them
    out."""
    B, T, D = x.shape
    G = min(cfg.group_size, B * T)
    n_tok = B * T
    if n_tok % G:
        raise ValueError(f"tokens {n_tok} % group {G} != 0")
    ng = n_tok // G
    xg = _groups(x, ng, G)

    logits = (xg @ p["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                  # [ng, G, E]
    if is_dtensor(probs):
        dispatch, combine = _dispatch_on_shards(probs, B, T, cfg)
    else:
        route = None if _route is None else (
            lambda idx: _route(idx.reshape(B, T, -1)).reshape(idx.shape))
        dispatch, combine = _dispatch(probs, cfg, route)

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
    """Switch-style load-balancing auxiliary loss (mean over tokens).  On
    DTensors each rank counts its own tokens' first choices, the counts
    summed over the ranks that split the tokens."""
    D = x.shape[-1]
    logits = (x.reshape(-1, D) @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    if is_dtensor(probs):
        frac_tokens = _first_choice_counts(probs, cfg) / probs.shape[0]
    else:
        _, idx = _top_k(probs, cfg.top_k)
        frac_tokens = F.one_hot(idx[..., 0], cfg.n_experts).float().mean(
            dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.n_experts * (frac_tokens * frac_probs).sum()


def _first_choice_counts(probs: torch.Tensor, cfg: MoEConfig
                         ) -> torch.Tensor:
    """The number of tokens whose first choice is each expert, ``[E]``,
    of DTensor probabilities ``[N, E]``: each rank counts its rows, a
    pending sum over the mesh dims that split them."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = probs.device_mesh
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(1) else p
               for p in probs.placements)
    _, idx = _top_k(probs.redistribute(mesh, pl).to_local(), cfg.top_k)
    counts = F.one_hot(idx[..., 0], cfg.n_experts).float().sum(dim=0)
    return DTensor.from_local(counts, mesh, tuple(
        Partial() if p.is_shard(0) else Replicate() for p in pl),
        run_check=False)
