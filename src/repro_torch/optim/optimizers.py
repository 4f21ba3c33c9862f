"""Optimizers built from tensor operations (no ``torch.optim``).

The port of :mod:`repro.optim.optimizers`.  State has the parameters'
structure (nested dicts and lists of tensors) with f32 leaves of the
same shapes, plus an int32 ``step``; ``update`` is functional and
returns new params and state.

* :class:`SGDMomentum` — f32 momentum, direct update of the parameter
  in its own dtype.
* :class:`AdamW` — f32 first and second moments, decoupled weight decay,
  bias correction by the step count.

Both clip by the global norm; updates run in f32 and are cast back to
the parameter dtype (bf16 training without master weights).  Every
division by a value the reference divides by is a division by a tensor:
CUDA turns a division by a host scalar into a multiply by its
reciprocal.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.tree import leaves, tree_map, unzip

Params = Any
OptState = Dict[str, Any]


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves(tree)))


def _clipped(grads: Params, clip: float) -> Tuple[Params, torch.Tensor]:
    gnorm = global_norm(grads)
    if clip <= 0:
        return grads, gnorm
    scale = torch.clamp(torch.full_like(gnorm, clip)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    # in f32, as the reference's promotion of bf16 * f32 gives
    return tree_map(lambda g: g.float() * scale, grads), gnorm


def _zeros_f32(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def _step0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=leaves(params)[0].device)


@dataclasses.dataclass(frozen=True)
class SGDMomentum:
    lr: float = 1e-2
    momentum: float = 0.9
    clip_norm: float = 1.0
    weight_decay: float = 0.0

    def init(self, params: Params) -> OptState:
        return {"m": _zeros_f32(params), "step": _step0(params)}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: OptState,
               lr_scale: Union[torch.Tensor, float] = 1.0
               ) -> Tuple[Params, OptState, torch.Tensor]:
        grads, gnorm = _clipped(grads, self.clip_norm)

        def upd(p, g, m):
            g = g.float()
            if self.weight_decay:
                g = g + self.weight_decay * p.float()
            m = self.momentum * m + g
            new_p = p.float() - self.lr * lr_scale * m
            return new_p.to(p.dtype), m

        new_params, new_m = unzip(tree_map(upd, params, grads, state["m"]), 2)
        return new_params, {"m": new_m, "step": state["step"] + 1}, gnorm


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> OptState:
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "step": _step0(params)}

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: OptState,
               lr_scale: Union[torch.Tensor, float] = 1.0
               ) -> Tuple[Params, OptState, torch.Tensor]:
        grads, gnorm = _clipped(grads, self.clip_norm)
        step = state["step"] + 1
        # f32 tensors, divided by below as tensors (see the module doc)
        c1 = 1.0 - torch.pow(self.b1, step.float())
        c2 = 1.0 - torch.pow(self.b2, step.float())

        def upd(p, g, m, v):
            g = g.float()
            m = self.b1 * m + (1 - self.b1) * g
            v = self.b2 * v + (1 - self.b2) * g * g
            mhat = m / c1
            vhat = v / c2
            pf = p.float()
            new_p = pf - self.lr * lr_scale * (
                mhat / (torch.sqrt(vhat) + self.eps)
                + self.weight_decay * pf)
            return new_p.to(p.dtype), m, v

        new_params, new_m, new_v = unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_params, {"m": new_m, "v": new_v, "step": step}, gnorm


Optimizer = Union[SGDMomentum, AdamW]


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgdm":
        return SGDMomentum(**kw)
    if name == "adamw":
        return AdamW(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
