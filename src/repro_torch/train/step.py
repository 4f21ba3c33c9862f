"""Train-step builder for the single-process LM runtime.

The port of :mod:`repro.train.step` without its multi-process mode:
``make_train_step(model, optimizer)`` returns the classic synchronous
step (``hier_sync=False``): gradients of ``model.loss_fn`` over the
whole batch, then one optimizer update.  ``hier_sync=True`` (the tiered
cross-pod gradient sync) raises until ``distrib/`` is ported.

Microbatching (gradient accumulation) splits the batch into ``[k, B/k,
...]`` slices and accumulates their gradients in f32, as the reference's
scan does: activation memory drops k-fold, and loss and gradients are
the means over the k slices.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import grad, grad_leaves, tree_map

Tree = Any
TrainState = Dict[str, Tree]        # {"params": ..., "opt": ...}


def init_state(model, optimizer: Optimizer, generator: torch.Generator,
               device=None) -> TrainState:
    """Params from ``model.init(generator, device)`` and the optimizer's
    state for them, on ``device`` (default ``cuda``; raises when there is
    none)."""
    params = model.init(generator, resolve_device(device))
    return {"params": params, "opt": optimizer.init(params)}


def _value_and_grad(loss_fn: Callable, params: Tree, batch: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
    """``loss_fn(params, batch)`` and its gradient with respect to every
    leaf of ``params`` (zeros where a leaf is unused), in the leaves'
    dtypes."""
    leaves = grad_leaves(params)
    loss = loss_fn(leaves, batch)
    return loss.detach(), grad(loss, leaves)


def _microbatched_grads(loss_fn: Callable, params: Tree, batch: Tree,
                        microbatches: int) -> Tuple[torch.Tensor, Tree]:
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)

    def resh(x):
        return x.reshape((microbatches, x.shape[0] // microbatches)
                         + tuple(x.shape[1:]))

    mb = tree_map(resh, batch)
    loss_acc, grad_acc = 0.0, tree_map(lambda p: 0.0, params)   # f32 sums
    for i in range(microbatches):
        loss, grads = _value_and_grad(loss_fn, params,
                                      tree_map(lambda x: x[i], mb))
        loss_acc = loss_acc + loss
        grad_acc = tree_map(lambda a, g: a + g.float(), grad_acc, grads)
    inv = 1.0 / microbatches
    return loss_acc * inv, tree_map(lambda g: g * inv, grad_acc)


def make_train_step(model, optimizer: Optimizer, *, microbatches: int = 1,
                    hier_sync: bool = False) -> Callable:
    """Returns ``train_step(state, batch, step) -> (state, metrics)`` with
    metrics ``loss``, ``grad_norm`` and ``step`` (the optimizer's count
    after the update).  ``batch`` is a dict of tensors on the params'
    device whose leading axis is the batch; ``step``, the loop's index,
    stands where the reference passes a PRNG key, which its
    single-process step does not use either."""
    if hier_sync:
        raise NotImplementedError(
            "hier_sync=True (the tiered cross-pod gradient sync) needs "
            "distrib/, which is not ported yet (ROADMAP.md, queue 1 item "
            "4)")

    def train_step(state: TrainState, batch: Tree, step: int = 0):
        loss, grads = _microbatched_grads(model.loss_fn, state["params"],
                                          batch, microbatches)
        params, opt, gnorm = optimizer.update(state["params"], grads,
                                              state["opt"])
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt["step"]}
        return {"params": params, "opt": opt}, metrics

    return train_step
