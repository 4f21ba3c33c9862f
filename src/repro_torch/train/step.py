"""Train-step builders for the LM runtime.

The port of :mod:`repro.train.step`.  Two gradient-sync modes:

* ``hier_sync=False`` — the classic synchronous step: gradients of
  ``model.loss_fn`` over the whole batch, then one optimizer update.
* ``hier_sync=True`` — HierTrain hybrid parallelism over the pod axis of
  the ambient mesh (:func:`repro_torch.distrib.compat.set_mesh`): each
  rank (pod) computes gradients on its contiguous block of the batch,
  and the cross-pod reduction is the *tiered* sync
  (:func:`repro_torch.distrib.tiered_sync.tiered_grad_sync`) — frontend
  tiers averaged at full width, backend (parameter-heavy) tiers int8-
  quantized — then every rank takes the same optimizer update.

Microbatching (gradient accumulation) splits the batch into ``[k, B/k,
...]`` slices and accumulates their gradients in f32, as the reference's
scan does: activation memory drops k-fold, and loss and gradients are
the means over the k slices.  The slices' loop is
:func:`repro_torch.launch.hlo_analysis.trip_range`: a plain ``range``,
but under the dry run's counter its second slice stands for the other
``k - 1`` (the reference's scan body times its trip count).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import is_dtensor, resolve_device
from repro_torch.distrib import compat
from repro_torch.distrib.sharding import axis_names, axis_size
from repro_torch.distrib.tiered_sync import (TierAssignment, group_mean,
                                             sync_seed, tiered_grad_sync)
from repro_torch.launch.hlo_analysis import trip_range
from repro_torch.models.lm.common import shard_hint, split_shardable
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


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placements: the
    reduce-scatter (sharded leaves) or all-reduce (replicated leaves) of
    a pending sum that XLA's partitioner emits.  A plain gradient as it
    is."""
    if not is_dtensor(g) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _value_and_grad(loss_fn: Callable, params: Tree, batch: Tree
                    ) -> Tuple[torch.Tensor, Tree]:
    """``loss_fn(params, batch)`` and its gradient with respect to every
    leaf of ``params`` (zeros where a leaf is unused), in the leaves'
    dtypes and, for DTensors, placements."""
    leaves = grad_leaves(params)
    loss = loss_fn(leaves, batch)
    return loss.detach(), tree_map(_placed_like, grad(loss, leaves), params)


def _microbatched_grads(loss_fn: Callable, params: Tree, batch: Tree,
                        microbatches: int) -> Tuple[torch.Tensor, Tree]:
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)

    def resh(x):
        x = split_shardable(x, 0, microbatches)
        x = x.reshape((microbatches, x.shape[0] // microbatches)
                      + tuple(x.shape[1:]))
        # the reference keeps each microbatch's batch dim on the DP axes
        return shard_hint(x, None, ("pod", "data"),
                          *([None] * (x.dim() - 2)))

    mb = tree_map(resh, batch)
    # f32 sums, made from the params so that they take their placements
    loss_acc = 0.0
    grad_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    for i in trip_range(microbatches):
        loss, grads = _value_and_grad(loss_fn, params,
                                      tree_map(lambda x: x[i], mb))
        loss_acc = loss_acc + loss
        grad_acc = tree_map(lambda a, g: a + g.float(), grad_acc, grads)
    inv = 1.0 / microbatches
    return loss_acc * inv, tree_map(lambda g: g * inv, grad_acc)


def _pod_block(x: torch.Tensor, rank: int, n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous ``B / n`` block of ``x``'s batch axis,
    as the reference's ``P("pod")`` splits it."""
    if x.shape[0] % n:
        raise ValueError(f"hier_sync: the batch of {x.shape[0]} does not "
                         f"divide over the mesh's {n} pods")
    b = x.shape[0] // n
    return x[rank * b:(rank + 1) * b]


def make_train_step(model, optimizer: Optimizer, *, microbatches: int = 1,
                    hier_sync: bool = False,
                    tiers: Optional[TierAssignment] = None) -> Callable:
    """Returns ``train_step(state, batch, step) -> (state, metrics)`` with
    metrics ``loss``, ``grad_norm`` and ``step`` (the optimizer's count
    after the update).  ``batch`` is a dict of tensors on the params'
    device whose leading axis is the batch; ``step``, the loop's index,
    stands where the reference passes a PRNG key.

    ``hier_sync`` needs a mesh with a ``pod`` axis in scope when the step
    runs (every rank calls it with the same state and global batch);
    ``tiers=None`` under hier_sync is the paper-faithful variant (every
    leaf averaged at full width over the pod axis).  The int8 tier's
    noise is seeded by ``step`` and the pod's rank
    (:func:`repro_torch.distrib.tiered_sync.sync_seed`)."""

    def _grads(params, batch):
        return _microbatched_grads(model.loss_fn, params, batch,
                                   microbatches)

    def _update(state, loss, grads):
        params, opt, gnorm = optimizer.update(state["params"], grads,
                                              state["opt"])
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt["step"]}
        return {"params": params, "opt": opt}, metrics

    def train_step(state: TrainState, batch: Tree, step: int = 0):
        loss, grads = _grads(state["params"], batch)
        return _update(state, loss, grads)

    def hier_step(state: TrainState, batch: Tree, step: int = 0):
        mesh = compat.current_mesh()
        if mesh is None or "pod" not in axis_names(mesh):
            raise ValueError(
                "hier_sync=True needs a mesh with a 'pod' axis in scope "
                "(repro_torch.distrib.compat.set_mesh); got "
                f"{'no mesh' if mesh is None else axis_names(mesh)}")
        n, rank = axis_size(mesh, "pod"), int(mesh.get_local_rank("pod"))
        local = tree_map(lambda x: _pod_block(x, rank, n), batch)
        loss, grads = _grads(state["params"], local)
        grads = tiered_grad_sync(grads, tiers, sync_seed(step, rank))
        loss = group_mean(loss, mesh.get_group("pod"), n)
        return _update(state, loss, grads)

    return hier_step if hier_sync else train_step
