"""The partitioned train step: the counterpart of the reference's
``jax.jit(step, in_shardings=..., out_shardings=...)``.

The reference hands XLA a state and a batch with their shardings, and
its SPMD partitioner writes one program per device with the collectives
in it.  Here every rank is a process of a ``torch.distributed`` group;
the state's leaves are DTensors over an explicit ``DeviceMesh`` with
the placements :mod:`repro_torch.distrib.sharding` gives, and DTensor's
dispatch runs each operation on the local shards, with the collectives
its sharding propagation chooses.  The model's hints
(:func:`repro_torch.models.lm.common.shard_hint` under
:func:`repro_torch.distrib.compat.set_mesh`) steer the activations as
the reference's ``with_sharding_constraint`` steers XLA; the flash
kernel runs on each rank's local heads
(:func:`repro_torch.kernels.ops.flash_attention`).

* :func:`distribute_tree` — each leaf of a tree a DTensor with given
  placements.  A plain leaf is taken as the global value, the same on
  every rank, and each rank keeps its own slice: no collective.
* :func:`partitioned_step` — wraps ``step(state, batch, *args)``: the
  global batch is distributed by ``batch_shardings``; the step runs
  under ``set_mesh(mesh)``; the new state is laid out by
  ``state_shardings`` (the reference's ``out_shardings``), and the
  metrics come back as plain tensors, each rank holding the full value.

Plain constants that the model builds inside the step (RoPE positions,
the loss's accumulators and mask, zeros of unused gradients) meet
DTensor activations there.  They are taken as replicated over the mesh
by ``torch.distributed.tensor.experimental.implicit_replication()``,
entered once around the step's call and nowhere else: the model code
stays as it is.

The mesh's device type is the state's: the tensors stay where they are
(``cuda`` for NCCL, ``cpu`` for gloo).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.device import is_dtensor
from repro_torch.distrib import compat
from repro_torch.tree import tree_map

Tree = Any


def place(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``x`` as a DTensor over ``mesh`` with ``placements``: a DTensor
    redistributed (nothing moves where it has them already), a plain
    tensor cut locally, as the global value every rank holds."""
    from torch.distributed.tensor import distribute_tensor
    placements = tuple(placements)
    if is_dtensor(x):
        if x.placements == placements:
            return x
        return x.redistribute(mesh, placements)
    if x.device.type != mesh.device_type:
        raise ValueError(f"a {x.device.type} tensor on a "
                         f"{mesh.device_type} mesh: the mesh's device type "
                         f"is the state's")
    return distribute_tensor(x, mesh, placements, src_data_rank=None)


def distribute_tree(tree: Tree, mesh, shardings: Tree) -> Tree:
    """Each leaf of ``tree`` as a DTensor with the placements of the
    matching leaf of ``shardings`` (as
    :func:`repro_torch.distrib.sharding.param_shardings` and its kin
    give them)."""
    return tree_map(lambda x, pl: place(x, mesh, pl), tree, shardings)


def _full(x):
    """A metric as a plain tensor holding the full value on every rank."""
    return x.full_tensor() if is_dtensor(x) else x


def partitioned_step(step: Callable, mesh, state_shardings: Tree,
                     batch_shardings: Tree) -> Callable:
    """``step(state, batch, *args) -> (state, metrics)`` partitioned over
    ``mesh``.  The returned step takes the state (DTensors, or plain
    tensors laid out on first use) and a global batch of plain tensors
    (the same on every rank), and returns the new state with exactly
    ``state_shardings``' placements and the metrics as plain, replicated
    tensors.  Every rank of the mesh calls it."""
    from torch.distributed.tensor.experimental import implicit_replication

    def run(state: Dict[str, Tree], batch: Tree, *args):
        state = distribute_tree(state, mesh, state_shardings)
        batch = distribute_tree(batch, mesh, batch_shardings)
        with compat.set_mesh(mesh), implicit_replication():
            state, metrics = step(state, batch, *args)
        return (distribute_tree(state, mesh, state_shardings),
                {k: _full(v) for k, v in metrics.items()})

    return run
