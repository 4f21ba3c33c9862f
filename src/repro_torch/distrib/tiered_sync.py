"""HierTrain tiered gradient synchronization over the pod axis.

The port of :mod:`repro.distrib.tiered_sync` on ``torch.distributed``.
The inter-pod link plays the WAN: "frontend" parameter tiers are
averaged at full width every step, while "backend" tiers — the
parameter-heavy leaves — cross the slow link int8-quantized with
stochastic rounding (unbiased, so synchronous-SGD semantics hold in
expectation).

Tier assignment is cost-model-driven: given the link's budget, greedily
demote the largest leaves to the compressed tier until the predicted
sync time fits ``max_sync_fraction`` of the compute time.

Wire-format accounting (per step, per parameter byte tier):

    frontend: ring all-reduce, 2 (P-1)/P * 4 B/param (f32)
    backend:  all-gather of int8 + per-row scales,
              (P-1)/P * (elems + 4 * rows) B/leaf

The per-leaf byte count is single-sourced from
:func:`repro_torch.core.wire.int8_leaf_bytes`, so the predicted sync
time and the bytes :func:`_compressed_mean` ships cannot drift apart.

Each rank is a process holding its own gradients; the collectives are
explicit calls on the process group of a mesh axis
(:mod:`repro_torch.distrib.compat`).  The full-width tier is a SUM
``all_reduce`` then a division by the group's size in the leaf's dtype
(the reference's ``pmean`` is ``psum / n``).  The int8 tier quantizes
through :func:`repro_torch.kernels.ops.quantize_int8` (the CUDA
quantizer on the card, its plain version on the CPU) and all-gathers
the codes and the row scales.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.wire import int8_leaf_bytes
from repro_torch.distrib import compat
from repro_torch.distrib.sharding import _shape, axis_names, axis_size
from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves, tree_map, unflatten

Tree = Any


@dataclasses.dataclass
class TierAssignment:
    quantized: Tree                  # tree of bool, True = backend tier
    front_bytes: int
    back_bytes: int                  # f32 bytes of the demoted leaves
    back_wire_bytes: float           # their int8 payload + row scales
    sync_seconds: float              # predicted link time per step

    @property
    def total_bytes(self) -> int:
        return self.front_bytes + self.back_bytes

    def describe(self) -> str:
        return (f"front={self.front_bytes/1e9:.2f}GB "
                f"back(int8)={self.back_wire_bytes/1e9:.2f}GB wire "
                f"predicted sync={self.sync_seconds*1e3:.1f}ms")


def _leaf_bytes(shape) -> int:
    return int(np.prod(shape)) * 4          # grads sync in f32


def choose_tiers(param_shapes: Tree, *, n_pods: int,
                 dcn_bytes_per_s: float = 25e9,
                 compute_seconds: float = 1.0,
                 max_sync_fraction: float = 0.25) -> TierAssignment:
    """Greedy Algorithm-1-style tier choice: demote largest leaves to the
    int8 tier until predicted sync time fits the budget.  ``param_shapes``
    is a tree of shapes, tensors or meta tensors."""
    shapes = [_shape(l) for l in leaves(param_shapes)]
    sizes = [_leaf_bytes(s) for s in shapes]
    wire_sizes = [int8_leaf_bytes(s) for s in shapes]
    order = np.argsort(sizes)[::-1]
    ring = 2.0 * (n_pods - 1) / n_pods
    gather = 1.0 * (n_pods - 1) / n_pods

    quant = [False] * len(shapes)

    def sync_time():
        f = sum(s for s, q in zip(sizes, quant) if not q)
        b = sum(w for w, q in zip(wire_sizes, quant) if q)
        return (f * ring + b * gather) / dcn_bytes_per_s

    budget = max_sync_fraction * compute_seconds
    for i in order:
        if sync_time() <= budget:
            break
        quant[i] = True
    fb = sum(s for s, q in zip(sizes, quant) if not q)
    bb = sum(s for s, q in zip(sizes, quant) if q)
    bw = sum(w for w, q in zip(wire_sizes, quant) if q)
    return TierAssignment(
        quantized=unflatten(param_shapes, iter(quant)),
        front_bytes=fb, back_bytes=bb, back_wire_bytes=bw,
        sync_seconds=sync_time())


def _as_2d(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    shape = tuple(x.shape)
    if x.dim() >= 2:
        return x.reshape(-1, shape[-1]), shape
    return x.reshape(1, -1), shape


def _group(mesh, axis: str):
    """``(process group, size)`` of mesh axis ``axis``."""
    if mesh is None or axis not in axis_names(mesh):
        raise ValueError(f"tiered_grad_sync needs a mesh with a {axis!r} "
                         f"axis in scope; got axes {axis_names(mesh)}")
    return mesh.get_group(axis), axis_size(mesh, axis)


def group_mean(g: torch.Tensor, group, n: int) -> torch.Tensor:
    """``psum / n`` in ``g``'s dtype (a division by a device tensor: CUDA
    turns a division by a host scalar into a multiply by its
    reciprocal)."""
    out = g.clone(memory_format=torch.contiguous_format)   # for NCCL
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / out.new_full((), n)


def _compressed_mean(g: torch.Tensor, generator: torch.Generator, group,
                     n: int) -> torch.Tensor:
    """Unbiased int8 all-gather mean over ``group`` (``n`` ranks)."""
    g2, shape = _as_2d(g.float())
    q, scale = kops.quantize_int8(g2.contiguous(), generator)
    del g2
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)            # [P, rows, cols] int8
    dist.all_gather(ss, scale, group=group)        # [P, rows]
    del q, scale
    deq = torch.stack(qs).float() * torch.stack(ss)[..., None]
    del qs, ss
    return torch.mean(deq, dim=0).reshape(shape).to(g.dtype)


def sync_seed(step: int, rank: int) -> int:
    """The seed of the int8 tier's noise at ``step`` on pod ``rank`` (the
    reference folds the pod index into the step's key)."""
    return (int(step) << 20) + int(rank)


def tiered_grad_sync(grads: Tree, tiers: Optional[TierAssignment],
                     seed: int, axis: str = "pod") -> Tree:
    """Cross-pod gradient mean with per-tier transports, over the process
    group of the ambient mesh's axis ``axis`` (every rank calls it with
    its own gradients).  ``tiers=None`` => plain mean (the
    paper-faithful all-sync baseline).  Each int8-tier leaf draws its
    noise, in tree order, from one generator on the leaves' device
    seeded with ``seed`` (on the ``meta`` device, which has no generator,
    the noise is a shape: nothing is drawn)."""
    group, n = _group(compat.current_mesh(), axis)
    if tiers is None:
        return tree_map(lambda g: group_mean(g, group, n), grads)
    flat = leaves(grads)
    qflags = leaves(tiers.quantized)
    if len(qflags) != len(flat):
        raise ValueError(f"tiers has {len(qflags)} leaves, the gradients "
                         f"{len(flat)}")
    gen = None
    out = []
    for leaf, q in zip(flat, qflags):
        if q:
            if gen is None and leaf.device.type != "meta":
                gen = torch.Generator(device=leaf.device).manual_seed(seed)
            out.append(_compressed_mean(leaf, gen, group, n))
        else:
            out.append(group_mean(leaf, group, n))
    return unflatten(grads, iter(out))


def dcn_bytes_per_step(tiers: TierAssignment, n_pods: int) -> float:
    """Wire bytes per step per pod link.  Backend leaves charge their
    exact int8 wire size (payload + per-row f32 scales,
    :func:`repro_torch.core.wire.int8_leaf_bytes`) — the same accounting
    :func:`choose_tiers` optimized against."""
    ring = 2.0 * (n_pods - 1) / n_pods
    gather = 1.0 * (n_pods - 1) / n_pods
    return tiers.front_bytes * ring + tiers.back_wire_bytes * gather
