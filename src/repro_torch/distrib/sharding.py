"""Named-sharding rules for params, optimizer state, batches and caches.

The port of :mod:`repro.distrib.sharding`.  Axes: ``pod`` (inter-pod
link — the HierTrain "WAN"), ``data`` (intra-pod DP/FSDP), ``model``
(intra-pod TP).  The rules are the reference's, shape-driven with
divisibility fallbacks:

* weights (ndim >= 2): TP (``model``) on the largest shardable dim,
  FSDP (``data``) on the largest remaining one; layer-stacked leaves
  ``[L, in, out]`` never shard the stack dim.  Megatron column/row
  leaves, by name, put TP on their output/input dim.
* batches: leading dim over ``(pod, data)`` when divisible, else
  ``data`` only, else replicated.
* KV caches: batch over DP axes; KV-head dim over ``model`` when
  divisible, else the sequence dim (MQA/GQA with few KV heads).
* recurrent states: batch over DP; the first divisible trailing dim
  gets TP.

A spec is a tuple with one entry per tensor dim (empty for a leaf of
fewer than 2 dims, as the reference's ``P()``): an axis name, a tuple of
names, or ``None``, as a ``PartitionSpec``.  The rules read only axis
names and sizes — of a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``size(i)``) or of a :class:`MeshShape`, which
needs no devices.  The ``*_shardings`` turn specs into DTensor
placements (``Shard(d)`` / ``Replicate()`` per mesh dim) over a tree of
shapes (tuples, or anything with ``.shape``: tensors, meta tensors).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np

from repro_torch.tree import tree_map

Tree = Any
Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis sizes and names, without devices (the rules' view of
    a ``DeviceMesh``; the reference's tests use jax's ``AbstractMesh``)."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def size(self, mesh_dim=None) -> int:
        if mesh_dim is None:
            return int(np.prod(self.shape))
        return int(self.shape[mesh_dim])


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    return int(mesh.size(names.index(name))) if name in names else 1


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _shape(s) -> Tuple[int, ...]:
    return tuple(int(d) for d in (s.shape if hasattr(s, "shape") else s))


def batch_spec(mesh, batch: int, ndim: int) -> Spec:
    """Leading-dim data-parallel spec with divisibility fallback."""
    axes = dp_axes(mesh)
    prod = int(np.prod([axis_size(mesh, a) for a in axes]))
    rest = (None,) * (ndim - 1)
    if axes and batch % prod == 0:
        # a one-name tuple is that name, as PartitionSpec normalizes it
        return (axes if len(axes) > 1 else axes[0], *rest)
    if "data" in axes and batch % axis_size(mesh, "data") == 0:
        return ("data", *rest)
    return (None,) * ndim


def param_spec(mesh, shape: Tuple[int, ...], fsdp: bool = True) -> Spec:
    """TP (``model``) on the largest shardable dim, FSDP (``data``) on the
    largest remaining one; for ``[L, ...]`` layer-stacked leaves the scan
    dim is excluded.  ``fsdp=False`` replicates params over ``data``
    (TP-only)."""
    names = axis_names(mesh)
    model = axis_size(mesh, "model")
    data = axis_size(mesh, "data")
    ndim = len(shape)
    if ndim < 2:
        return ()
    spec: list = [None] * ndim
    start = 1 if ndim >= 3 else 0          # skip the layer-stack dim
    dims = sorted(range(start, ndim), key=lambda i: -shape[i])
    for i in dims:
        if "model" in names and shape[i] % model == 0 and \
                shape[i] >= model:
            spec[i] = "model"
            dims.remove(i)
            break
    if fsdp:
        for i in dims:
            if "data" in names and shape[i] % data == 0 and \
                    shape[i] >= data:
                spec[i] = "data"
                break
    return tuple(spec)


def fsdp_needed(mesh, total_params: int, opt_bytes_per_param: int,
                budget_bytes: float = 8e9) -> bool:
    """TP-only state = (2 + opt) bytes/param over the model axis; use
    FSDP only when that exceeds the per-device budget."""
    model = axis_size(mesh, "model")
    per_dev = total_params * (2 + opt_bytes_per_param) / model
    return per_dev > budget_bytes


# Megatron column/row assignment by leaf name (the reference's sets):
# column-parallel weights shard their OUTPUT dim, row-parallel weights
# their INPUT dim.
_COLUMN_PARALLEL = {"wq", "wk", "wv", "w_gate", "w_up", "up_proj",
                    "in_proj", "w_in", "b_up", "bq", "bk", "bv", "lm_head",
                    "r", "w_gates", "router", "conv_w", "conv_b"}
_ROW_PARALLEL = {"wo", "w_down", "down_proj", "out_proj"}


def param_spec_named(mesh, name: str, shape: Tuple[int, ...],
                     fsdp: bool = True) -> Spec:
    names = axis_names(mesh)
    model = axis_size(mesh, "model")
    data = axis_size(mesh, "data")
    ndim = len(shape)
    if ndim < 2:
        return ()
    tp_dim = None
    if name in _COLUMN_PARALLEL and shape[-1] % model == 0 and \
            shape[-1] >= model:
        tp_dim = ndim - 1
    elif name in _ROW_PARALLEL and shape[-2] % model == 0 and \
            shape[-2] >= model:
        tp_dim = ndim - 2
    if tp_dim is None:
        return param_spec(mesh, shape, fsdp)
    spec: list = [None] * ndim
    if "model" in names:
        spec[tp_dim] = "model"
    if fsdp and "data" in names:
        start = 1 if ndim >= 3 else 0
        for i in sorted(range(start, ndim), key=lambda i: -shape[i]):
            if i != tp_dim and shape[i] % data == 0 and shape[i] >= data:
                spec[i] = "data"
                break
    return tuple(spec)


def cache_spec(mesh, shape: Tuple[int, ...], batch: int) -> Spec:
    """Decode-state sharding.  Layout conventions from the model zoo:
    ``[L, B, S, KV, hd]`` attention caches, ``[L, B, ...state]``
    recurrent states, ``[L, B, K-1, C]`` conv states."""
    names = axis_names(mesh)
    model = axis_size(mesh, "model")
    ndim = len(shape)
    spec: list = [None] * ndim
    if ndim < 2:
        return ()
    # axis 1 is batch for every cache in the zoo.
    bspec = batch_spec(mesh, shape[1], 1)
    spec[1] = bspec[0] if len(bspec) else None
    if "model" in names and ndim >= 3:
        if ndim == 5 and shape[3] % model == 0 and shape[3] >= model:
            spec[3] = "model"          # KV heads / SSD heads
        elif ndim == 5 and shape[2] % model == 0:
            spec[2] = "model"          # sequence-sharded KV (MQA)
        else:
            # first divisible trailing dim gets TP
            for ax in range(ndim - 1, 1, -1):
                if shape[ax] % model == 0 and shape[ax] >= model:
                    spec[ax] = "model"
                    break
    return tuple(spec)


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec: Spec) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` where ``spec`` names the
    axis on tensor dim ``d``, else ``Replicate()``.  A dim over several
    axes (``("pod", "data")``) is sharded over each, major first."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for n in (entry if isinstance(entry, tuple) else (entry,)):
            if n is not None:
                out[names.index(n)] = Shard(d)
    return tuple(out)


def _map_named(fn, tree: Tree, name: str = "") -> Tree:
    """``fn(name, leaf)`` over a tree, ``name`` the nearest dict key above
    the leaf (the reference's ``_leaf_name`` of its path)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, name) for v in tree]
    return fn(name, tree)


def batch_shardings(mesh, batch_shapes: Tree) -> Tree:
    return tree_map(lambda s: placements(mesh, batch_spec(
        mesh, _shape(s)[0], len(_shape(s)))), batch_shapes)


def param_shardings(mesh, param_shapes: Tree, fsdp: bool = True) -> Tree:
    return _map_named(lambda n, s: placements(mesh, param_spec_named(
        mesh, n, _shape(s), fsdp)), param_shapes)


def opt_state_shardings(mesh, state_shapes: Tree, fsdp: bool = True
                        ) -> Tree:
    """Optimizer state mirrors parameter sharding leaf-for-leaf (scalars —
    the step counter — stay replicated)."""
    return param_shardings(mesh, state_shapes, fsdp)


def cache_shardings(mesh, cache_shapes: Tree, batch: int) -> Tree:
    return tree_map(lambda s: placements(mesh, cache_spec(
        mesh, _shape(s), batch)), cache_shapes)


def replicated(mesh) -> tuple:
    return placements(mesh, ())
