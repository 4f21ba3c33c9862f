"""Shared building blocks for the LM model zoo (PyTorch, functional).

The port of :mod:`repro.models.lm.common`.  Conventions are the JAX
package's: params are nested dicts of tensors, activations are
``[B, T, D]``, the compute dtype is configurable (bf16 target) and
softmax/normalization statistics are always f32.  :func:`shard_hint` is
the JAX module's sharding hint: the identity without a mesh in scope
and on a plain (per-rank) tensor, a redistribution of a DTensor.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor

Params = Dict[str, Any]


def ambient_abstract_mesh():
    """The mesh in scope (:func:`repro_torch.distrib.compat.set_mesh`), or
    ``None`` when there is none or it names no axes."""
    from repro_torch.distrib import compat
    mesh = compat.current_mesh()
    if mesh is None or not getattr(mesh, "mesh_dim_names", None):
        return None
    return mesh


def shard_hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` hint.  ``axes``: one
    entry per dim, each a mesh-axis name, a tuple of names, or None.

    Without a mesh in scope it is the identity, and so it is on a plain
    tensor: each rank holds its own shard, as inside the reference's
    ``shard_map``.  A DTensor is redistributed over its mesh to the
    placements the entries name, after dropping the axis names absent
    from that mesh and any entry whose axes' product does not divide its
    dim (single-pod vs multi-pod), as the reference drops them."""
    if ambient_abstract_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from repro_torch.distrib.sharding import axis_names, axis_size, placements
    mesh = x.device_mesh
    present = axis_names(mesh)

    def reduce(a, dim):
        if a is None:
            return None
        names = tuple(n for n in (a if isinstance(a, tuple) else (a,))
                      if n in present)
        if not names:
            return None
        prod = 1
        for n in names:
            prod *= axis_size(mesh, n)
        if dim % prod != 0 or dim < prod:
            return None
        return names if len(names) > 1 else names[0]

    spec = tuple(reduce(a, x.shape[i]) for i, a in enumerate(axes))
    return x.redistribute(mesh, placements(mesh, spec))


def split_shardable(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready for a view that splits ``dim`` into ``n`` parts of its
    size: a DTensor is first gathered on each mesh dim that shards ``dim``
    where the ranks sharding it so far, major first, do not divide ``n``
    (DTensor's view cannot split such a dim; XLA's partitioner regathers
    there too).  The product, not each mesh dim alone: DTensor's view
    checks each mesh dim alone, and a dim sharded over two of them (the
    batch over ``("pod", "data")``) whose product does not divide ``n``
    comes out with local shards of the wrong shape (torch 2.11 and 2.13).
    A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.dim()
    mesh = x.device_mesh
    pl, ranks = [], 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim) and n % (ranks * mesh.size(i)) == 0:
            ranks *= mesh.size(i)
        elif p.is_shard(dim):
            p = Replicate()
        pl.append(p)
    pl = tuple(pl)
    return x if pl == x.placements else x.redistribute(mesh, pl)


def pointwise_on_shards(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no sharding
    strategy for (``logsigmoid``'s backward): a DTensor's pending sums are
    reduced, then each rank applies ``fn`` to its local shard, and the
    result keeps ``x``'s layout.  A plain tensor as ``fn(x)``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    x = x.redistribute(mesh, pl)
    return DTensor.from_local(fn(x.to_local()), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


class _GradLayout(torch.autograd.Function):
    """The identity; the gradient redistributed to the forward's
    placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``x [B, T, H, d]`` as ``[B, T, H d]``.  For a DTensor the merged
    dim's gradient is first laid out as the forward's: DTensor cannot
    split a dim sharded over ranks that do not divide ``H`` in the view's
    backward (heads replicated over ``model`` meet a gradient that the
    next product shards over ``model``)."""
    B, T = x.shape[:2]
    x = x.reshape(B, T, -1)
    return _GradLayout.apply(x) if is_dtensor(x) else x


def head_split(mesh, batch: int, heads: int) -> Tuple[Any, bool]:
    """The layout of an operation run per head on each rank's local
    shard: (the batch dim's spec entry, whether the heads go over
    ``model``).  The batch goes over the DP axes where it divides them
    (:func:`repro_torch.distrib.sharding.batch_spec`), the heads over
    ``model`` where they divide it; otherwise they are replicated and
    every rank computes all heads of its batch block."""
    from repro_torch.distrib.sharding import (axis_names, axis_size,
                                              batch_spec)
    model = axis_size(mesh, "model")
    by_heads = "model" in axis_names(mesh) and heads % model == 0 and \
        heads >= model
    return batch_spec(mesh, batch, 1)[0], by_heads


def local_heads(x: torch.Tensor, dim: int, by_heads: bool, dp=None,
                shared: bool = False) -> torch.Tensor:
    """This rank's block of the DTensor ``x`` as a plain tensor through
    which the gradient flows back to ``x``: dim 0 over the DP axes that
    ``dp`` names, the heads at ``dim`` over ``model`` when ``by_heads``,
    every other dim whole.  ``shared``: ``x`` has no batch dim (a weight)
    and stays whole over the DP axes; every rank's batch block reads all
    of it, so its gradient is a pending sum over the axes ``dp`` names.

    Heads that ``x`` already shards over ``model`` stay where they are:
    on the layout the model gives, nothing moves.  Heads that ``x``
    replicates over ``model`` (Mamba2's q, an ``expand`` over heads; the
    sLSTM's regrouped gates and recurrent weights) are sliced locally,
    and the slice's gradient is declared a pending sum over ``model``:
    each rank's share, zeros outside its heads, summed where ``x``'s
    gradient is laid out.  So the forward takes no collective there."""
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.distrib.sharding import axis_names, placements
    mesh = x.device_mesh
    names = axis_names(mesh)
    dim %= x.dim()
    spec = [None] * x.dim()
    if not shared:
        spec[0] = dp
    m = names.index("model") if by_heads else None
    kept = by_heads and x.placements[m] == Shard(dim)
    if kept:
        spec[dim] = "model"
    pl = placements(mesh, tuple(spec))
    x = x.redistribute(mesh, pl)
    grad = list(pl)
    if shared:
        for a in (dp if isinstance(dp, tuple) else (dp,)):
            if a is not None:
                grad[names.index(a)] = Partial()
    if by_heads and not kept:
        grad[m] = Partial()
    local = x.to_local(grad_placements=grad)
    if not by_heads or kept:
        return local
    n = x.shape[dim] // mesh.size(m)
    return local.narrow(dim, mesh.get_local_rank(m) * n, n)


def from_heads(local: torch.Tensor, mesh, dim: int, by_heads: bool,
               dp=None) -> torch.Tensor:
    """The inverse of :func:`local_heads`: each rank's ``local`` block as
    one DTensor, dim 0 over the DP axes that ``dp`` names and ``dim``
    over ``model`` when ``by_heads``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distrib.sharding import placements
    spec = [None] * local.dim()
    spec[0] = dp
    if by_heads:
        spec[dim % local.dim()] = "model"
    return DTensor.from_local(local, mesh, placements(mesh, tuple(spec)),
                              run_check=False)


def truncated_normal_init(generator: torch.Generator, shape: Tuple[int, ...],
                          scale: float, dtype: torch.dtype,
                          device=None) -> torch.Tensor:
    """A standard normal truncated to [-2, 2], times ``scale /
    sqrt(fan_in)`` (``fan_in = shape[0]`` for matrices), drawn in f32 on
    the generator's device and cast to ``dtype`` on ``device``.  On the
    ``meta`` device nothing is drawn: the result is an empty tensor of the
    shape and dtype (the dry run's ``eval_shape``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else 1
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (scale / math.sqrt(fan_in))).to(device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.float())).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [B, T, H, hd]; positions: [T] or [B, T] (absolute)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # [hd/2]
    angles = positions.float()[..., None] * freqs
    angles = angles[None, :, None, :] if positions.dim() == 1 \
        else angles[:, :, None, :]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int, device=None
                         ) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings ``[length, dim]`` (f32): the
    table is built in numpy f64 and cast to f32, as the reference builds
    it."""
    pos = np.arange(length)[:, None]
    inv = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)[None, :]
    emb = np.zeros((length, dim), np.float32)
    emb[:, 0::2] = np.sin(pos * inv)
    emb[:, 1::2] = np.cos(pos * inv)
    return torch.from_numpy(emb).to(device)


def sinusoidal_position_at(pos: int, dim: int, device=None) -> torch.Tensor:
    """Single-position sinusoidal embedding ``[dim]``, computed in f32 as
    the reference's decode computes it (it differs from the f64 table in
    the last bits).  The divisor is a tensor on ``device``: CUDA turns a
    division by a host scalar into a multiply by its reciprocal."""
    f32 = dict(dtype=torch.float32, device=device)
    inv = torch.exp(-torch.log(torch.full((), 10000.0, **f32))
                    * torch.arange(0, dim, 2, **f32)
                    / torch.full((), dim, **f32))
    ang = torch.full((), pos, **f32) * inv
    emb = torch.zeros((dim,), **f32)
    emb[0::2] = torch.sin(ang)
    emb[1::2] = torch.cos(ang)
    return emb


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype, device=None) -> Params:
    return {
        "w_gate": truncated_normal_init(generator, (d_model, d_ff), 1.0,
                                        dtype, device),
        "w_up": truncated_normal_init(generator, (d_model, d_ff), 1.0,
                                      dtype, device),
        "w_down": truncated_normal_init(generator, (d_ff, d_model), 1.0,
                                        dtype, device),
    }


def apply_swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ p["w_gate"]).float()).to(x.dtype)
    return (g * (x @ p["w_up"])) @ p["w_down"]


def apply_geglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gated-GELU MLP (gemma-style); same param layout as SwiGLU."""
    g = F.gelu((x @ p["w_gate"]).float(), approximate="tanh").to(x.dtype)
    return (g * (x @ p["w_up"])) @ p["w_down"]


def init_gelu_mlp(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype, device=None) -> Params:
    return {
        "w_up": truncated_normal_init(generator, (d_model, d_ff), 1.0,
                                      dtype, device),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": truncated_normal_init(generator, (d_ff, d_model), 1.0,
                                        dtype, device),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def apply_gelu_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.gelu((x @ p["w_up"] + p["b_up"]).float(),
               approximate="tanh").to(x.dtype)
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def chunked_softmax_xent(hidden: torch.Tensor, lm_head: torch.Tensor,
                         labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing [B, T, V] at
    once.

    hidden: [B, T, D] (already final-normed), lm_head: [D, V],
    labels: [B, T] int, mask: [B, T] (1 = count).  The chunks of the
    sequence are summed one after another, as the JAX scan sums them.
    """
    B, T, D = hidden.shape
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=hidden.device)
    n_chunks = max(T // chunk, 1)
    if T % n_chunks:
        raise ValueError(f"T={T} does not split into {n_chunks} chunks")
    cs = T // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        hc = hidden[:, c * cs:(c + 1) * cs]
        yc = labels[:, c * cs:(c + 1) * cs].long()
        mc = mask[:, c * cs:(c + 1) * cs].float()
        logits = (hc @ lm_head).float()
        # keep the [B, chunk, V] chunk sharded: batch over DP, vocab TP
        logits = shard_hint(logits, ("pod", "data"), None, "model")
        # the trailing dim stays until the difference: over a vocab-sharded
        # DTensor the gather's result is a masked pending sum, which DTensor
        # can reduce only at the gather's own shape
        logz = torch.logsumexp(logits, dim=-1, keepdim=True)
        gold = torch.gather(logits, -1, yc[..., None])
        tot = tot + ((logz - gold)[..., 0] * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp_min(cnt, 1.0)
