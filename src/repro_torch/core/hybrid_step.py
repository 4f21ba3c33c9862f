"""Hybrid-parallelism execution engine (§IV-B) with exact SGD semantics.

The port of :mod:`repro.core.hybrid_step` (the triple, the star and the
tree).  It executes one HierTrain iteration the way the paper describes
it — workers holding *separate copies* of their assigned layers,
activations crossing at the cut points, and only frontend gradients
being exchanged — and produces the *same* update as vanilla SGD over the
full batch ``B``.  Three entry points:

* :func:`hybrid_sgd_step` — the paper's three-worker topology (one TASK S,
  one TASK L, one TASK O).
* :func:`multi_hybrid_sgd_step` — M TASK-S streams with per-stream cuts
  ``m_s[i]``; worker_o picks each arriving stream up at its own cut, in
  ascending-cut order (the tree step with every stream on an edge of its
  own).  With ``M = 1`` it runs the same operations in the same order as
  :func:`hybrid_sgd_step`, so the two agree bit for bit.
* :func:`tree_hybrid_sgd_step` — the streams live under E edge servers,
  and each edge concatenates its resident same-cut streams into one block
  before worker_o's walk.  With every stream on one edge (E = 1) it runs
  the star's arithmetic, so the two agree bit for bit.

Each worker's copy is a distinct set of autograd leaves over the same
storage (``p_o``, ``p_s = params[:m_s]``, ``p_l = params[:m_l]``), so
autograd returns one gradient per copy and the weight update sums them in
a fixed order (``g_o + g_s + g_l``), then scales by ``1/B`` once.  A
shared leaf would let autograd accumulate the copies in its own order.
A cut-point's params are a nested dict of tensors (``{"w", "b"}`` for a
CNN layer, ``{"ln1": {...}, "attn": {...}, ...}`` for an LM block); every
walk over them keeps the dict's nesting and visits leaves in sorted key
order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, List, Optional,
                    Sequence, Tuple)

import torch
import torch.distributed as dist

from repro_torch.core.cost_model import MultiSchedule, Schedule
from repro_torch.core.layerstack import as_layerstack
from repro_torch.core.wire import wire_act_bytes, wire_codec, wire_grad_bytes
from repro_torch.distrib.sharding import axis_names, axis_size, dp_axes
from repro_torch.tree import grad, grad_leaves
from repro_torch.tree import tree_map as _map

Tree = Dict[str, Any]          # nested dicts of tensors
Params = List[Tree]            # one tree per cut-point
Batch = Tuple[torch.Tensor, torch.Tensor]


def _leaves(params: Params, n: int) -> Params:
    """Fresh autograd leaves over the storage of ``params[:n]``."""
    return grad_leaves(params[:n])


def _grads(loss: torch.Tensor, copies: Sequence[Params]) -> List[Params]:
    """d loss / d every leaf of every copy (zeros where unused)."""
    return grad(loss, list(copies))


def _add(g: Tree, other: Tree) -> Tree:
    return _map(lambda a, b: a + b, g, other)


def _update(params: Params, g: Tree, i: int, lr: float, B: int) -> Tree:
    return _map(lambda p, gg: p - lr * (gg / B), params[i], g)


def reference_sgd_step(model, params: Params, x: torch.Tensor,
                       y: torch.Tensor, lr: float
                       ) -> Tuple[Params, torch.Tensor]:
    """Vanilla full-batch SGD step: the ground truth the hybrid step must
    reproduce."""
    stack = as_layerstack(model)
    N = stack.num_layers
    p = _leaves(params, N)
    loss = stack.sum_loss(stack.apply_segment(p, x, 0, N), y) / x.shape[0]
    (g,) = _grads(loss, [p])
    with torch.no_grad():
        new = [_map(lambda p, gg: p - lr * gg, params[i], g[i])
               for i in range(N)]
    return new, loss.detach()


def split_batch(x: torch.Tensor, y: torch.Tensor, sched: Schedule
                ) -> Dict[str, Batch]:
    """Assign the first b_o samples to o, next b_s to s, rest to l."""
    bo, bs, bl = sched.b_o, sched.b_s, sched.b_l
    if bo + bs + bl != x.shape[0]:
        raise ValueError(f"schedule splits {bo + bs + bl} samples, the "
                         f"batch has {x.shape[0]}")
    return {
        "o": (x[:bo], y[:bo]),
        "s": (x[bo:bo + bs], y[bo:bo + bs]),
        "l": (x[bo + bs:], y[bo + bs:]),
    }


def hybrid_sgd_step(model, params: Params, batches: Dict[str, Batch],
                    m_s: int, m_l: int, lr: float, wire: str = "none"
                    ) -> Tuple[Params, torch.Tensor]:
    """One HierTrain iteration.  Returns (updated params, mean loss).

    ``params`` plays the role of the consensus weights each worker starts
    the iteration with (they are equal after every weight-update phase).

    ``wire`` selects the cut-point transfer codec
    (``repro_torch.core.wire``): ``"int8"`` quantizes the shipped
    activations forward and the returning activation-gradients backward;
    ``"none"`` leaves the step untouched.  A cut at 0 is a raw-input
    upload, so the codec only touches crossings with ``m > 0``.
    """
    stack = as_layerstack(model)
    N = stack.num_layers
    assert 0 <= m_s <= m_l <= N
    codec = wire_codec(wire)
    x_o, y_o = batches["o"]
    x_s, y_s = batches["s"]
    x_l, y_l = batches["l"]
    b_o, b_s, b_l = x_o.shape[0], x_s.shape[0], x_l.shape[0]
    B = b_o + b_s + b_l

    # Worker-local copies: p_s = frontend 1..m_s, p_l = 1..m_l, p_o = all.
    p_o, p_s, p_l = _leaves(params, N), _leaves(params, m_s), \
        _leaves(params, m_l)

    # --- forward phase (Fig. 4 routing) ---
    h_s = stack.apply_segment(p_s, x_s, 0, m_s) if b_s else None
    h_l = stack.apply_segment(p_l, x_l, 0, m_l) if b_l else None
    if codec is not None and h_s is not None and m_s > 0:
        h_s = codec(h_s)
    if codec is not None and h_l is not None and m_l > 0:
        h_l = codec(h_l)
    a_o = stack.apply_segment(p_o, x_o, 0, m_s)
    # worker_o continues its own + s's samples through m_s+1..m_l.
    mid_in = a_o if h_s is None else torch.cat([a_o, h_s], dim=0)
    mid = stack.apply_segment(p_o, mid_in, m_s, m_l)
    tail_in = mid if h_l is None else torch.cat([mid, h_l], dim=0)
    logits = stack.apply_segment(p_o, tail_in, m_l, N)
    labels = torch.cat([y_o, y_s, y_l], dim=0)
    total_loss = stack.sum_loss(logits, labels)

    g_o, g_s, g_l = _grads(total_loss, [p_o, p_s, p_l])

    # --- weight-update phase: layer-wise gradient exchange ---------------
    # Workers hold per-sample-sum gradients; worker_o aggregates the shared
    # frontend layers and every worker scales by 1/B (exact batch-B SGD).
    new_params: Params = []
    with torch.no_grad():
        for i in range(N):
            g = g_o[i]
            if i < m_s and b_s:
                g = _add(g, g_s[i])
            if i < m_l and b_l:
                g = _add(g, g_l[i])
            new_params.append(_update(params, g, i, lr, B))
    return new_params, total_loss.detach() / B


def hybrid_step_from_schedule(model, params: Params, x: torch.Tensor,
                              y: torch.Tensor, sched: Schedule, lr: float,
                              wire: str = "none"
                              ) -> Tuple[Params, torch.Tensor]:
    return hybrid_sgd_step(model, params, split_batch(x, y, sched),
                           sched.m_s, sched.m_l, lr, wire=wire)


# ---------------------------------------------------------------------------
# M-stream generalization (DESIGN.md §6): one TASK-S instance per non-o,
# non-l worker, each with its own cut.  worker_o merges stream i into its
# running activation batch at layer m_s[i] (ascending-cut order, stream
# index breaking ties), then TASK L's stream at m_l, exactly mirroring the
# generalized cost model's routing.
# ---------------------------------------------------------------------------


def multi_split_batch(x: torch.Tensor, y: torch.Tensor, sched: MultiSchedule
                      ) -> Dict[str, object]:
    """Assign the first ``b_o`` samples to o, the next ``b_s[i]`` to each
    TASK-S stream in ``s_workers`` order, and the remainder to l."""
    bo, bl = sched.b_o, sched.b_l
    if bo + sum(sched.b_s) + bl != x.shape[0]:
        raise ValueError(f"schedule splits {bo + sum(sched.b_s) + bl} "
                         f"samples, the batch has {x.shape[0]}")
    out: Dict[str, object] = {"o": (x[:bo], y[:bo])}
    streams = []
    at = bo
    for bi in sched.b_s:
        streams.append((x[at:at + bi], y[at:at + bi]))
        at += bi
    out["s"] = tuple(streams)
    out["l"] = (x[at:], y[at:])
    return out


def multi_hybrid_sgd_step(model, params: Params, batches: Dict[str, object],
                          m_s: Sequence[int], m_l: int, lr: float,
                          wire: str = "none"
                          ) -> Tuple[Params, torch.Tensor]:
    """One M-stream HierTrain iteration.  Returns (updated params, mean
    loss).  Exact batch-``B`` SGD semantics: per-stream gradients are
    per-sample sums, aggregated over every copy of each frontend layer and
    scaled once by ``1/B``.  Streams join worker_o's batch in
    ascending-cut order (stream index breaks ties), each with its own
    concatenation: the tree step with every stream on an edge of its own.
    With ``M = 1`` and the same schedule this runs the operations of
    :func:`hybrid_sgd_step` in the same order (including the ``wire``
    codec, applied per arriving stream at its cut), so the two agree bit
    for bit.
    """
    return tree_hybrid_sgd_step(model, params, batches, m_s, m_l, lr,
                                wire=wire, stream_edge=range(len(m_s)))


def multi_hybrid_step_from_schedule(model, params: Params, x: torch.Tensor,
                                    y: torch.Tensor, sched: MultiSchedule,
                                    lr: float, wire: str = "none"
                                    ) -> Tuple[Params, torch.Tensor]:
    return multi_hybrid_sgd_step(model, params,
                                 multi_split_batch(x, y, sched),
                                 sched.m_s, sched.m_l, lr, wire=wire)


# ---------------------------------------------------------------------------
# Two-level tree generalization: streams live under E edge servers; each
# edge pre-merges the activations of its resident same-cut streams before
# the cloud-side walk.  Concatenation is arithmetic-free, so with every
# stream on one edge (E = 1) the params and loss are bit-identical to the
# star's (every stream on an edge of its own): the sample order, every
# batch that meets a layer and the loss-sum reduction order coincide.
# ---------------------------------------------------------------------------


def tree_hybrid_sgd_step(model, params: Params, batches: Dict[str, object],
                         m_s: Sequence[int], m_l: int, lr: float,
                         wire: str = "none",
                         stream_edge: Optional[Sequence[int]] = None,
                         cloud_mesh=None) -> Tuple[Params, torch.Tensor]:
    """One tree HierTrain iteration.  Returns (updated params, mean loss).

    ``stream_edge[i]`` names the edge hosting TASK-S stream ``i`` (device
    streams sit under their radio's edge; an edge's own stream under
    itself).  Streams sharing ``(cut, edge)`` are concatenated *on the
    edge* into one activation block before joining worker_o's
    ascending-cut walk.  The ``wire`` codec runs on each stream before
    its edge's merge, once per stream that carries samples.

    ``cloud_mesh`` (optional, a ``DeviceMesh`` with a ``pod`` and/or
    ``data`` axis; every rank of it calls the step with the same params
    and batch) runs the cloud-resident tail ``m_l..N`` data-parallel over
    the mesh's dp axes, in two stages (:func:`_sharded_tail_grads`).  The
    default ``None`` keeps the single backward whose results are
    bit-identical to the star path at E=1.
    """
    stack = as_layerstack(model)
    N = stack.num_layers
    codec = wire_codec(wire)
    m_s = tuple(int(m) for m in m_s)
    M = len(m_s)
    eo = tuple(int(e) for e in stream_edge) if stream_edge is not None \
        else (0,) * M
    assert len(eo) == M
    x_o, y_o = batches["o"]
    s_streams = batches["s"]
    x_l, y_l = batches["l"]
    assert len(s_streams) == M
    assert all(0 <= m <= m_l for m in m_s) and m_l <= N
    b_s = [sx.shape[0] for sx, _ in s_streams]
    b_o, b_l = x_o.shape[0], x_l.shape[0]
    B = b_o + sum(b_s) + b_l
    dp = None if cloud_mesh is None else _cloud_dp(cloud_mesh, B)
    # Ascending-cut order with the hosting edge (then stream index)
    # breaking ties; maximal runs of equal (cut, edge) are one edge-side
    # merge each.  With every stream on edge 0 this is the star's order.
    join_order = sorted((i for i in range(M) if b_s[i]),
                        key=lambda i: (m_s[i], eo[i], i))
    groups: List[Tuple[int, List[int]]] = []
    for i in join_order:
        if groups and groups[-1][0] == m_s[i] and \
                eo[groups[-1][1][-1]] == eo[i]:
            groups[-1][1].append(i)
        else:
            groups.append((m_s[i], [i]))

    p_o = _leaves(params, N)
    p_s = [_leaves(params, m) for m in m_s]
    p_l = _leaves(params, m_l)

    # --- forward: per-stream frontends, per-edge merges, worker_o's walk
    h: List[Optional[torch.Tensor]] = [
        stack.apply_segment(p_s[i], s_streams[i][0], 0, m_s[i])
        if b_s[i] else None for i in range(M)]
    h_l = stack.apply_segment(p_l, x_l, 0, m_l) if b_l else None
    if codec is not None:
        h = [codec(h[i]) if h[i] is not None and m_s[i] > 0 else h[i]
             for i in range(M)]
        if h_l is not None and m_l > 0:
            h_l = codec(h_l)
    cur = x_o
    prev = 0
    for cut, members in groups:
        if cut != prev:
            cur = stack.apply_segment(p_o, cur, prev, cut)
            prev = cut
        blk = h[members[0]] if len(members) == 1 else \
            torch.cat([h[i] for i in members], dim=0)
        cur = torch.cat([cur, blk], dim=0)
    cur = stack.apply_segment(p_o, cur, prev, m_l)
    if h_l is not None:
        cur = torch.cat([cur, h_l], dim=0)
    labels = torch.cat(
        [y_o] + [s_streams[i][1] for i in join_order] + [y_l], dim=0)
    if dp is None:
        logits = stack.apply_segment(p_o, cur, m_l, N)
        total_loss = stack.sum_loss(logits, labels)
        grads = _grads(total_loss, [p_o, *p_s, p_l])
    else:
        total_loss, grads = _sharded_tail_grads(
            stack, cur, labels, [p_o, *p_s, p_l], m_l, N, B, cloud_mesh,
            dp)
    g_o, g_s, g_l = grads[0], grads[1:1 + M], grads[1 + M]

    # --- weight-update phase: the star's order, g_o + g_s[d] + g_l ---
    new_params: Params = []
    with torch.no_grad():
        for i in range(N):
            g = g_o[i]
            for d in range(M):
                if i < m_s[d] and b_s[d]:
                    g = _add(g, g_s[d][i])
            if i < m_l and b_l:
                g = _add(g, g_l[i])
            new_params.append(_update(params, g, i, lr, B))
    return new_params, total_loss.detach() / B


def _cloud_dp(mesh, B: int) -> Tuple[str, ...]:
    """The cloud mesh's data-parallel axes; raises unless it has some and
    they divide the global batch ``B``."""
    dp = dp_axes(mesh)
    if not dp:
        raise ValueError("cloud_mesh has no data-parallel axes "
                         f"('pod'/'data'); got axes {axis_names(mesh)}")
    n_shards = math.prod(axis_size(mesh, a) for a in dp)
    if B % n_shards != 0:
        raise ValueError(
            f"global batch {B} is not divisible by the cloud mesh's "
            f"{n_shards} data-parallel shards; pick a schedule whose "
            "batch split is a multiple of the dp size")
    return dp


def _sharded_tail_grads(stack, cur: torch.Tensor, labels: torch.Tensor,
                        copies: List[Params], m_l: int, N: int, B: int,
                        mesh, dp: Tuple[str, ...]
                        ) -> Tuple[torch.Tensor, List[Params]]:
    """Loss + grads with the cloud tail ``m_l..N`` data-parallel over the
    mesh's ``dp`` axes.  Two stages: every rank runs the front (``cur``,
    the whole batch at the boundary, under autograd); the tail runs on
    this rank's contiguous shard of the detached boundary activation and
    of the labels, its parameter grads and per-sample-sum loss are
    SUM-all-reduced over ``dp``, and the shards' activation cotangents
    are all-gathered back to the whole batch and fed through the front.
    ``copies`` is ``[p_o, *p_s, p_l]``; ``p_o``'s grad is the front's
    plus the tail's (each zero where the other's layers are), as the
    reference's ``jax.tree.map(jnp.add, ...)``."""
    sizes = [axis_size(mesh, a) for a in dp]
    idx = 0
    for a, n in zip(dp, sizes):
        idx = idx * n + int(mesh.get_local_rank(a))
    b = B // math.prod(sizes)
    cur_l = cur.detach()[idx * b:(idx + 1) * b].requires_grad_(True)
    p_o = copies[0]
    loss_l = stack.sum_loss(stack.apply_segment(p_o, cur_l, m_l, N),
                            labels[idx * b:(idx + 1) * b])
    g_tail, g_cur = grad(loss_l, [p_o, cur_l])
    groups = [mesh.get_group(a) for a in dp]

    def dp_sum(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()            # NCCL takes dense tensors only
        for g in groups:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
        return t

    with torch.no_grad():
        g_tail = _map(dp_sum, g_tail)
        total_loss = dp_sum(loss_l.detach().clone())
        for g, n in zip(reversed(groups), reversed(sizes)):   # minor first
            parts = [torch.empty_like(g_cur) for _ in range(n)]
            dist.all_gather(parts, g_cur.contiguous(), group=g)
            g_cur = torch.cat(parts, dim=0)
    grads = grad(cur, copies, g_cur) if cur.requires_grad else \
        _map(torch.zeros_like, copies)
    with torch.no_grad():
        grads[0] = _add(grads[0], g_tail)
    return total_loss, grads


def tree_stream_edges(profile, net, sched: MultiSchedule) -> Tuple[int, ...]:
    """Per-TASK-S-stream hosting edge for a tree schedule: a device
    stream sits under its radio's edge, an edge's own stream under
    itself, and a cloud-hosted stream merges with the front group
    (index 0).  On an E=1 tree every stream maps to edge 0, which is
    what keeps the step identical to the star's."""
    D = profile.num_devices
    E = net.num_edges
    eo = net.edge_of
    out = []
    for w in sched.s_workers:
        i = profile.widx[w]
        if i < D:
            out.append(eo[i])
        else:
            j = i - D
            out.append(j if j < E else 0)
    return tuple(out)


def tree_hybrid_step_from_schedule(model, params: Params, x: torch.Tensor,
                                   y: torch.Tensor, sched: MultiSchedule,
                                   lr: float, wire: str = "none",
                                   stream_edge: Optional[Sequence[int]]
                                   = None, cloud_mesh=None
                                   ) -> Tuple[Params, torch.Tensor]:
    return tree_hybrid_sgd_step(model, params,
                                multi_split_batch(x, y, sched),
                                sched.m_s, sched.m_l, lr, wire=wire,
                                stream_edge=stream_edge,
                                cloud_mesh=cloud_mesh)


def tree_schedule_step(profile, net, cloud_mesh=None) -> Callable:
    """:func:`tree_hybrid_step_from_schedule` with the stream→edge map
    re-derived from each schedule it is given (:func:`tree_stream_edges`
    on ``profile`` and ``net``): the step ``Plan.step_fn`` and
    ``Plan.train`` run on a tree.  Same signature as the other
    ``*_step_from_schedule`` functions, less ``stream_edge``;
    ``cloud_mesh`` as in :func:`tree_hybrid_sgd_step`."""

    def run(model, params: Params, x: torch.Tensor, y: torch.Tensor,
            sched: MultiSchedule, lr: float, wire: str = "none"
            ) -> Tuple[Params, torch.Tensor]:
        return tree_hybrid_step_from_schedule(
            model, params, x, y, sched, lr, wire=wire,
            stream_edge=tree_stream_edges(profile, net, sched),
            cloud_mesh=cloud_mesh)
    return run


# ---------------------------------------------------------------------------
# Communication accounting: bytes each phase moves across worker boundaries
# (the DataSize terms of the cost model).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrafficReport:
    input_bytes: float
    activation_bytes: float   # forward handoff + backward intermediate
    weightgrad_bytes: float   # frontend grads up + averaged grads down

    @property
    def total(self) -> float:
        return self.input_bytes + self.activation_bytes + \
            self.weightgrad_bytes


def traffic(model, sched: Schedule, sample_bytes: float,
            origin: str = "device", wire: str = "none") -> TrafficReport:
    """Bytes one iteration moves across worker boundaries.  The
    activation channel is wire-aware and honors asymmetric fwd/bwd
    dtypes: forward bytes come from ``act_bytes``/``act_elems`` and
    backward bytes from ``grad_bytes``/``grad_elems`` independently,
    matching the cost model's ``MO``/``MG`` term for term."""
    stack = as_layerstack(model)
    metas = stack.cut_meta()
    inp = sum(b * sample_bytes for b, w in
              ((sched.b_o, sched.worker_o), (sched.b_s, sched.worker_s),
               (sched.b_l, sched.worker_l)) if w != origin)
    act = 0.0
    if sched.m_s > 0 and sched.b_s > 0 and sched.worker_s != sched.worker_o:
        m = metas[sched.m_s - 1]
        act += sched.b_s * (wire_act_bytes(m, wire) +
                            wire_grad_bytes(m, wire))
    if sched.m_l > 0 and sched.b_l > 0 and sched.worker_l != sched.worker_o:
        m = metas[sched.m_l - 1]
        act += sched.b_l * (wire_act_bytes(m, wire) +
                            wire_grad_bytes(m, wire))
    wg = 0.0
    if sched.b_s > 0 and sched.worker_s != sched.worker_o:
        wg += 2.0 * sum(m.resolved_param_bytes for m in metas[:sched.m_s])
    if sched.b_l > 0 and sched.worker_l != sched.worker_o:
        wg += 2.0 * sum(m.resolved_param_bytes for m in metas[:sched.m_l])
    return TrafficReport(inp, act, wg)
