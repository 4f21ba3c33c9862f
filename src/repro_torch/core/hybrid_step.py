"""Hybrid-parallelism execution engine (§IV-B) with exact SGD semantics.

The port of :mod:`repro.core.hybrid_step` (the triple and the star; the
tree step comes later).  It executes one HierTrain iteration the way the
paper describes it — workers holding *separate copies* of their assigned
layers, activations crossing at the cut points, and only frontend
gradients being exchanged — and produces the *same* update as vanilla
SGD over the full batch ``B``.  Two entry points:

* :func:`hybrid_sgd_step` — the paper's three-worker topology (one TASK S,
  one TASK L, one TASK O).
* :func:`multi_hybrid_sgd_step` — M TASK-S streams with per-stream cuts
  ``m_s[i]``; worker_o picks each arriving stream up at its own cut, in
  ascending-cut order.  With ``M = 1`` it runs the same operations in the
  same order as :func:`hybrid_sgd_step`, so the two agree bit for bit.

Each worker's copy is a distinct set of autograd leaves over the same
storage (``p_o``, ``p_s = params[:m_s]``, ``p_l = params[:m_l]``), so
autograd returns one gradient per copy and the weight update sums them in
a fixed order (``g_o + g_s + g_l``), then scales by ``1/B`` once.  A
shared leaf would let autograd accumulate the copies in its own order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import MultiSchedule, Schedule
from repro_torch.core.layerstack import as_layerstack
from repro_torch.core.wire import wire_act_bytes, wire_codec, wire_grad_bytes

Params = List[Dict[str, torch.Tensor]]
Batch = Tuple[torch.Tensor, torch.Tensor]


def _leaves(params: Params, n: int) -> Params:
    """Fresh autograd leaves over the storage of ``params[:n]``."""
    return [{k: v.detach().requires_grad_(True) for k, v in p.items()}
            for p in params[:n]]


def _grads(loss: torch.Tensor, copies: Sequence[Params]) -> List[Params]:
    """d loss / d every leaf of every copy (zeros where unused)."""
    flat = [(c, i, k) for c, cp in enumerate(copies)
            for i, p in enumerate(cp) for k in p]
    gs = torch.autograd.grad(loss, [copies[c][i][k] for c, i, k in flat],
                             allow_unused=True)
    out: List[Params] = [[{} for _ in cp] for cp in copies]
    for (c, i, k), g in zip(flat, gs):
        out[c][i][k] = torch.zeros_like(copies[c][i][k]) if g is None else g
    return out


def _update(params: Params, g: Dict[str, torch.Tensor], i: int, lr: float,
            B: int) -> Dict[str, torch.Tensor]:
    return {k: params[i][k] - lr * (g[k] / B) for k in params[i]}


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
        new = [{k: params[i][k] - lr * g[i][k] for k in params[i]}
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
                g = {k: g[k] + g_s[i][k] for k in g}
            if i < m_l and b_l:
                g = {k: g[k] + g_l[i][k] for k in g}
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
    scaled once by ``1/B``.  With ``M = 1`` and the same schedule this
    runs the operations of :func:`hybrid_sgd_step` in the same order
    (including the ``wire`` codec, applied per arriving stream at its
    cut), so the two agree bit for bit.
    """
    stack = as_layerstack(model)
    N = stack.num_layers
    codec = wire_codec(wire)
    m_s = tuple(int(m) for m in m_s)
    M = len(m_s)
    x_o, y_o = batches["o"]
    s_streams = batches["s"]
    x_l, y_l = batches["l"]
    assert len(s_streams) == M
    assert all(0 <= m <= m_l for m in m_s) and m_l <= N
    b_s = [sx.shape[0] for sx, _ in s_streams]
    b_o, b_l = x_o.shape[0], x_l.shape[0]
    B = b_o + sum(b_s) + b_l
    # Streams join worker_o's batch in ascending-cut order (stream index
    # breaks ties) — the labels must concatenate in the same order.
    join_order = sorted((i for i in range(M) if b_s[i]),
                        key=lambda i: (m_s[i], i))

    p_o = _leaves(params, N)
    p_s = [_leaves(params, m) for m in m_s]
    p_l = _leaves(params, m_l)

    # --- forward: every front-end up to its own cut ---
    h: List[Optional[torch.Tensor]] = [
        stack.apply_segment(p_s[i], s_streams[i][0], 0, m_s[i])
        if b_s[i] else None for i in range(M)]
    h_l = stack.apply_segment(p_l, x_l, 0, m_l) if b_l else None
    if codec is not None:
        h = [codec(h[i]) if h[i] is not None and m_s[i] > 0 else h[i]
             for i in range(M)]
        if h_l is not None and m_l > 0:
            h_l = codec(h_l)
    # worker_o walks its segment list, merging arrivals at their cuts.
    cur = x_o
    prev = 0
    for i in join_order:
        if m_s[i] != prev:
            cur = stack.apply_segment(p_o, cur, prev, m_s[i])
            prev = m_s[i]
        cur = torch.cat([cur, h[i]], dim=0)
    cur = stack.apply_segment(p_o, cur, prev, m_l)
    if h_l is not None:
        cur = torch.cat([cur, h_l], dim=0)
    logits = stack.apply_segment(p_o, cur, m_l, N)
    labels = torch.cat(
        [y_o] + [s_streams[i][1] for i in join_order] + [y_l], dim=0)
    total_loss = stack.sum_loss(logits, labels)

    grads = _grads(total_loss, [p_o, *p_s, p_l])
    g_o, g_s, g_l = grads[0], grads[1:1 + M], grads[1 + M]

    # --- weight-update phase: layer-wise gradient exchange ---------------
    new_params: Params = []
    with torch.no_grad():
        for i in range(N):
            g = g_o[i]
            for d in range(M):
                if i < m_s[d] and b_s[d]:
                    g = {k: g[k] + g_s[d][i][k] for k in g}
            if i < m_l and b_l:
                g = {k: g[k] + g_l[i][k] for k in g}
            new_params.append(_update(params, g, i, lr, B))
    return new_params, total_loss.detach() / B


def multi_hybrid_step_from_schedule(model, params: Params, x: torch.Tensor,
                                    y: torch.Tensor, sched: MultiSchedule,
                                    lr: float, wire: str = "none"
                                    ) -> Tuple[Params, torch.Tensor]:
    return multi_hybrid_sgd_step(model, params,
                                 multi_split_batch(x, y, sched),
                                 sched.m_s, sched.m_l, lr, wire=wire)


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
