"""Steady-state pipelined-execution cost model — ``T_period`` (DESIGN.md §7).

The per-iteration model (Eq. 12, :mod:`repro_torch.core.cost_model`) scores one
minibatch in isolation.  When consecutive minibatches are pipelined
(:func:`repro_torch.core.simulator.simulate_pipeline`), the wall-clock of a
depth-K run is ``T(K) = T_fill + (K - 1) * T_period``: after the first
iteration fills the pipe, every further iteration costs one steady-state
*period*.  The period is the max of two families of lower bounds, both of
which the DES empirically attains:

* **Busy-time arms** — each worker CPU and each directed link pipe (plus,
  on the star topology, the per-device TC input-class pipes and the shared
  input backhaul) executes its per-iteration workload once per period, so
  per-resource busy time bounds the period (the classic pipeline
  bottleneck bound).
* **Recurrence bound** — synchronous SGD adds one lag edge per worker:
  iteration-k forwards wait on that worker's iteration-(k-1) weight
  update.  The per-iteration task DAG plus these lag edges is a marked
  event graph whose steady-state period is its maximum cycle mean — the
  max-plus eigenvalue of the iteration-to-iteration completion-time
  recurrence.  We estimate it by vectorized power iteration over the
  fixed task topology (the graph is tiny — ~20 nodes — so the transient
  dies out in a handful of steps): exact whenever the critical cycle's
  cyclicity divides the averaging window (every divisor of ``_WINDOW``;
  always observed on measured schedules) and within
  ``O(intra-cycle variation / _WINDOW)`` otherwise.  On round-trip-heavy
  schedules this bound, not any single resource, sets the period — which
  is exactly why throughput-optimal schedules cut differently than
  latency-optimal ones (DESIGN.md §7).

Input transfers are prefetchable (no lag edges), so they appear in the
busy arms but not in the recurrence.

Scalar entry points evaluate the batched kernels at K = 1, so scalar and
batched results are bit-identical by construction and the throughput
scheduler's batched argmin reproduces the reference scheduler's
sequential min exactly.  The M-device forms mirror the three-worker forms
operation-for-operation (catch-up terms are exactly ``+0.0`` at M = 1).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np

from repro_torch.core.cost_model import (WIDX, WORKERS, HierProfile, MultiProfile,
                                   MultiSchedule, Network, Schedule,
                                   StarNetwork, _t_total, _t_total_multi,
                                   bw_matrix)

# Power-iteration horizon for the max-plus eigenvalue: ``_UNFOLD`` steps,
# slope averaged over the last ``_WINDOW``.  The estimate is exact when
# the critical cycle's cyclicity (its number of lag edges — up to M + 2
# on the star graph) divides the window; 60's divisors cover 1-6, 10,
# 12, 15, 20, 30, 60, and any other cyclicity leaves a residual bounded
# by (intra-cycle variation) / 60.
_UNFOLD = 128
_WINDOW = 60


def _maxplus_period_3w(d: Dict[str, np.ndarray]) -> np.ndarray:
    """Max cycle mean of the 3-worker iteration graph, per lane.

    ``d`` maps task name -> per-lane duration ``[K]``.  Runs the
    completion-time recurrence (one lag edge per worker: ``u_* -> f_*``)
    and returns the asymptotic slope of the makespan.
    """
    z = np.zeros_like(d["f_o1"])
    u_o, u_s, u_l = z, z, z
    m_hist = []
    for _ in range(_UNFOLD):
        f_s = u_s + d["f_s"]
        act_s = f_s + d["act_s"]
        f_l = u_l + d["f_l"]
        act_l = f_l + d["act_l"]
        f_o1 = u_o + d["f_o1"]
        f_o2 = np.maximum(f_o1, act_s) + d["f_o2"]
        f_o3 = np.maximum(f_o2, act_l) + d["f_o3"]
        b_o3 = f_o3 + d["b_o3"]
        gact_l = b_o3 + d["gact_l"]
        b_l = gact_l + d["b_l"]
        b_o2 = b_o3 + d["b_o2"]
        gact_s = b_o2 + d["gact_s"]
        b_s = gact_s + d["b_s"]
        b_o1 = b_o2 + d["b_o1"]
        wg_s_up = b_s + d["wg_s"]
        wg_l_up = b_l + d["wg_l"]
        wg_s_down = np.maximum(wg_s_up, b_o1) + d["wg_s"]
        wg_l_down = np.maximum(wg_l_up, b_o1) + d["wg_l"]
        u_o = np.maximum(np.maximum(b_o1, wg_s_up), wg_l_up) + d["u_o"]
        u_s = wg_s_down + d["u_s"]
        u_l = wg_l_down + d["u_l"]
        m_hist.append(np.maximum(np.maximum(u_o, u_s), u_l))
    return (m_hist[-1] - m_hist[-1 - _WINDOW]) / _WINDOW


def _period_parts(profile: HierProfile, net: Network, o_idx: np.ndarray,
                  s_idx: np.ndarray, l_idx: np.ndarray, ms: np.ndarray,
                  ml: np.ndarray, b: np.ndarray, origin: str
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-lane ``(cpu busy [K,3], link busy [K,3,3], recurrence [K])``."""
    N = profile.num_layers
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    bwm = bw_matrix(net)
    oi = WIDX[origin]
    Q = profile.sample_bytes
    K = o_idx.shape[0]
    ar = np.arange(K)
    bo = np.asarray(b[:, 0], np.float64)
    bs = np.asarray(b[:, 1], np.float64)
    bl = np.asarray(b[:, 2], np.float64)
    B = bo + bs + bl

    bw_os = bwm[o_idx, s_idx]
    bw_ol = bwm[o_idx, l_idx]

    def t_in(w_idx: np.ndarray, bb: np.ndarray) -> np.ndarray:
        return np.where((bb == 0) | (w_idx == oi), 0.0,
                        bb * Q / bwm[oi, w_idx])

    in_o, in_s, in_l = t_in(o_idx, bo), t_in(s_idx, bs), t_in(l_idx, bl)
    mo_s = profile.MO[np.maximum(ms, 1) - 1]
    mo_l = profile.MO[np.maximum(ml, 1) - 1]
    mg_s = profile.MG[np.maximum(ms, 1) - 1]
    mg_l = profile.MG[np.maximum(ml, 1) - 1]
    d = {
        "act_s": np.where((ms > 0) & (bs > 0), bs * mo_s / bw_os, 0.0),
        "act_l": np.where((ml > 0) & (bl > 0), bl * mo_l / bw_ol, 0.0),
        "gact_s": np.where((ms > 0) & (bs > 0), bs * mg_s / bw_os, 0.0),
        "gact_l": np.where((ml > 0) & (bl > 0), bl * mg_l / bw_ol, 0.0),
        "wg_s": np.where(bs > 0, MPc[ms] / bw_os, 0.0),   # one-way leg
        "wg_l": np.where(bl > 0, MPc[ml] / bw_ol, 0.0),
        "f_s": bs * F[s_idx, ms],
        "b_s": bs * Bk[s_idx, ms],
        "u_s": np.where(bs > 0, U[s_idx, ms], 0.0),
        "f_l": bl * F[l_idx, ml],
        "b_l": bl * Bk[l_idx, ml],
        "u_l": np.where(bl > 0, U[l_idx, ml], 0.0),
        "f_o1": bo * F[o_idx, ms],
        "f_o2": (bo + bs) * (F[o_idx, ml] - F[o_idx, ms]),
        "f_o3": B * (F[o_idx, N] - F[o_idx, ml]),
        "b_o3": B * (Bk[o_idx, N] - Bk[o_idx, ml]),
        "b_o2": (bo + bs) * (Bk[o_idx, ml] - Bk[o_idx, ms]),
        "b_o1": bo * Bk[o_idx, ms],
        "u_o": np.broadcast_to(U[o_idx, N], (K,)).astype(np.float64),
    }

    cpu = np.zeros((K, 3))
    np.add.at(cpu, (ar, o_idx), d["f_o1"] + d["f_o2"] + d["f_o3"] +
              d["b_o3"] + d["b_o2"] + d["b_o1"] + d["u_o"])
    np.add.at(cpu, (ar, s_idx), d["f_s"] + d["b_s"] + d["u_s"])
    np.add.at(cpu, (ar, l_idx), d["f_l"] + d["b_l"] + d["u_l"])
    link = np.zeros((K, 3, 3))
    np.add.at(link, (ar, oi, o_idx), in_o)
    np.add.at(link, (ar, oi, s_idx), in_s)
    np.add.at(link, (ar, oi, l_idx), in_l)
    np.add.at(link, (ar, s_idx, o_idx), d["act_s"] + d["wg_s"])
    np.add.at(link, (ar, o_idx, s_idx), d["gact_s"] + d["wg_s"])
    np.add.at(link, (ar, l_idx, o_idx), d["act_l"] + d["wg_l"])
    np.add.at(link, (ar, o_idx, l_idx), d["gact_l"] + d["wg_l"])
    return cpu, link, _maxplus_period_3w(d)


def t_period_batch(profile: HierProfile, net: Network,
                   o_idx: np.ndarray, s_idx: np.ndarray, l_idx: np.ndarray,
                   ms: np.ndarray, ml: np.ndarray, b: np.ndarray,
                   origin: str = "device") -> np.ndarray:
    """Vectorized steady-state period over K candidate schedules (same
    index conventions as :func:`repro_torch.core.cost_model.t_total_batch`)."""
    cpu, link, rec = _period_parts(profile, net, o_idx, s_idx, l_idx, ms,
                                   ml, b, origin)
    return np.maximum(np.maximum(cpu.max(axis=1), link.max(axis=(1, 2))),
                      rec)


def _lane(sched: Schedule) -> Tuple[np.ndarray, ...]:
    return (np.array([WIDX[sched.worker_o]]),
            np.array([WIDX[sched.worker_s]]),
            np.array([WIDX[sched.worker_l]]),
            np.array([sched.m_s]), np.array([sched.m_l]),
            np.array([[sched.b_o, sched.b_s, sched.b_l]]))


def t_period(profile: HierProfile, net: Network, sched: Schedule,
             origin: str = "device") -> float:
    """Steady-state seconds per iteration of the pipelined schedule."""
    o_idx, s_idx, l_idx, ms, ml, b = _lane(sched)
    return float(t_period_batch(profile, net, o_idx, s_idx, l_idx, ms, ml,
                                b, origin)[0])


def t_period_breakdown(profile: HierProfile, net: Network, sched: Schedule,
                       origin: str = "device") -> Dict[str, object]:
    """Diagnostics: every period arm plus the binding one."""
    o_idx, s_idx, l_idx, ms, ml, b = _lane(sched)
    cpu, link, rec = _period_parts(profile, net, o_idx, s_idx, l_idx, ms,
                                   ml, b, origin)
    arms = {f"cpu:{WORKERS[i]}": float(cpu[0, i]) for i in range(3)
            if cpu[0, i] > 0.0}
    for a in range(3):
        for c in range(3):
            if link[0, a, c] > 0.0:
                arms[f"link:{WORKERS[a]}->{WORKERS[c]}"] = \
                    float(link[0, a, c])
    arms["recurrence"] = float(rec[0])
    period = max(arms.values())
    bottleneck = max(arms, key=lambda k: arms[k])
    return {"period": period, "bottleneck": bottleneck, "arms": arms}


# ---------------------------------------------------------------------------
# M-device star topology (DESIGN.md §6 + §7).
# ---------------------------------------------------------------------------


def _maxplus_period_multi(d: Dict[str, np.ndarray]) -> np.ndarray:
    """Max cycle mean of the M-device iteration graph, per lane.

    Stream-indexed durations (``f_s``, ``act_s``, ``b_s``, ``u_s``,
    ``wg_s``) are ``[K, M]``; the rest ``[K]``.  At M = 1 the recurrence
    is the three-worker one operation-for-operation.
    """
    z = np.zeros_like(d["f_o1"])
    u_o, u_l = z, z
    u_s = np.zeros_like(d["f_s"])
    m_hist = []
    for _ in range(_UNFOLD):
        f_s = u_s + d["f_s"]
        act_s = f_s + d["act_s"]
        f_l = u_l + d["f_l"]
        act_l = f_l + d["act_l"]
        f_o1 = u_o + d["f_o1"]
        f_o2 = np.maximum(f_o1, act_s.max(axis=1)) + d["f_o2"]
        f_o3 = np.maximum(f_o2, act_l) + d["f_o3"]
        b_o3 = f_o3 + d["b_o3"]
        gact_l = b_o3 + d["gact_l"]
        b_l = gact_l + d["b_l"]
        b_o2 = b_o3 + d["b_o2"]
        gact_s = b_o2[:, None] + d["gact_s"]
        b_s = gact_s + d["b_s"]
        b_o1 = b_o2 + d["b_o1"]
        wg_s_up = b_s + d["wg_s"]
        wg_l_up = b_l + d["wg_l"]
        wg_s_down = np.maximum(wg_s_up, b_o1[:, None]) + d["wg_s"]
        wg_l_down = np.maximum(wg_l_up, b_o1) + d["wg_l"]
        u_o = np.maximum(np.maximum(b_o1, wg_s_up.max(axis=1)),
                         wg_l_up) + d["u_o"]
        u_s = wg_s_down + d["u_s"]
        u_l = wg_l_down + d["u_l"]
        m_hist.append(np.maximum(np.maximum(u_o, u_s.max(axis=1)), u_l))
    return (m_hist[-1] - m_hist[-1 - _WINDOW]) / _WINDOW


def _period_parts_multi(profile: MultiProfile, net: StarNetwork,
                        o_idx: np.ndarray, s_idx: np.ndarray,
                        l_idx: np.ndarray, ms: np.ndarray, ml: np.ndarray,
                        b: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray, np.ndarray]:
    """Per-lane ``(cpu [K,W], link [K,W,W], in_de [K,M,E+1],
    in_ec [K,E], in_fx [K,E,E], in_cd [K,E], recurrence [K])`` for the
    star/tree topologies: ``in_de`` is the per-device radio busy time
    per input class (one per destination edge plus ``->cloud``);
    ``in_ec`` the per-edge uplink cloud classes (``edge_e->cloud``);
    ``in_fx`` the per-edge uplink foreign-relay classes
    (``edge_e->cloud:edge_k``) and ``in_cd`` the cloud downlink classes
    (``cloud->edge_e``), both only used by foreign-edge relays and
    identically zero at E=1 where ``in_ec[:, 0]`` is the star's shared
    input backhaul."""
    N = profile.num_layers
    M = profile.num_devices       # data holders (locality), not streams
    S = profile.num_streams
    W = profile.num_workers
    E = net.num_edges
    edge_of = np.asarray(net.edge_of)
    backhaul = net.backhaul
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    bwm = net.bw_matrix()
    Q = profile.sample_bytes
    K = o_idx.shape[0]
    ar = np.arange(K)
    bo = np.asarray(b[:, 0], np.float64)
    bs = np.asarray(b[:, 1:1 + S], np.float64)
    bl = np.asarray(b[:, 1 + S], np.float64)
    o2 = o_idx[:, None]
    msmax = ms.max(axis=1)

    bw_os = bwm[o2, s_idx]                                # [K, S]
    bw_ol = bwm[o_idx, l_idx]
    mo_s = profile.MO[np.maximum(ms, 1) - 1]
    mo_l = profile.MO[np.maximum(ml, 1) - 1]
    mg_s = profile.MG[np.maximum(ms, 1) - 1]
    mg_l = profile.MG[np.maximum(ml, 1) - 1]
    bs_sum = bs.sum(axis=1)
    B = bo + bs_sum + bl
    catch_f = (bs * (F[o2, msmax[:, None]] - F[o2, ms])).sum(axis=1)
    catch_b = (bs * (Bk[o2, msmax[:, None]] - Bk[o2, ms])).sum(axis=1)
    d = {
        "act_s": np.where((ms > 0) & (bs > 0), bs * mo_s / bw_os, 0.0),
        "act_l": np.where((ml > 0) & (bl > 0), bl * mo_l / bw_ol, 0.0),
        "gact_s": np.where((ms > 0) & (bs > 0), bs * mg_s / bw_os, 0.0),
        "gact_l": np.where((ml > 0) & (bl > 0), bl * mg_l / bw_ol, 0.0),
        "wg_s": np.where(bs > 0, MPc[ms] / bw_os, 0.0),   # one-way leg
        "wg_l": np.where(bl > 0, MPc[ml] / bw_ol, 0.0),
        "f_s": bs * F[s_idx, ms],
        "b_s": bs * Bk[s_idx, ms],
        "u_s": np.where(bs > 0, U[s_idx, ms], 0.0),
        "f_l": bl * F[l_idx, ml],
        "b_l": bl * Bk[l_idx, ml],
        "u_l": np.where(bl > 0, U[l_idx, ml], 0.0),
        "f_o1": bo * F[o_idx, msmax],
        "f_o2": (bo + bs_sum) * (F[o_idx, ml] - F[o_idx, msmax]) + catch_f,
        "f_o3": B * (F[o_idx, N] - F[o_idx, ml]),
        "b_o3": B * (Bk[o_idx, N] - Bk[o_idx, ml]),
        "b_o2": (bo + bs_sum) * (Bk[o_idx, ml] - Bk[o_idx, msmax]) +
                catch_b,
        "b_o1": bo * Bk[o_idx, msmax],
        "u_o": np.broadcast_to(U[o_idx, N], (K,)).astype(np.float64),
    }

    cpu = np.zeros((K, W))
    np.add.at(cpu, (ar, o_idx), d["f_o1"] + d["f_o2"] + d["f_o3"] +
              d["b_o3"] + d["b_o2"] + d["b_o1"] + d["u_o"])
    for i in range(S):
        np.add.at(cpu, (ar, s_idx[:, i]),
                  d["f_s"][:, i] + d["b_s"][:, i] + d["u_s"][:, i])
    np.add.at(cpu, (ar, l_idx), d["f_l"] + d["b_l"] + d["u_l"])
    link = np.zeros((K, W, W))
    for i in range(S):
        np.add.at(link, (ar, s_idx[:, i], o_idx),
                  d["act_s"][:, i] + d["wg_s"][:, i])
        np.add.at(link, (ar, o_idx, s_idx[:, i]),
                  d["gact_s"][:, i] + d["wg_s"][:, i])
    np.add.at(link, (ar, l_idx, o_idx), d["act_l"] + d["wg_l"])
    np.add.at(link, (ar, o_idx, l_idx), d["gact_l"] + d["wg_l"])

    # TC input-class pipes: device j's radio carries a ``b/M`` chunk of
    # every edge- or cloud-resident task's sub-batch, one shaped class per
    # (device, destination) pair — matching the simulator; cloud- and
    # foreign-edge-bound chunks then serialize on the sender's edge
    # uplink backhaul (upload order o, s_i..., l — matching the
    # simulator's task-add order), and foreign-edge chunks additionally
    # on the destination edge's cloud downlink.
    in_de = np.zeros((K, M, E + 1))    # [..., e] ->edge_e, [..., E] ->cloud
    in_ec = np.zeros((K, E))           # uplink class edge_e -> cloud
    in_fx = np.zeros((K, E, E))        # uplink class edge_e -> foreign edge
    in_cd = np.zeros((K, E))           # downlink cloud -> edge_e
    counts = np.bincount(edge_of, minlength=E).astype(np.float64)

    def ingest(w_idx: np.ndarray, bb: np.ndarray) -> None:
        chunk = np.where((w_idx < M) | (bb == 0), 0.0, bb * Q / M)
        cloud_c = np.where(w_idx == W - 1, chunk, 0.0)
        edge_c = [np.where(w_idx == M + e, chunk, 0.0) for e in range(E)]
        for j in range(M):
            for e in range(E):
                in_de[:, j, e] += edge_c[e] / net.bw_de[j]
            in_de[:, j, E] += cloud_c / net.bw_de[j]
        for e in range(E):
            # edge e's devices relay cloud-bound chunks over edge e's
            # uplink cloud class; at E=1 this is the star's
            # ``M * (cloud_c / bw_ec)`` term bit-for-bit.  Foreign-edge
            # chunks ride their own per-destination uplink class and the
            # destination's downlink class (both absent at E=1),
            # matching the simulator's shaped pipes.
            in_ec[:, e] += counts[e] * (cloud_c / backhaul[e])
            for e2 in range(E):
                if e2 != e:
                    in_fx[:, e, e2] += counts[e] * (edge_c[e2] /
                                                    backhaul[e])
            if M - counts[e] > 0:
                in_cd[:, e] += (M - counts[e]) * (edge_c[e] / backhaul[e])

    ingest(o_idx, bo)
    for i in range(S):
        ingest(s_idx[:, i], bs[:, i])
    ingest(l_idx, bl)

    return cpu, link, in_de, in_ec, in_fx, in_cd, _maxplus_period_multi(d)


def t_period_multi_batch(profile: MultiProfile, net: StarNetwork,
                         o_idx: np.ndarray, s_idx: np.ndarray,
                         l_idx: np.ndarray, ms: np.ndarray, ml: np.ndarray,
                         b: np.ndarray) -> np.ndarray:
    """Vectorized M-device steady-state period over K candidates (same
    index conventions as
    :func:`repro_torch.core.cost_model.t_total_multi_batch`)."""
    cpu, link, in_de, in_ec, in_fx, in_cd, rec = _period_parts_multi(
        profile, net, o_idx, s_idx, l_idx, ms, ml, b)
    busy = np.maximum(np.maximum(cpu.max(axis=1), link.max(axis=(1, 2))),
                      np.maximum(in_de.max(axis=(1, 2)),
                                 np.maximum(in_ec.max(axis=1),
                                            np.maximum(in_fx.max(axis=(1, 2)),
                                                       in_cd.max(axis=1)))))
    return np.maximum(busy, rec)


def _lane_multi(profile: MultiProfile,
                sched: MultiSchedule) -> Tuple[np.ndarray, ...]:
    widx = profile.widx
    return (np.array([widx[sched.worker_o]]),
            np.array([[widx[w] for w in sched.s_workers]]),
            np.array([widx[sched.worker_l]]),
            np.array([list(sched.m_s)]), np.array([sched.m_l]),
            np.array([[sched.b_o, *sched.b_s, sched.b_l]]))


def t_period_multi(profile: MultiProfile, net: StarNetwork,
                   sched: MultiSchedule) -> float:
    """Steady-state period of an M-device pipelined schedule."""
    o_idx, s_idx, l_idx, ms, ml, b = _lane_multi(profile, sched)
    return float(t_period_multi_batch(profile, net, o_idx, s_idx, l_idx,
                                      ms, ml, b)[0])


def t_period_tree(profile: MultiProfile, net: StarNetwork,
                  sched: MultiSchedule) -> float:
    """Steady-state period of a two-level tree pipelined schedule.

    Accepts a :class:`TreeProfile`/:class:`TreeNetwork` pair (the
    star-shaped arguments also work — a star is the E=1 tree); at E=1
    the result is bit-identical to :func:`t_period_multi`."""
    return t_period_multi(profile, net, sched)


# ---------------------------------------------------------------------------
# Depth-K wall clock.
# ---------------------------------------------------------------------------


def t_pipeline(profile: Union[HierProfile, MultiProfile],
               net: Union[Network, StarNetwork],
               sched: Union[Schedule, MultiSchedule], K: int,
               origin: str = "device") -> float:
    """Model wall-clock of a depth-K pipelined run:
    ``T(K) = T_fill + (K - 1) * T_period`` with the Eq.-12 single-iteration
    latency as the fill term (DESIGN.md §7)."""
    assert K >= 1
    if isinstance(sched, MultiSchedule):
        fill = _t_total_multi(profile, net, sched).total
        return fill + (K - 1) * t_period_multi(profile, net, sched)
    fill = _t_total(profile, net, sched, origin).total
    return fill + (K - 1) * t_period(profile, net, sched, origin)
