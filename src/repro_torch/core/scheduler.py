"""Algorithm 1 of the paper: optimal HierTrain scheduling policy.

For every one of the 6 worker-role mappings and every cut pair
``(m_s, m_l)`` with ``0 <= m_s <= m_l <= N``, problem P1 (Eqs. 16-19) with the
cuts fixed is an ILP.  Per §V we relax it to an LP in epigraph form (one
epigraph variable per max-term of Eq. 12), solve, round with the paper's
largest-fraction rule, and keep the schedule with the smallest *exact*
integer-evaluated ``T_total``.

Two backends (DESIGN.md §Scheduler-engine):

* ``backend="batched"`` (default) — builds the constraint tensors for *all*
  ``(mapping, m_s, m_l)`` candidates in one shot from the profile's prefix
  arrays, prunes candidates whose cut-constant lower bound (the ``T^3`` +
  ``T_update`` terms, which the LP cannot change) already exceeds an
  incumbent, solves the survivors as ONE stacked simplex call
  (:mod:`repro_torch.core.batched_lp`), rounds every batch split vectorized, and
  evaluates the exact integer ``T_total`` of all survivors with
  :func:`repro_torch.core.cost_model._t_total_batch` before the argmin.
* ``backend="reference"`` — the original sequential loop over scalar
  two-phase-simplex calls.  Kept as the correctness oracle; the equivalence
  suite asserts both backends return schedules with identical ``T_total``.

:func:`_solve_multi` generalizes the search to M heterogeneous devices
around one edge and one cloud (DESIGN.md §6): an exhaustive stage over
every (worker_o, worker_l) mapping and shared-cut pair — bit-identical to
:func:`_solve_3w` at M = 1 — followed by batched coordinate descent on the
per-device cuts for M >= 2.

Both solvers take ``objective="latency"`` (default, Eq. 12 ``T_total``)
or ``objective="throughput"``, which reuses the same LP stack and
dominance prune but scores candidates with the pipelined steady-state
period (:mod:`repro_torch.core.pipeline`, DESIGN.md §7).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import batched_lp
from repro_torch.core import lp as lp_mod
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.cost_model import (WIDX, WORKERS, Breakdown, HierProfile,
                                   MultiProfile, MultiSchedule, Network,
                                   Schedule, StarNetwork, _t_total,
                                   _t_total_batch, _t_total_multi,
                                   _t_total_multi_batch, bw_matrix)

OBJECTIVES = ("latency", "throughput")

_LP_NUM_VARS = 7          # [b_o, b_s, b_l, t1, t2, t3, t4]
_LP_NUM_UB = 12           # 10 epigraph arms + constraints (14)/(15)
_LP_COST = np.array([0, 0, 0, 1, 1, 1, 1], np.float64)


@dataclasses.dataclass
class SchedulerResult:
    schedule: Schedule
    breakdown: Breakdown
    t_total: float
    n_lp_solved: int
    search_log: List[Tuple[Schedule, float]]
    n_candidates: int = 0
    n_pruned: int = 0
    objective: str = "latency"
    t_period: Optional[float] = None   # steady-state period of the winner


def _round_batch_split(b_real: np.ndarray, B: int,
                       allowed: np.ndarray) -> np.ndarray:
    """Paper §V rounding: floor everything, then hand the missing units to
    the entries with the largest fractional parts.  Entries with
    ``allowed == False`` (their ``m`` is 0) are forced to exactly 0 — they
    may neither keep an integer part nor receive extra units.  Any residue
    the largest-fraction pass cannot place lands on ``b_o`` (always
    allowed); a floor *overshoot* (LP numerics handing out more than ``B``
    units) is stripped from the largest entries without driving any entry
    below zero, so the result always satisfies ``sum == B`` and ``>= 0``.

    Entries are clamped to ``[0, B]`` up front: every feasible LP point
    satisfies that bound already (Eq. 17 plus nonnegativity), so real
    solutions are untouched, while a failed lane's garbage ``x`` (e.g. a
    phase-2 ray) can no longer make the one-unit strip loop crawl for
    millions of iterations — such lanes are discarded by the caller's
    success mask anyway, but they must still round in bounded time.
    """
    b_real = np.clip(np.asarray(b_real, np.float64), 0.0, float(B))
    allowed = np.asarray(allowed, bool)
    b_real = np.where(allowed, b_real, 0.0)
    ints = np.floor(b_real + 1e-9).astype(np.int64)
    fracs = np.where(allowed, b_real - ints, -1.0)
    deficit = int(B - ints.sum())
    out = ints.copy()
    for idx in np.argsort(-fracs, kind="stable"):
        if deficit <= 0:
            break
        if not allowed[idx]:
            continue
        out[idx] += 1
        deficit -= 1
    if deficit > 0:  # more missing units than entries: dump on b_o
        out[0] += deficit
        deficit = 0
    while deficit < 0:  # overshoot: strip from the largest entries
        idx = int(np.argmax(out))
        if out[idx] <= 0:
            break
        out[idx] -= 1
        deficit += 1
    return out


def _round_batch_split_batch(b_real: np.ndarray, B: int,
                             allowed: np.ndarray) -> np.ndarray:
    """Vectorized :func:`_round_batch_split` over ``[K, 3]`` splits.
    Semantics match the scalar rule exactly (same stable largest-fraction
    order, same residue handling, same ``[0, B]`` clamp), so both
    backends round identically."""
    K = b_real.shape[0]
    ar = np.arange(K)
    b = np.clip(np.asarray(b_real, np.float64), 0.0, float(B))
    b = np.where(allowed, b, 0.0)
    ints = np.floor(b + 1e-9).astype(np.int64)
    fracs = np.where(allowed, b - ints, -1.0)
    deficit = B - ints.sum(axis=1)
    out = ints.copy()
    order = np.argsort(-fracs, axis=1, kind="stable")
    for j in range(order.shape[1]):  # one potential +1 per entry, like scalar
        idx = order[:, j]
        bump = allowed[ar, idx] & (deficit > 0)
        out[ar, idx] += bump
        deficit -= bump
    out[:, 0] += np.maximum(deficit, 0)
    deficit = np.minimum(deficit, 0)
    while (deficit < 0).any():
        idx = np.argmax(out, axis=1)
        strip = (deficit < 0) & (out[ar, idx] > 0)
        if not strip.any():
            break
        out[ar, idx] -= strip
        deficit += strip
    return out


# ---------------------------------------------------------------------------
# Reference backend: sequential scalar LPs (the seed implementation).
# ---------------------------------------------------------------------------

def _solve_cut_lp(profile: HierProfile, net: Network, wo: str, ws: str,
                  wl: str, m_s: int, m_l: int, B: int,
                  origin: str) -> Optional[np.ndarray]:
    """LP relaxation of P1 for a fixed mapping and fixed cuts.

    Variables ``x = [b_o, b_s, b_l, t1, t2, t3, t4] >= 0`` where
    ``t1 >= T^1_fwd``-terms, ``t2 >= T^1_bwd``, ``t3 >= T^2_fwd``,
    ``t4 >= T^2_bwd``.  ``T^3`` and ``T_update`` are constant once the cuts
    are fixed (they involve the full batch ``B`` / only prefix parameter
    sums), so they do not enter the LP objective.
    """
    p = profile.prefix()
    F, Bk = p["F"], p["Bk"]
    o, s, l = WIDX[wo], WIDX[ws], WIDX[wl]
    Q = profile.sample_bytes
    bw_os, bw_ol = net.bw(wo, ws), net.bw(wo, wl)
    in_o = 0.0 if wo == origin else Q / net.bw(origin, wo)
    in_s = 0.0 if ws == origin else Q / net.bw(origin, ws)
    in_l = 0.0 if wl == origin else Q / net.bw(origin, wl)
    mo_s = profile.MO[m_s - 1] / bw_os if m_s > 0 else 0.0
    mo_l = profile.MO[m_l - 1] / bw_ol if m_l > 0 else 0.0
    mg_s = profile.MG[m_s - 1] / bw_os if m_s > 0 else 0.0
    mg_l = profile.MG[m_l - 1] / bw_ol if m_l > 0 else 0.0

    nv = _LP_NUM_VARS
    A_ub, b_ub = [], []

    def ub(coef_b, t_idx):  # coef_b @ [b_o,b_s,b_l] - t <= 0
        row = np.zeros(nv)
        row[:3] = coef_b
        row[3 + t_idx] = -1.0
        A_ub.append(row)
        b_ub.append(0.0)

    # t1 >= each arm of Eq. (5); t2 >= each arm of Eq. (6) (backward arms
    # ship the activation *gradient*: MG-based wire terms).
    ub([in_o + F[o, m_s], 0, 0], 0)
    ub([0, in_s + F[s, m_s] + mo_s, 0], 0)
    ub([0, 0, in_l + F[l, m_s]], 0)
    ub([Bk[o, m_s], 0, 0], 1)
    ub([0, Bk[s, m_s] + mg_s, 0], 1)
    ub([0, 0, Bk[l, m_s]], 1)
    # t3 >= each arm of Eq. (7); t4 >= each arm of Eq. (8).
    ub([F[o, m_l] - F[o, m_s], F[o, m_l] - F[o, m_s], 0], 2)
    ub([0, 0, (F[l, m_l] - F[l, m_s]) + mo_l], 2)
    ub([Bk[o, m_l] - Bk[o, m_s], Bk[o, m_l] - Bk[o, m_s], 0], 3)
    ub([0, 0, (Bk[l, m_l] - Bk[l, m_s]) + mg_l], 3)
    # Constraints (14)/(15): b_s <= m_s*B, b_l <= m_l*B.
    row = np.zeros(nv); row[1] = 1.0
    A_ub.append(row); b_ub.append(float(m_s) * B)
    row = np.zeros(nv); row[2] = 1.0
    A_ub.append(row); b_ub.append(float(m_l) * B)
    # Constraint (17): b_o + b_s + b_l = B.
    A_eq = np.zeros((1, nv)); A_eq[0, :3] = 1.0
    b_eq = np.array([float(B)])

    res = lp_mod.linprog(_LP_COST, np.array(A_ub), np.array(b_ub), A_eq, b_eq)
    if not res.success:
        return None
    return res.x[:3]


def _solve_reference(profile: HierProfile, net: Network, B: int,
                     origin: str, workers: Tuple[str, ...],
                     keep_log: bool,
                     objective: str = "latency") -> SchedulerResult:
    """Algorithm 1, one scalar LP at a time (the correctness oracle).

    ``objective="throughput"`` keeps the same LP relaxation (splits are
    still balanced for latency) but scores every rounded candidate with
    the steady-state period instead of ``T_total`` (DESIGN.md §7).
    """
    N = profile.num_layers
    best: Optional[Tuple[Schedule, Breakdown]] = None
    best_score = np.inf
    n_lp = 0
    log: List[Tuple[Schedule, float]] = []
    for wo, ws, wl in itertools.permutations(workers, 3):
        for m_s in range(0, N + 1):
            for m_l in range(m_s, N + 1):
                n_lp += 1
                b = _solve_cut_lp(profile, net, wo, ws, wl, m_s, m_l, B,
                                  origin)
                if b is None:
                    continue
                allowed = np.array([True, m_s > 0, m_l > 0])
                b_int = _round_batch_split(b, B, allowed)
                sched = Schedule(wo, ws, wl, m_s, m_l,
                                 int(b_int[0]), int(b_int[1]), int(b_int[2]))
                bd = _t_total(profile, net, sched, origin)
                score = bd.total if objective == "latency" else \
                    pipeline_mod.t_period(profile, net, sched, origin)
                if keep_log:
                    log.append((sched, score))
                if best is None or score < best_score:
                    best = (sched, bd)
                    best_score = score
    assert best is not None
    return SchedulerResult(
        schedule=best[0], breakdown=best[1], t_total=best[1].total,
        n_lp_solved=n_lp, search_log=log, n_candidates=n_lp, n_pruned=0,
        objective=objective,
        t_period=pipeline_mod.t_period(profile, net, best[0], origin))


# ---------------------------------------------------------------------------
# Batched backend: one stacked LP over all surviving candidates.
# ---------------------------------------------------------------------------

def _candidate_grid(N: int, workers: Tuple[str, ...]
                    ) -> Tuple[np.ndarray, ...]:
    """All ``(mapping, m_s, m_l)`` candidates in the reference backend's
    enumeration order, as flat index arrays."""
    maps = list(itertools.permutations(workers, 3))
    ms_g, ml_g = np.triu_indices(N + 1)       # row-major == m_s outer loop
    P = ms_g.shape[0]
    o_idx = np.repeat([WIDX[m[0]] for m in maps], P)
    s_idx = np.repeat([WIDX[m[1]] for m in maps], P)
    l_idx = np.repeat([WIDX[m[2]] for m in maps], P)
    ms = np.tile(ms_g, len(maps))
    ml = np.tile(ml_g, len(maps))
    return o_idx, s_idx, l_idx, ms, ml


def _build_lp_stack(profile: HierProfile, net: Network, o_idx: np.ndarray,
                    s_idx: np.ndarray, l_idx: np.ndarray, ms: np.ndarray,
                    ml: np.ndarray, B: int, origin: str
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """Constraint tensors of the per-cut LP for all K candidates at once.

    Row layout matches :func:`_solve_cut_lp` one-to-one.
    """
    p = profile.prefix()
    F, Bk = p["F"], p["Bk"]
    K = o_idx.shape[0]
    Q = profile.sample_bytes
    bwm = bw_matrix(net)
    oi = WIDX[origin]
    bw_os = bwm[o_idx, s_idx]
    bw_ol = bwm[o_idx, l_idx]
    in_o = np.where(o_idx == oi, 0.0, Q / bwm[oi, o_idx])
    in_s = np.where(s_idx == oi, 0.0, Q / bwm[oi, s_idx])
    in_l = np.where(l_idx == oi, 0.0, Q / bwm[oi, l_idx])
    mo_s = np.where(ms > 0, profile.MO[np.maximum(ms, 1) - 1] / bw_os, 0.0)
    mo_l = np.where(ml > 0, profile.MO[np.maximum(ml, 1) - 1] / bw_ol, 0.0)
    mg_s = np.where(ms > 0, profile.MG[np.maximum(ms, 1) - 1] / bw_os, 0.0)
    mg_l = np.where(ml > 0, profile.MG[np.maximum(ml, 1) - 1] / bw_ol, 0.0)

    A_ub = np.zeros((K, _LP_NUM_UB, _LP_NUM_VARS))
    b_ub = np.zeros((K, _LP_NUM_UB))
    # t1 >= each arm of Eq. (5); t2 >= each arm of Eq. (6) (backward arms
    # use the MG-based gradient wire terms).
    A_ub[:, 0, 0] = in_o + F[o_idx, ms]
    A_ub[:, 1, 1] = in_s + F[s_idx, ms] + mo_s
    A_ub[:, 2, 2] = in_l + F[l_idx, ms]
    A_ub[:, 3, 0] = Bk[o_idx, ms]
    A_ub[:, 4, 1] = Bk[s_idx, ms] + mg_s
    A_ub[:, 5, 2] = Bk[l_idx, ms]
    A_ub[:, :3, 3] = -1.0
    A_ub[:, 3:6, 4] = -1.0
    # t3 >= each arm of Eq. (7); t4 >= each arm of Eq. (8).
    dF_o = F[o_idx, ml] - F[o_idx, ms]
    dBk_o = Bk[o_idx, ml] - Bk[o_idx, ms]
    A_ub[:, 6, 0] = dF_o
    A_ub[:, 6, 1] = dF_o
    A_ub[:, 7, 2] = (F[l_idx, ml] - F[l_idx, ms]) + mo_l
    A_ub[:, 8, 0] = dBk_o
    A_ub[:, 8, 1] = dBk_o
    A_ub[:, 9, 2] = (Bk[l_idx, ml] - Bk[l_idx, ms]) + mg_l
    A_ub[:, 6:8, 5] = -1.0
    A_ub[:, 8:10, 6] = -1.0
    # Constraints (14)/(15): b_s <= m_s*B, b_l <= m_l*B.
    A_ub[:, 10, 1] = 1.0
    b_ub[:, 10] = ms.astype(np.float64) * B
    A_ub[:, 11, 2] = 1.0
    b_ub[:, 11] = ml.astype(np.float64) * B
    # Constraint (17): b_o + b_s + b_l = B.
    A_eq = np.zeros((K, 1, _LP_NUM_VARS))
    A_eq[:, 0, :3] = 1.0
    b_eq = np.full((K, 1), float(B))
    return A_ub, b_ub, A_eq, b_eq


def _warm_ok(totals_win: float, incumbent: float) -> bool:
    """Soundness certificate for a warm-started prune (DESIGN.md §10).

    The prune drops lanes with ``const_lb > incumbent``.  If the best
    *surviving* exact score is ``<= incumbent``, then (a) every pruned
    lane scores strictly above it (``score >= const_lb > incumbent``),
    so the cold argmin lane survived, and (b) the order-preserving mask
    kept it the first minimum — the warm result is bit-identical to the
    cold one.  If instead every survivor scores above the incumbent (the
    warm schedule beat the whole surviving grid), a pruned lane could
    have been the cold winner and the caller must re-solve cold.
    """
    return totals_win <= incumbent


def _score_3w(profile: HierProfile, net: Network, objective: str,
              origin: str, o, s, l, mss, mll, bb) -> np.ndarray:
    """Objective scores of K rounded 3-worker candidates (exact eval)."""
    if objective == "latency":
        return _t_total_batch(profile, net, o, s, l, mss, mll, bb, origin)
    return pipeline_mod.t_period_batch(profile, net, o, s, l, mss, mll,
                                       bb, origin)


@dataclasses.dataclass
class _StageA3W:
    """One 3-worker fleet's pruned stage-A candidate lanes + LP stack.

    Built by :func:`_stage_a_3w`, consumed by :func:`_finish_3w`; the
    cross-fleet engine (:func:`solve_many`) concatenates many fleets'
    ``stack`` tensors into one padded simplex call.
    """
    profile: HierProfile
    net: Network
    B: int
    origin: str
    objective: str
    warm: bool                 # prune ran with a warm incumbent
    ko: np.ndarray
    ks: np.ndarray
    kl: np.ndarray
    kms: np.ndarray
    kml: np.ndarray
    K: int
    n_pruned: int
    incumbent: float
    stack: Tuple[np.ndarray, ...]   # (cost, A_ub, b_ub, A_eq, b_eq)


def _stage_a_3w(profile: HierProfile, net: Network, B: int, origin: str,
                workers: Tuple[str, ...], prune: bool, objective: str,
                warm_start: Optional[Schedule]) -> _StageA3W:
    N = profile.num_layers
    p = profile.prefix()
    F, Bk, U = p["F"], p["Bk"], p["U"]
    o_idx, s_idx, l_idx, ms, ml = _candidate_grid(N, workers)
    K = o_idx.shape[0]

    # Dominance pruning: the T^3 + T_update terms of Eq. (12) do not depend
    # on the batch split, so  B*(F_o[N]-F_o[ml]) + B*(Bk_o[N]-Bk_o[ml]) +
    # U_o[N]  lower-bounds any schedule with these cuts.  Candidates whose
    # bound already exceeds the best ``(m_s = m_l = 0)`` schedule (whose LP
    # is trivial: everything on worker_o) cannot win — skip their LPs.
    # The same constants sit inside worker_o's CPU busy time, so the bound
    # also lower-bounds the steady-state period and the prune stays valid
    # under objective="throughput" (scored against the period incumbent).
    keep = np.ones(K, bool)
    n_pruned = 0
    incumbent = np.inf
    if prune:
        Bf = float(B)
        const_lb = Bf * (F[o_idx, N] - F[o_idx, ml]) + \
            Bf * (Bk[o_idx, N] - Bk[o_idx, ml]) + U[o_idx, N]
        trivial = (ms == 0) & (ml == 0)
        b_triv = np.zeros((int(trivial.sum()), 3), np.int64)
        b_triv[:, 0] = B
        incumbent = _score_3w(profile, net, objective, origin,
                              o_idx[trivial], s_idx[trivial],
                              l_idx[trivial], ms[trivial], ml[trivial],
                              b_triv).min()
        if warm_start is not None:
            # Warm incumbent: the live schedule's exact cost on this
            # fleet (the incremental re-solve of DESIGN.md §10).
            if warm_start.batch != B:
                raise ValueError(
                    f"warm_start batch {warm_start.batch} != B {B}")
            ws_score = _t_total(profile, net, warm_start, origin).total \
                if objective == "latency" else \
                pipeline_mod.t_period(profile, net, warm_start, origin)
            incumbent = min(incumbent, ws_score)
        keep = ~(const_lb > incumbent)
        n_pruned = int(K - keep.sum())

    ko, ks, kl = o_idx[keep], s_idx[keep], l_idx[keep]
    kms, kml = ms[keep], ml[keep]
    A_ub, b_ub, A_eq, b_eq = _build_lp_stack(profile, net, ko, ks, kl,
                                             kms, kml, B, origin)
    return _StageA3W(profile=profile, net=net, B=B, origin=origin,
                     objective=objective,
                     warm=prune and warm_start is not None,
                     ko=ko, ks=ks, kl=kl, kms=kms, kml=kml, K=K,
                     n_pruned=n_pruned, incumbent=incumbent,
                     stack=(_LP_COST, A_ub, b_ub, A_eq, b_eq))


def _finish_3w(st: _StageA3W, x: np.ndarray, ok: np.ndarray,
               keep_log: bool) -> Optional[SchedulerResult]:
    """Round, score and argmin one fleet's solved stage-A lanes.

    Returns ``None`` when a warm incumbent over-pruned (the caller must
    re-solve cold — bit-identity over speed, DESIGN.md §10).
    """
    profile, net, B, origin = st.profile, st.net, st.B, st.origin
    ko, ks, kl, kms, kml = st.ko, st.ks, st.kl, st.kms, st.kml
    allowed = np.stack([np.ones_like(kms, bool), kms > 0, kml > 0], axis=1)
    b_int = _round_batch_split_batch(x[:, :3], B, allowed)
    totals = _score_3w(profile, net, st.objective, origin,
                       ko, ks, kl, kms, kml, b_int)
    totals = np.where(ok, totals, np.inf)
    if st.warm and not (ok.any() and
                        _warm_ok(float(totals.min()), st.incumbent)):
        # The warm incumbent over-pruned (the live schedule beat every
        # surviving lane) — bit-identity over speed: re-solve cold.
        return None
    assert ok.any(), "every per-cut LP failed — inconsistent profile?"
    win = int(np.argmin(totals))  # first min == reference's sequential <

    inv = {i: w for w, i in WIDX.items()}
    sched = Schedule(inv[int(ko[win])], inv[int(ks[win])], inv[int(kl[win])],
                     int(kms[win]), int(kml[win]),
                     int(b_int[win, 0]), int(b_int[win, 1]),
                     int(b_int[win, 2]))
    bd = _t_total(profile, net, sched, origin)
    log: List[Tuple[Schedule, float]] = []
    if keep_log:
        for k in np.nonzero(ok)[0]:
            log.append((Schedule(
                inv[int(ko[k])], inv[int(ks[k])], inv[int(kl[k])],
                int(kms[k]), int(kml[k]), int(b_int[k, 0]),
                int(b_int[k, 1]), int(b_int[k, 2])), float(totals[k])))
    return SchedulerResult(schedule=sched, breakdown=bd, t_total=bd.total,
                           n_lp_solved=int(ko.shape[0]), search_log=log,
                           n_candidates=st.K, n_pruned=st.n_pruned,
                           objective=st.objective,
                           t_period=pipeline_mod.t_period(profile, net,
                                                          sched, origin))


def _solve_batched(profile: HierProfile, net: Network, B: int, origin: str,
                   workers: Tuple[str, ...], keep_log: bool,
                   prune: bool, objective: str = "latency",
                   warm_start: Optional[Schedule] = None) -> SchedulerResult:
    st = _stage_a_3w(profile, net, B, origin, workers, prune, objective,
                     warm_start)
    res = batched_lp.linprog_batch(*st.stack)
    out = _finish_3w(st, res.x, res.success, keep_log)
    if out is None:
        return _solve_batched(profile, net, B, origin, workers, keep_log,
                              prune, objective, warm_start=None)
    return out


def _solve_3w(profile: HierProfile, net: Network, B: int,
              origin: str = "device",
              workers: Tuple[str, ...] = WORKERS,
              keep_log: bool = False,
              backend: str = "batched",
              prune: bool = True,
              objective: str = "latency",
              warm_start: Optional[Schedule] = None) -> SchedulerResult:
    """Algorithm 1: enumerate mappings x cuts, LP + round, return the best.

    This is the canonical *three-worker* engine — the facade
    (``repro_torch.api.plan``) runs it for triple-native fleets, and it doubles
    as the correctness oracle the M=1 equivalence suite compares the
    generalized engine against.  ``backend="batched"`` (default) solves
    all candidate LPs as one stacked simplex; ``backend="reference"`` is
    the sequential scalar oracle.  ``prune`` toggles the cut-constant
    dominance bound (batched only).  ``objective="latency"`` (default)
    minimizes the per-iteration ``T_total`` of Eq. 12;
    ``objective="throughput"`` reuses the same LP stack and pruning but
    picks the candidate with the smallest steady-state pipelined period
    ``t_period`` (DESIGN.md §7).  ``warm_start`` feeds a live schedule's
    exact cost into the dominance prune as an extra incumbent — an
    incremental re-solve that returns bit-identical results to a cold
    solve (DESIGN.md §10) while skipping more of the candidate grid.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown scheduler objective: {objective!r}")
    if backend == "reference":
        # The oracle has no prune, so a warm incumbent cannot change it.
        return _solve_reference(profile, net, B, origin, workers, keep_log,
                                objective)
    if backend != "batched":
        raise ValueError(f"unknown scheduler backend: {backend!r}")
    return _solve_batched(profile, net, B, origin, workers, keep_log, prune,
                          objective, warm_start)


# ---------------------------------------------------------------------------
# M-device scheduler (DESIGN.md §6).
#
# Stage A enumerates every (worker_o, worker_l) mapping x every *shared*
# cut pair (all TASK-S instances at the same m_s) — with M = 1 that IS the
# paper's Algorithm 1 search space in the reference enumeration order, so
# the M=1 result is bit-identical to _solve_3w().  Stage B (M >= 2 only)
# coordinate-descends the per-device cuts: every single-cut move is scored
# by one more stacked LP pass, and only strict improvements are accepted.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiSchedulerResult:
    schedule: MultiSchedule
    breakdown: Breakdown
    t_total: float
    n_lp_solved: int          # stage-A LPs: n_candidates - n_pruned
    search_log: List[Tuple[MultiSchedule, float]]
    n_candidates: int = 0
    n_pruned: int = 0
    refine_rounds: int = 0
    n_lp_refine: int = 0      # stage-B LPs, counted separately
    objective: str = "latency"
    t_period: Optional[float] = None   # steady-state period of the winner


def _multi_candidate_grid(N: int, worker_names: Tuple[str, ...]
                          ) -> Tuple[np.ndarray, ...]:
    """All (mapping, shared m_s, m_l) candidates.

    Mapping order — ``worker_o`` outer, ``worker_l`` over the *reversed*
    remaining workers — reproduces the 3-worker ``itertools.permutations``
    (o, s, l) order at M = 1, so first-min tie-breaks match the reference
    scheduler exactly.
    """
    W = len(worker_names)
    M = W - 2
    widx = {w: i for i, w in enumerate(worker_names)}
    maps = []
    for wo in worker_names:
        rest = [w for w in worker_names if w != wo]
        for wl in reversed(rest):
            s_set = tuple(w for w in rest if w != wl)
            maps.append((widx[wo], widx[wl],
                         tuple(widx[w] for w in s_set)))
    ms_g, ml_g = np.triu_indices(N + 1)       # row-major == m_s outer loop
    P = ms_g.shape[0]
    o_idx = np.repeat([m[0] for m in maps], P)
    l_idx = np.repeat([m[1] for m in maps], P)
    s_idx = np.repeat(np.array([m[2] for m in maps], np.int64), P, axis=0)
    ms = np.tile(ms_g, len(maps))[:, None] * np.ones((1, M), np.int64)
    ml = np.tile(ml_g, len(maps))
    return o_idx, s_idx, l_idx, ms, ml


def _build_multi_lp_stack(profile: MultiProfile, net: StarNetwork,
                          o_idx: np.ndarray, s_idx: np.ndarray,
                          l_idx: np.ndarray, ms: np.ndarray, ml: np.ndarray,
                          B: int) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """Constraint tensors of the per-cut LP for all K candidates.

    Variables ``x = [b_o, b_s[0..M-1], b_l, t1, t2, t3, t4] >= 0``
    (``M + 6`` of them); ``3M + 9`` inequality rows laid out exactly like
    :func:`_build_lp_stack` at M = 1 (same rows, same order, same
    coefficients), so the stacked simplex walks the same pivot path.
    """
    p = profile.prefix()
    F, Bk = p["F"], p["Bk"]
    D = profile.num_devices       # data holders (locality), not streams
    M = profile.num_streams       # stream count: the LP's variable layout
    K = o_idx.shape[0]
    nv = M + 6
    t1, t2, t3, t4 = M + 2, M + 3, M + 4, M + 5
    Q = profile.sample_bytes
    bwm = net.bw_matrix()
    up = net.upload_bw()
    msmax = ms.max(axis=1)
    o2 = o_idx[:, None]

    bw_os = bwm[o2, s_idx]                                  # [K, M]
    bw_ol = bwm[o_idx, l_idx]
    in_o = np.where(o_idx < D, 0.0, Q / up[o_idx])
    in_s = np.where(s_idx < D, 0.0, Q / up[s_idx])
    in_l = np.where(l_idx < D, 0.0, Q / up[l_idx])
    mo_s = np.where(ms > 0, profile.MO[np.maximum(ms, 1) - 1] / bw_os, 0.0)
    mo_l = np.where(ml > 0, profile.MO[np.maximum(ml, 1) - 1] / bw_ol, 0.0)
    mg_s = np.where(ms > 0, profile.MG[np.maximum(ms, 1) - 1] / bw_os, 0.0)
    mg_l = np.where(ml > 0, profile.MG[np.maximum(ml, 1) - 1] / bw_ol, 0.0)

    A_ub = np.zeros((K, 3 * M + 9, nv))
    b_ub = np.zeros((K, 3 * M + 9))
    # t1 >= each phase-1 forward arm; t2 >= each phase-1 backward arm
    # (backward arms use the MG-based gradient wire terms).
    A_ub[:, 0, 0] = in_o + F[o_idx, msmax]
    for i in range(M):
        A_ub[:, 1 + i, 1 + i] = in_s[:, i] + F[s_idx[:, i], ms[:, i]] + \
            mo_s[:, i]
    A_ub[:, M + 1, M + 1] = in_l + F[l_idx, msmax]
    A_ub[:, M + 2, 0] = Bk[o_idx, msmax]
    for i in range(M):
        A_ub[:, M + 3 + i, 1 + i] = Bk[s_idx[:, i], ms[:, i]] + mg_s[:, i]
    A_ub[:, 2 * M + 3, M + 1] = Bk[l_idx, msmax]
    A_ub[:, :M + 2, t1] = -1.0
    A_ub[:, M + 2:2 * M + 4, t2] = -1.0
    # t3/t4 >= the phase-2 arms: worker_o pays the common msmax..m_l block
    # for every stream plus the per-stream catch-up m_s[i]..msmax.
    dF_o = F[o_idx, ml] - F[o_idx, msmax]
    dBk_o = Bk[o_idx, ml] - Bk[o_idx, msmax]
    A_ub[:, 2 * M + 4, 0] = dF_o
    A_ub[:, 2 * M + 6, 0] = dBk_o
    for i in range(M):
        A_ub[:, 2 * M + 4, 1 + i] = dF_o + (F[o_idx, msmax] -
                                            F[o_idx, ms[:, i]])
        A_ub[:, 2 * M + 6, 1 + i] = dBk_o + (Bk[o_idx, msmax] -
                                             Bk[o_idx, ms[:, i]])
    A_ub[:, 2 * M + 5, M + 1] = (F[l_idx, ml] - F[l_idx, msmax]) + mo_l
    A_ub[:, 2 * M + 7, M + 1] = (Bk[l_idx, ml] - Bk[l_idx, msmax]) + mg_l
    A_ub[:, 2 * M + 4:2 * M + 6, t3] = -1.0
    A_ub[:, 2 * M + 6:2 * M + 8, t4] = -1.0
    # Constraints (14)/(15): b_s[i] <= m_s[i]*B, b_l <= m_l*B.
    for i in range(M):
        A_ub[:, 2 * M + 8 + i, 1 + i] = 1.0
        b_ub[:, 2 * M + 8 + i] = ms[:, i].astype(np.float64) * B
    A_ub[:, 3 * M + 8, M + 1] = 1.0
    b_ub[:, 3 * M + 8] = ml.astype(np.float64) * B
    # Constraint (17): b_o + sum b_s + b_l = B.
    A_eq = np.zeros((K, 1, nv))
    A_eq[:, 0, :M + 2] = 1.0
    b_eq = np.full((K, 1), float(B))
    return A_ub, b_ub, A_eq, b_eq


def _solve_multi_lps(cost: np.ndarray, A_ub: np.ndarray, b_ub: np.ndarray,
                     A_eq: np.ndarray, b_eq: np.ndarray,
                     backend: str) -> Tuple[np.ndarray, np.ndarray]:
    """Solve a stack of LPs: one stacked simplex call (batched) or a scalar
    loop over the very same tensors (reference oracle)."""
    if backend == "batched":
        res = batched_lp.linprog_batch(cost, A_ub, b_ub, A_eq, b_eq)
        return res.x, res.success
    K, _, nv = A_ub.shape
    x = np.zeros((K, nv))
    ok = np.zeros(K, bool)
    for k in range(K):
        r = lp_mod.linprog(cost, A_ub[k], b_ub[k], A_eq[k], b_eq[k])
        if r.success:
            x[k], ok[k] = r.x, True
    return x, ok


def _multi_schedule_from_lane(profile: MultiProfile, o_idx, s_idx, l_idx,
                              ms, ml, b_int, k: int) -> MultiSchedule:
    names = profile.worker_names
    M = profile.num_streams
    return MultiSchedule(
        worker_o=names[int(o_idx[k])], worker_l=names[int(l_idx[k])],
        s_workers=tuple(names[int(j)] for j in s_idx[k]),
        m_s=tuple(int(v) for v in ms[k]), m_l=int(ml[k]),
        b_o=int(b_int[k, 0]),
        b_s=tuple(int(v) for v in b_int[k, 1:1 + M]),
        b_l=int(b_int[k, 1 + M]))


def _solve_multi(profile: MultiProfile, net: StarNetwork, B: int,
                 keep_log: bool = False, backend: str = "batched",
                 prune: bool = True,
                 refine_passes: int = 4,
                 objective: str = "latency",
                 warm_start: Optional[MultiSchedule] = None
                 ) -> MultiSchedulerResult:
    """Generalized Algorithm 1 over M devices + edge + cloud — the
    canonical engine behind ``repro_torch.api.plan`` for star fleets.

    Stage A: exhaustive (mapping, shared-cut) sweep — with ``M == 1`` this
    is exactly :func:`_solve_3w` (same candidates, same order, same LPs) and the
    result is bit-identical.  Stage B (``M >= 2``): coordinate descent on
    the per-device cuts ``m_s[i]``, one stacked LP per pass, accepting only
    strict improvements, until a pass yields none or ``refine_passes`` is
    exhausted.  ``backend="reference"`` solves every lane with the scalar
    simplex instead of the stacked one (the correctness oracle).
    ``objective="throughput"`` scores both stages with the steady-state
    period ``t_period_multi`` instead of ``T_total`` (DESIGN.md §7).
    ``warm_start`` feeds a live schedule's exact cost into the dominance
    prune as an extra incumbent — the incremental re-solve of
    DESIGN.md §10, bit-identical to a cold solve (certified per call by
    :func:`_warm_ok`, with a cold re-solve when the certificate fails).
    """
    if backend not in ("batched", "reference"):
        raise ValueError(f"unknown scheduler backend: {backend!r}")
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown scheduler objective: {objective!r}")
    st = _stage_a_multi(profile, net, B, prune, objective, warm_start)
    x, ok = _solve_multi_lps(*st.stack, backend)
    search = _finish_multi(st, x, ok, keep_log, refine_passes)
    if search is None:
        # The warm incumbent over-pruned (the live schedule beat every
        # surviving lane) — bit-identity over speed: re-solve cold.
        return _solve_multi(profile, net, B, keep_log, backend, prune,
                            refine_passes, objective, warm_start=None)
    while True:
        stack = search.next_stack()
        if stack is None:
            break
        x, ok = _solve_multi_lps(*stack, backend)
        search.step(x, ok)
    return search.result()


def _score_multi(profile: MultiProfile, net: StarNetwork, objective: str,
                 o, s, l, mss, mll, bb) -> np.ndarray:
    """Objective scores of K rounded multi-device candidates (exact eval)."""
    if objective == "latency":
        return _t_total_multi_batch(profile, net, o, s, l, mss, mll, bb)
    return pipeline_mod.t_period_multi_batch(profile, net, o, s, l,
                                             mss, mll, bb)


@dataclasses.dataclass
class _StageAMulti:
    """One star/tree fleet's pruned stage-A lanes + LP stack (multi analog
    of :class:`_StageA3W`, consumed by :func:`_finish_multi`)."""
    profile: MultiProfile
    net: StarNetwork
    B: int
    objective: str
    warm: bool
    cost: np.ndarray
    ko: np.ndarray
    ks: np.ndarray
    kl: np.ndarray
    kms: np.ndarray
    kml: np.ndarray
    K: int
    n_pruned: int
    n_lp: int
    incumbent: float
    stack: Tuple[np.ndarray, ...]   # (cost, A_ub, b_ub, A_eq, b_eq)


def _stage_a_multi(profile: MultiProfile, net: StarNetwork, B: int,
                   prune: bool, objective: str,
                   warm_start: Optional[MultiSchedule]) -> _StageAMulti:
    N = profile.num_layers
    M = profile.num_streams       # per-candidate stream count (slots for
    #                               every non-o/non-l worker: devices on a
    #                               star, devices + idle edges on a tree)
    p = profile.prefix()
    F, Bk, U = p["F"], p["Bk"], p["U"]
    cost = np.concatenate([np.zeros(M + 2), np.ones(4)])
    o_idx, s_idx, l_idx, ms, ml = _multi_candidate_grid(
        N, profile.worker_names)
    K = o_idx.shape[0]
    msmax = ms.max(axis=1)

    keep = np.ones(K, bool)
    n_pruned = 0
    incumbent = np.inf
    if prune:
        # Same dominance rule as the 3-worker engine: the T^3 + T_update
        # cut-constants lower-bound T_total for any split — and worker_o's
        # CPU busy time, hence the period, so the prune is valid under
        # either objective (scored against the matching incumbent).
        Bf = float(B)
        const_lb = Bf * (F[o_idx, N] - F[o_idx, ml]) + \
            Bf * (Bk[o_idx, N] - Bk[o_idx, ml]) + U[o_idx, N]
        trivial = (msmax == 0) & (ml == 0)
        b_triv = np.zeros((int(trivial.sum()), M + 2), np.int64)
        b_triv[:, 0] = B
        incumbent = _score_multi(profile, net, objective,
                                 o_idx[trivial], s_idx[trivial],
                                 l_idx[trivial], ms[trivial], ml[trivial],
                                 b_triv).min()
        if warm_start is not None:
            # Warm incumbent: the live schedule's exact cost on this
            # fleet (the incremental re-solve of DESIGN.md §10).
            if warm_start.batch != B:
                raise ValueError(
                    f"warm_start batch {warm_start.batch} != B {B}")
            ws_score = _t_total_multi(profile, net, warm_start).total \
                if objective == "latency" else \
                pipeline_mod.t_period_multi(profile, net, warm_start)
            incumbent = min(incumbent, ws_score)
        keep = ~(const_lb > incumbent)
        n_pruned = int(K - keep.sum())

    ko, kl = o_idx[keep], l_idx[keep]
    ks, kms, kml = s_idx[keep], ms[keep], ml[keep]
    A_ub, b_ub, A_eq, b_eq = _build_multi_lp_stack(profile, net, ko, ks, kl,
                                                   kms, kml, B)
    return _StageAMulti(profile=profile, net=net, B=B, objective=objective,
                        warm=prune and warm_start is not None, cost=cost,
                        ko=ko, ks=ks, kl=kl, kms=kms, kml=kml, K=K,
                        n_pruned=n_pruned, n_lp=int(keep.sum()),
                        incumbent=incumbent,
                        stack=(cost, A_ub, b_ub, A_eq, b_eq))


class _MultiRefine:
    """Stage-B coordinate descent as an explicit (build, solve, step) state
    machine, so the per-fleet loop in :func:`_solve_multi` and the
    cross-fleet lockstep loop in :func:`solve_many` share one code path —
    the per-pass operations are identical, hence results stay bit-identical.
    """

    def __init__(self, st: _StageAMulti, win: int,
                 best_sched: MultiSchedule, best_score: float,
                 log: List[Tuple[MultiSchedule, float]], keep_log: bool,
                 refine_passes: int):
        self.st = st
        self.best_sched = best_sched
        self.best_score = best_score   # objective value (latency or period)
        self.log = log
        self.keep_log = keep_log
        self.rounds = 0
        self.n_lp_refine = 0
        M = st.profile.num_streams
        # Stage B is a no-op at M == 1, where stage A is already exhaustive.
        self._active = M >= 2 and refine_passes > 0
        self._passes_left = refine_passes
        if self._active:
            self._cur_ms = np.array(best_sched.m_s, np.int64)
            self._ml0 = int(best_sched.m_l)
            self._ro = np.full(1, st.ko[win])
            self._rs = st.ks[win][None, :]
            self._rl = np.full(1, st.kl[win])

    def next_stack(self) -> Optional[Tuple[np.ndarray, ...]]:
        """Build the next pass's single-cut-move LP stack, or ``None`` when
        refinement has converged / exhausted its pass budget."""
        if not self._active or self._passes_left <= 0:
            return None
        M = self.st.profile.num_streams
        cand = []
        for i in range(M):
            for c in range(self._ml0 + 1):
                if c != self._cur_ms[i]:
                    row = self._cur_ms.copy()
                    row[i] = c
                    cand.append(row)
        if not cand:
            self._active = False
            return None
        cms = np.stack(cand)
        Kr = cms.shape[0]
        self._cms = cms
        self._ro_r, self._rl_r = np.repeat(self._ro, Kr), \
            np.repeat(self._rl, Kr)
        self._rs_r = np.repeat(self._rs, Kr, axis=0)
        self._ml_r = np.full(Kr, self._ml0)
        A_ub, b_ub, A_eq, b_eq = _build_multi_lp_stack(
            self.st.profile, self.st.net, self._ro_r, self._rs_r,
            self._rl_r, cms, self._ml_r, self.st.B)
        return (self.st.cost, A_ub, b_ub, A_eq, b_eq)

    def step(self, x: np.ndarray, ok: np.ndarray) -> None:
        """Score the solved pass; accept a strict improvement or converge."""
        st = self.st
        cms, ml0 = self._cms, self._ml0
        Kr = cms.shape[0]
        M = st.profile.num_streams
        self.n_lp_refine += Kr
        self._passes_left -= 1
        allowed = np.concatenate(
            [np.ones((Kr, 1), bool), cms > 0,
             np.full((Kr, 1), ml0 > 0)], axis=1)
        b_int = _round_batch_split_batch(x[:, :M + 2], st.B, allowed)
        tot = _score_multi(st.profile, st.net, st.objective, self._ro_r,
                           self._rs_r, self._rl_r, cms, self._ml_r, b_int)
        tot = np.where(ok, tot, np.inf)
        k = int(np.argmin(tot))
        self.rounds += 1
        if not (tot[k] < self.best_score):     # strict improvement only
            self._active = False
            return
        self.best_score = float(tot[k])
        self.best_sched = _multi_schedule_from_lane(
            st.profile, self._ro_r, self._rs_r, self._rl_r, cms, self._ml_r,
            b_int, k)
        self._cur_ms = np.array(self.best_sched.m_s, np.int64)
        if self.keep_log:
            self.log.append((self.best_sched, self.best_score))

    def result(self) -> MultiSchedulerResult:
        st = self.st
        bd = _t_total_multi(st.profile, st.net, self.best_sched)
        return MultiSchedulerResult(
            schedule=self.best_sched, breakdown=bd, t_total=bd.total,
            n_lp_solved=st.n_lp, search_log=self.log, n_candidates=st.K,
            n_pruned=st.n_pruned, refine_rounds=self.rounds,
            n_lp_refine=self.n_lp_refine, objective=st.objective,
            t_period=pipeline_mod.t_period_multi(st.profile, st.net,
                                                 self.best_sched))


def _finish_multi(st: _StageAMulti, x: np.ndarray, ok: np.ndarray,
                  keep_log: bool, refine_passes: int
                  ) -> Optional[_MultiRefine]:
    """Round/score/argmin one fleet's stage-A lanes; hand off to stage B.

    Returns ``None`` when a warm incumbent over-pruned (caller re-solves
    cold), else a :class:`_MultiRefine` primed with the stage-A winner.
    """
    profile, net, B = st.profile, st.net, st.B
    ko, ks, kl, kms, kml = st.ko, st.ks, st.kl, st.kms, st.kml
    M = profile.num_streams
    allowed = np.concatenate([np.ones((kms.shape[0], 1), bool), kms > 0,
                              (kml > 0)[:, None]], axis=1)
    b_int = _round_batch_split_batch(x[:, :M + 2], B, allowed)
    totals = _score_multi(profile, net, st.objective,
                          ko, ks, kl, kms, kml, b_int)
    totals = np.where(ok, totals, np.inf)
    if st.warm and not (ok.any() and
                        _warm_ok(float(totals.min()), st.incumbent)):
        return None
    assert ok.any(), "every per-cut LP failed — inconsistent profile?"
    win = int(np.argmin(totals))  # first min == reference's sequential <

    log: List[Tuple[MultiSchedule, float]] = []
    if keep_log:
        for k in np.nonzero(ok)[0]:
            log.append((_multi_schedule_from_lane(profile, ko, ks, kl, kms,
                                                  kml, b_int, k),
                        float(totals[k])))
    best_sched = _multi_schedule_from_lane(profile, ko, ks, kl, kms, kml,
                                           b_int, win)
    return _MultiRefine(st, win, best_sched, float(totals[win]), log,
                        keep_log, refine_passes)


# ---------------------------------------------------------------------------
# Cross-fleet batched solve (DESIGN.md §13).  Many fleets' stage-A stacks —
# heterogeneous in (n_layers, M, topology) — are zero-padded to one common
# tableau shape and solved as a single flattened (fleet, lane) simplex call;
# stage-B refinement then runs in lockstep across the still-active fleets.
# Lanes never mix arithmetically inside the stacked simplex and the padding
# is provably inert (see batched_lp.pad_lp_stack), so every fleet's answer
# is bit-identical to its own _solve_3w / _solve_multi call.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One fleet's scheduling problem, as consumed by :func:`solve_many`.

    ``profile`` dispatches the engine: a :class:`HierProfile` runs the
    3-worker search (``origin="device"``), a :class:`MultiProfile` /
    ``TreeProfile`` runs the multi-device search.
    """
    profile: Union[HierProfile, MultiProfile]
    net: Union[Network, StarNetwork]
    B: int
    objective: str = "latency"


@dataclasses.dataclass
class SolveManyStats:
    """Padding/batching telemetry accumulated by :func:`solve_many`."""
    n_fleets: int = 0
    lanes: int = 0            # stage-A lanes solved (post-prune), all fleets
    lp_calls: int = 0         # stacked-simplex invocations (stage A + B)
    refine_rounds: int = 0    # lockstep stage-B rounds
    cells_native: int = 0     # tableau cells before padding
    cells_padded: int = 0     # tableau cells actually solved

    @property
    def pad_waste(self) -> float:
        """Fraction of solved tableau cells that were padding."""
        if self.cells_padded == 0:
            return 0.0
        return 1.0 - self.cells_native / self.cells_padded


def _stage_a_any(r: SolveRequest, prune: bool
                 ) -> Union[_StageA3W, _StageAMulti]:
    if r.objective not in OBJECTIVES:
        raise ValueError(f"unknown scheduler objective: {r.objective!r}")
    if isinstance(r.profile, MultiProfile):
        return _stage_a_multi(r.profile, r.net, r.B, prune, r.objective,
                              None)
    return _stage_a_3w(r.profile, r.net, r.B, "device", WORKERS, prune,
                       r.objective, None)


def solve_many(requests: Sequence[SolveRequest], *,
               backend: str = "batched", prune: bool = True,
               refine_passes: int = 4, keep_log: bool = False,
               stats: Optional[SolveManyStats] = None
               ) -> List[Union[SchedulerResult, MultiSchedulerResult]]:
    """Solve many fleets' Algorithm-1 searches in shared tableau stacks.

    Results are returned in request order and are bit-identical to calling
    the per-fleet engine on each request (asserted by the tier-1 planner
    suite): stage A concatenates every fleet's candidate stack into one
    :func:`batched_lp.linprog_batch_many` call, then stage-B coordinate
    descent runs in lockstep — each round solves all still-active fleets'
    single-cut-move stacks as one padded call.  Per-fleet state never
    mixes: the stacked simplex pivots lanes independently and the padding
    is inert (:func:`batched_lp.pad_lp_stack`).

    ``backend="reference"`` loops per-fleet through the scalar engines
    (the correctness oracle).  ``stats``, when given, is accumulated in
    place with lane counts and padding-waste telemetry; callers that care
    about padding (the planner admission loop) bucket requests by
    ``(kind, n_layers, M)`` before calling, keeping ``pad_waste`` near 0.
    """
    reqs = list(requests)
    if backend not in ("batched", "reference"):
        raise ValueError(f"unknown scheduler backend: {backend!r}")
    if backend == "reference":
        out: List[Union[SchedulerResult, MultiSchedulerResult]] = []
        for r in reqs:
            if isinstance(r.profile, MultiProfile):
                out.append(_solve_multi(r.profile, r.net, r.B, keep_log,
                                        backend, prune, refine_passes,
                                        r.objective))
            else:
                out.append(_solve_3w(r.profile, r.net, r.B,
                                     keep_log=keep_log, backend=backend,
                                     prune=prune, objective=r.objective))
        return out

    sts = [_stage_a_any(r, prune) for r in reqs]
    stacks = [st.stack for st in sts]
    if stats is not None:
        stats.n_fleets += len(reqs)
        stats.lanes += sum(st.stack[1].shape[0] for st in sts)
        native, padded = batched_lp.pad_cells(stacks)
        stats.cells_native += native
        stats.cells_padded += padded
        stats.lp_calls += 1
    lps = batched_lp.linprog_batch_many(stacks)

    results: List[Optional[Union[SchedulerResult, MultiSchedulerResult]]] \
        = [None] * len(reqs)
    searches: List[Tuple[int, _MultiRefine]] = []
    for i, (st, lp) in enumerate(zip(sts, lps)):
        if isinstance(st, _StageAMulti):
            search = _finish_multi(st, lp.x, lp.success, keep_log,
                                   refine_passes)
            assert search is not None   # no warm starts in solve_many
            searches.append((i, search))
        else:
            res3 = _finish_3w(st, lp.x, lp.success, keep_log)
            assert res3 is not None     # no warm starts in solve_many
            results[i] = res3

    # Lockstep stage B: one padded call per round over every fleet that
    # still has single-cut moves to score.  Fleets converge (and drop out)
    # independently — exactly the per-fleet refinement loop, interleaved.
    active = searches
    while True:
        round_stacks = []
        holders = []
        for i, s in active:
            stack = s.next_stack()
            if stack is not None:
                round_stacks.append(stack)
                holders.append((i, s))
        if not round_stacks:
            break
        if stats is not None:
            native, padded = batched_lp.pad_cells(round_stacks)
            stats.cells_native += native
            stats.cells_padded += padded
            stats.lp_calls += 1
            stats.refine_rounds += 1
        for (i, s), lp in zip(holders,
                              batched_lp.linprog_batch_many(round_stacks)):
            s.step(lp.x, lp.success)
        active = holders

    for i, s in searches:
        results[i] = s.result()
    return results   # type: ignore[return-value]
