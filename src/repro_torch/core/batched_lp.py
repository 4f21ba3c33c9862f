"""Batched dense two-phase simplex: pivot a *stack* of LPs simultaneously.

Algorithm 1 solves ~``6 * (N+1)(N+2)/2`` structurally identical small LPs
(one per worker mapping x cut pair).  The scalar solver in
:mod:`repro_torch.core.lp` walks them one at a time with per-element Python
loops; here the whole stack shares every pivot step:

* one ``(K, m+1, cols+1)`` tableau tensor holds all K problems,
* the entering column is chosen per batch element with Bland's rule
  (first negative reduced cost) via a vectorized ``argmax`` over a mask,
* the leaving row comes from a masked ratio test (non-positive column
  entries are excluded with ``inf`` ratios; ties break on the smallest
  basis index, mirroring the scalar solver's anti-cycling tie-break),
* batch elements that reach optimality/unboundedness are *frozen*: their
  lanes are masked out of subsequent pivots so their tableaus stay intact
  while the rest of the stack keeps iterating.

The arithmetic of each pivot mirrors :func:`repro_torch.core.lp._pivot`
operation-for-operation (same normalization, same ``|factor| > eps`` skip
rule), so a batched lane follows the exact pivot path the scalar solver
takes on the same problem — the two backends agree to the last bit on
non-degenerate instances and to tolerance on degenerate ties.

Fleet axis (DESIGN.md §13): every pivot above is *per-lane* — no
arithmetic ever mixes two lanes — so stacks from **different problems**
(different fleets' candidate grids) can share one tableau tensor as long
as their shapes match.  :func:`pad_lp_stack` embeds a smaller stack into
a larger ``(n_vars, m_ub, m_eq)`` shape with provably inert zero
rows/columns, and :func:`linprog_batch_many` pads a list of
heterogeneous stacks to their common maximum shape, solves the flattened
``(fleet, lane)`` stack in ONE :func:`linprog_batch` call, and splits
the answers back — bit-identical, lane for lane, to solving each stack
on its own (the padding proof lives on :func:`pad_lp_stack`).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lp import EPS

# Per-lane status codes.
RUNNING = 0
OPTIMAL = 1
INFEASIBLE = 2
UNBOUNDED = 3
ITERATION_LIMIT = 4

STATUS_NAMES = {
    OPTIMAL: "optimal",
    INFEASIBLE: "infeasible",
    UNBOUNDED: "unbounded",
    ITERATION_LIMIT: "iteration_limit",
}


@dataclasses.dataclass
class BatchLPResult:
    """Vectorized analogue of :class:`repro_torch.core.lp.LPResult`.

    ``x`` rows of failed lanes are zero; check ``success`` before use.
    """
    x: np.ndarray        # [K, n]
    fun: np.ndarray      # [K]
    success: np.ndarray  # [K] bool
    status: np.ndarray   # [K] int (see STATUS_* / STATUS_NAMES)


def _pivot_masked(T: np.ndarray, basis: np.ndarray, row: np.ndarray,
                  col: np.ndarray, mask: np.ndarray) -> None:
    """Pivot lane ``k`` of ``T`` at ``(row[k], col[k])`` where ``mask[k]``.

    Mirrors the scalar ``_pivot``: normalize the pivot row, then subtract
    ``factor * pivot_row`` from every other row whose pivot-column entry
    exceeds ``EPS`` in magnitude (identical op order => identical floats).
    Lanes with ``mask == False`` are left untouched.
    """
    K = T.shape[0]
    ar = np.arange(K)
    piv_rows = np.where(mask[:, None], T[ar, row, :], 0.0)
    piv_vals = np.where(mask, T[ar, row][ar, col], 1.0)[:, None]
    norm = piv_rows / piv_vals                       # [K, cols]
    factor = T[ar, :, col]                           # [K, rows]
    factor[ar, row] = 0.0                            # pivot row: replaced below
    factor = np.where(np.abs(factor) > EPS, factor, 0.0)
    factor = np.where(mask[:, None], factor, 0.0)
    T -= factor[:, :, None] * norm[:, None, :]
    T[ar, row, :] = np.where(mask[:, None], norm, T[ar, row, :])
    basis[ar, row] = np.where(mask, col, basis[ar, row])


def _simplex_batch(T: np.ndarray, basis: np.ndarray, n_vars: int,
                   active: np.ndarray, status: np.ndarray,
                   max_iter: int = 10_000) -> None:
    """Primal simplex over the stack; updates ``status`` / ``active`` in
    place.  On return every initially-active lane is marked OPTIMAL,
    UNBOUNDED or ITERATION_LIMIT.

    The loop runs on a *compacted* working copy: whenever fewer than
    half the working lanes are still running, finished lanes are written
    back to ``T``/``basis`` and dropped, so late pivots (only a few
    slow-converging lanes) stop paying for the whole stack.  Compaction
    is pure gather/scatter — no lane's tableau or pivot order changes —
    so results are bit-identical to the uncompacted loop.
    """
    idx = np.flatnonzero(active)           # original indices of working lanes
    if idx.size == 0:
        return
    Tw, bw = T[idx], basis[idx]            # fancy indexing => private copies
    act = np.ones(idx.size, bool)
    m = T.shape[1] - 1

    def finish(lanes: np.ndarray, code: int) -> None:
        status[idx[lanes]] = code
        active[idx[lanes]] = False

    def flush() -> None:
        """Write finished lanes back and shrink the working stack."""
        nonlocal idx, Tw, bw, act
        done = ~act
        T[idx[done]] = Tw[done]
        basis[idx[done]] = bw[done]
        idx, Tw, bw, act = idx[act], Tw[act], bw[act], act[act]

    for _ in range(max_iter):
        K = idx.size
        ar = np.arange(K)
        # Entering column (Bland): first negative reduced cost per lane.
        neg = Tw[:, -1, :n_vars] < -EPS              # [K, n_vars]
        has_neg = neg.any(axis=1)
        finish(act & ~has_neg, OPTIMAL)
        act &= has_neg
        if not act.any():
            flush()
            return
        col = np.argmax(neg, axis=1)                 # first True; garbage if
        col = np.where(act, col, 0)                  # inactive (masked later)
        # Ratio test over body rows.
        body = Tw[ar, :, col][:, :m]                 # [K, m]
        pos = body > EPS
        unbounded = act & ~pos.any(axis=1)
        finish(unbounded, UNBOUNDED)
        act &= ~unbounded
        if not act.any():
            flush()
            return
        rhs = Tw[:, :m, -1]
        ratio = np.where(pos, rhs / np.where(pos, body, 1.0), np.inf)
        # Leaving row: replay the scalar solver's *incremental* scan
        # (lp._simplex) exactly — a fresh "ratio < best - EPS" beats the
        # incumbent, an EPS-tie goes to the smaller basis index and then
        # RESETS the band at the new ratio (ties chain transitively).  A
        # one-shot "ratio <= min + EPS" band is not equivalent on
        # near-degenerate chains, and pivot-path identity with the
        # reference backend is what the equivalence suite asserts.
        best_ratio = np.full(K, np.inf)
        best_basis = np.zeros(K, np.int64)
        row = np.full(K, -1)
        with np.errstate(invalid="ignore"):
            for i in range(m):
                ri, bi = ratio[:, i], bw[:, i]
                take = (ri < best_ratio - EPS) | (
                    (np.abs(ri - best_ratio) <= EPS) &
                    ((row < 0) | (bi < best_basis)))
                best_ratio = np.where(take, ri, best_ratio)
                best_basis = np.where(take, bi, best_basis)
                row = np.where(take, i, row)
        row = np.maximum(row, 0)  # inactive lanes: any valid index
        _pivot_masked(Tw, bw, row, col, act)
        if act.sum() * 2 <= K and K >= 16:
            flush()
    finish(act, ITERATION_LIMIT)
    act &= False
    flush()


def pad_lp_stack(c: np.ndarray,
                 A_ub: np.ndarray, b_ub: np.ndarray,
                 A_eq: np.ndarray, b_eq: np.ndarray,
                 n_pad: int, m_ub_pad: int, m_eq_pad: int):
    """Embed a ``(n, m_ub, m_eq)``-shaped LP stack into the larger
    ``(n_pad, m_ub_pad, m_eq_pad)`` shape with *inert* padding.

    Pad variables get all-zero columns (zero objective, zero rows); pad
    rows are all-zero with zero rhs.  The padded stack pivots
    **bit-identically** to the native one inside :func:`linprog_batch`:

    * a pad *column* is zero in every row and in the objective; pivoting
      adds ``factor * pivot_row`` to rows, and the pivot row's pad entry
      is zero, so pad columns stay exactly ``0.0`` forever — their
      reduced cost is never ``< -EPS`` and Bland's rule never enters
      them;
    * a pad *row* starts as ``[0 … 0 | artificial 1 | rhs 0]``; its
      entry in any entering column is zero, so the ratio test excludes
      it (never a leaving row) and ``factor = 0`` leaves it untouched;
      its phase-1 price-out subtracts exact zeros from every real
      column, and its artificial's reduced cost prices out to exactly
      ``0.0`` (never entering);
    * the native→padded index map (variables ``i → i``, slacks
      ``n + j → n_pad + j``, artificials shifted by the pad row counts)
      is strictly increasing, so Bland's first-negative scan and the
      smallest-basis-index tie-break make the same choices in the same
      order.

    Hence every pivot touches the same entries with the same floats as
    the native solve — ``tests/test_planner.py`` asserts the bitwise
    equality on random stacks.
    """
    A_ub = np.asarray(A_ub, np.float64)
    A_eq = np.asarray(A_eq, np.float64)
    K, m_ub, n = A_ub.shape
    m_eq = A_eq.shape[1]
    assert n_pad >= n and m_ub_pad >= m_ub and m_eq_pad >= m_eq
    c2 = np.zeros((K, n_pad))
    c2[:, :n] = np.broadcast_to(np.asarray(c, np.float64), (K, n))
    A_ub2 = np.zeros((K, m_ub_pad, n_pad))
    A_ub2[:, :m_ub, :n] = A_ub
    b_ub2 = np.zeros((K, m_ub_pad))
    b_ub2[:, :m_ub] = b_ub
    A_eq2 = np.zeros((K, m_eq_pad, n_pad))
    A_eq2[:, :m_eq, :n] = A_eq
    b_eq2 = np.zeros((K, m_eq_pad))
    b_eq2[:, :m_eq] = b_eq
    return c2, A_ub2, b_ub2, A_eq2, b_eq2


def linprog_batch_many(stacks) -> list:
    """Solve several heterogeneous-shape LP stacks as ONE flattened
    ``(fleet, lane)`` simplex stack (the cross-fleet fleet axis).

    Parameters
    ----------
    stacks : sequence of ``(c, A_ub, b_ub, A_eq, b_eq)`` tuples, each a
        valid :func:`linprog_batch` input of its own shape.

    Returns a list of :class:`BatchLPResult`, one per input stack, with
    ``x`` truncated back to each stack's native variable count.  Every
    lane is bit-identical to what a per-stack :func:`linprog_batch`
    call returns (padding is inert — see :func:`pad_lp_stack` — and no
    pivot arithmetic mixes lanes).
    """
    if not stacks:
        return []
    shapes = []
    for c, A_ub, b_ub, A_eq, b_eq in stacks:
        K, m_ub, n = np.asarray(A_ub).shape
        shapes.append((K, n, m_ub, np.asarray(A_eq).shape[1]))
    n_pad = max(s[1] for s in shapes)
    m_ub_pad = max(s[2] for s in shapes)
    m_eq_pad = max(s[3] for s in shapes)
    padded = [pad_lp_stack(c, A_ub, b_ub, A_eq, b_eq,
                           n_pad, m_ub_pad, m_eq_pad)
              for (c, A_ub, b_ub, A_eq, b_eq) in stacks]
    res = linprog_batch(
        np.concatenate([p[0] for p in padded], axis=0),
        np.concatenate([p[1] for p in padded], axis=0),
        np.concatenate([p[2] for p in padded], axis=0),
        np.concatenate([p[3] for p in padded], axis=0),
        np.concatenate([p[4] for p in padded], axis=0))
    out = []
    k0 = 0
    for K, n, _, _ in shapes:
        sl = slice(k0, k0 + K)
        out.append(BatchLPResult(x=res.x[sl, :n], fun=res.fun[sl],
                                 success=res.success[sl],
                                 status=res.status[sl]))
        k0 += K
    return out


def pad_cells(stacks) -> tuple:
    """``(native_cells, padded_cells)`` tableau-cell counts for a
    :func:`linprog_batch_many` call — the padding-waste telemetry the
    planner logs (waste = ``1 - native/padded``)."""
    shapes = [(np.asarray(A_ub).shape, np.asarray(A_eq).shape[1])
              for (_, A_ub, _, A_eq, _) in stacks]
    if not shapes:
        return 0, 0
    n_pad = max(s[0][2] for s in shapes)
    m_pad = max(s[0][1] for s in shapes) + max(s[1] for s in shapes)
    native = sum(K * (mu + me) * n for ((K, mu, n), me) in shapes)
    padded = sum(K * m_pad * n_pad for ((K, _, _), _) in shapes)
    return native, padded


def linprog_batch(c: np.ndarray,
                  A_ub: np.ndarray, b_ub: np.ndarray,
                  A_eq: np.ndarray, b_eq: np.ndarray) -> BatchLPResult:
    """Two-phase simplex over a stack of K LPs of identical shape.

    Parameters
    ----------
    c : ``[n]`` or ``[K, n]`` objective (minimized; ``x >= 0`` implicit).
    A_ub, b_ub : ``[K, m_ub, n]`` / ``[K, m_ub]`` inequality stack.
    A_eq, b_eq : ``[K, m_eq, n]`` / ``[K, m_eq]`` equality stack.
    """
    A_ub = np.asarray(A_ub, np.float64)
    b_ub = np.asarray(b_ub, np.float64)
    A_eq = np.asarray(A_eq, np.float64)
    b_eq = np.asarray(b_eq, np.float64)
    K, m_ub, n = A_ub.shape
    m_eq = A_eq.shape[1]
    m = m_ub + m_eq
    c = np.broadcast_to(np.asarray(c, np.float64), (K, n))

    # Standard form with slacks; flip negative-rhs rows (scalar parity).
    n_total = n + m_ub
    A = np.zeros((K, m, n_total))
    A[:, :m_ub, :n] = A_ub
    A[:, :m_ub, n:] = np.eye(m_ub)
    A[:, m_ub:, :n] = A_eq
    b = np.concatenate([b_ub, b_eq], axis=1)
    negrow = b < 0.0
    A = np.where(negrow[:, :, None], -A, A)
    b = np.abs(b)

    # Phase 1: artificials on every row, minimize their sum.
    T = np.zeros((K, m + 1, n_total + m + 1))
    T[:, :m, :n_total] = A
    T[:, :m, n_total:n_total + m] = np.eye(m)
    T[:, :m, -1] = b
    T[:, -1, n_total:n_total + m] = 1.0
    basis = np.tile(np.arange(n_total, n_total + m), (K, 1))
    for i in range(m):  # price out artificials (sequential: scalar parity)
        T[:, -1, :] -= T[:, i, :]

    status = np.full(K, RUNNING, np.int64)
    active = np.ones(K, bool)
    _simplex_batch(T, basis, n_total + m, active, status)
    feasible = (status == OPTIMAL) & (T[:, -1, -1] >= -1e-7)
    status[(status == OPTIMAL) & ~feasible] = INFEASIBLE

    # Drive leftover artificials out of the basis where possible.
    ar = np.arange(K)
    for i in range(m):
        need = feasible & (basis[:, i] >= n_total)
        if not need.any():
            continue
        entry = np.abs(T[:, i, :n_total]) > EPS      # [K, n_total]
        col = np.argmax(entry, axis=1)               # first usable column
        do = need & entry.any(axis=1)
        _pivot_masked(T, basis, np.full(K, i), col, do)

    # Phase 2: real objective over the phase-1 basis (artificials dropped).
    T2 = np.zeros((K, m + 1, n_total + 1))
    T2[:, :m, :n_total] = T[:, :m, :n_total]
    T2[:, :m, -1] = T[:, :m, -1]
    T2[:, -1, :n] = c
    for i in range(m):
        bi = basis[:, i]
        coef = T2[ar, -1, np.minimum(bi, n_total - 1)]
        do = feasible & (bi < n_total) & (np.abs(coef) > EPS)
        T2[:, -1, :] -= np.where(do, coef, 0.0)[:, None] * T2[:, i, :]

    status2 = status.copy()
    status2[feasible] = RUNNING
    active = feasible.copy()
    _simplex_batch(T2, basis, n_total, active, status2)

    # Extract the solution (scatter via a dummy column so lanes whose row i
    # holds an artificial cannot clobber variable 0).
    success = status2 == OPTIMAL
    x_ext = np.zeros((K, n_total + 1))
    in_vars = basis < n_total
    target = np.where(in_vars, basis, n_total)
    vals = np.where(in_vars & success[:, None], T2[:, :m, -1], 0.0)
    np.put_along_axis(x_ext, target, vals, axis=1)
    x = x_ext[:, :n]
    fun = np.einsum("kn,kn->k", c, x)
    fun = np.where(success, fun,
                   np.where(status2 == UNBOUNDED, -np.inf, np.inf))
    return BatchLPResult(x=x, fun=fun, success=success, status=status2)
