"""Dense two-phase simplex LP solver (no scipy in this environment).

Solves::

    minimize    c @ x
    subject to  A_ub @ x <= b_ub
                A_eq @ x == b_eq
                x >= 0

Sizes here are tiny (HierTrain's per-cut LP has ~7 variables and ~12
constraints), so a dense tableau simplex with Bland's anti-cycling rule is
plenty. Exposed as :func:`linprog` with a scipy-like result object.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# Shared pivot/feasibility tolerance.  The batched engine
# (:mod:`repro_torch.core.batched_lp`) imports this so both backends make
# identical accept/reject decisions at every pivot.
EPS = 1e-9
_EPS = EPS


@dataclasses.dataclass
class LPResult:
    x: Optional[np.ndarray]
    fun: float
    success: bool
    status: str  # "optimal" | "infeasible" | "unbounded" | "iteration_limit"


def _pivot(T: np.ndarray, basis: np.ndarray, row: int, col: int) -> None:
    T[row] /= T[row, col]
    for r in range(T.shape[0]):
        if r != row and abs(T[r, col]) > _EPS:
            T[r] -= T[r, col] * T[row]
    basis[row] = col


def _simplex(T: np.ndarray, basis: np.ndarray, n_vars: int,
             max_iter: int = 10_000) -> str:
    """Run primal simplex on tableau ``T`` (last row = objective, last col = rhs).

    Bland's rule: entering = lowest-index negative reduced cost; leaving =
    lowest-index argmin ratio. Guarantees termination.
    """
    m = T.shape[0] - 1
    for _ in range(max_iter):
        # Entering variable (Bland): first column with negative reduced cost.
        col = -1
        for j in range(n_vars):
            if T[-1, j] < -_EPS:
                col = j
                break
        if col < 0:
            return "optimal"
        # Leaving variable: min ratio test.
        best_ratio, row = np.inf, -1
        for i in range(m):
            if T[i, col] > _EPS:
                ratio = T[i, -1] / T[i, col]
                if ratio < best_ratio - _EPS or (
                        abs(ratio - best_ratio) <= _EPS and
                        (row < 0 or basis[i] < basis[row])):
                    best_ratio, row = ratio, i
        if row < 0:
            return "unbounded"
        _pivot(T, basis, row, col)
    return "iteration_limit"


def linprog(c: np.ndarray,
            A_ub: Optional[np.ndarray] = None,
            b_ub: Optional[np.ndarray] = None,
            A_eq: Optional[np.ndarray] = None,
            b_eq: Optional[np.ndarray] = None) -> LPResult:
    """Two-phase simplex. All variables are implicitly >= 0."""
    c = np.asarray(c, dtype=np.float64)
    n = c.shape[0]
    A_ub = np.zeros((0, n)) if A_ub is None else np.asarray(A_ub, np.float64)
    b_ub = np.zeros((0,)) if b_ub is None else np.asarray(b_ub, np.float64)
    A_eq = np.zeros((0, n)) if A_eq is None else np.asarray(A_eq, np.float64)
    b_eq = np.zeros((0,)) if b_eq is None else np.asarray(b_eq, np.float64)

    m_ub, m_eq = A_ub.shape[0], A_eq.shape[0]
    m = m_ub + m_eq

    # Standard form: [A_ub | I_slack] x = b_ub ; A_eq x = b_eq; rhs >= 0.
    A = np.zeros((m, n + m_ub))
    b = np.concatenate([b_ub, b_eq])
    A[:m_ub, :n] = A_ub
    A[:m_ub, n:n + m_ub] = np.eye(m_ub)
    A[m_ub:, :n] = A_eq
    # Flip rows with negative rhs so artificials can start feasible.
    neg = b < 0
    A[neg] *= -1.0
    b = np.abs(b)

    n_total = n + m_ub
    # Phase 1: add artificial variables for every row, minimize their sum.
    T = np.zeros((m + 1, n_total + m + 1))
    T[:m, :n_total] = A
    T[:m, n_total:n_total + m] = np.eye(m)
    T[:m, -1] = b
    T[-1, n_total:n_total + m] = 1.0
    basis = np.arange(n_total, n_total + m)
    # Price out artificials.
    for i in range(m):
        T[-1] -= T[i]
    status = _simplex(T, basis, n_total + m)
    if status != "optimal" or T[-1, -1] < -1e-7:
        return LPResult(None, np.inf, False,
                        "infeasible" if status == "optimal" else status)

    # Drive remaining artificials out of the basis if possible.
    for i in range(m):
        if basis[i] >= n_total:
            for j in range(n_total):
                if abs(T[i, j]) > _EPS:
                    _pivot(T, basis, i, j)
                    break

    # Phase 2: restore the real objective over the phase-1 optimal basis.
    T2 = np.zeros((m + 1, n_total + 1))
    T2[:m, :n_total] = T[:m, :n_total]
    T2[:m, -1] = T[:m, -1]
    T2[-1, :n] = c
    for i in range(m):
        if basis[i] < n_total and abs(T2[-1, basis[i]]) > _EPS:
            T2[-1] -= T2[-1, basis[i]] * T2[i]
    status = _simplex(T2, basis, n_total)
    if status != "optimal":
        return LPResult(None, -np.inf if status == "unbounded" else np.inf,
                        False, status)

    x = np.zeros(n_total)
    for i in range(m):
        if basis[i] < n_total:
            x[basis[i]] = T2[i, -1]
    return LPResult(x[:n], float(c @ x[:n]), True, "optimal")


def solve_many(c: np.ndarray,
               A_ub: np.ndarray, b_ub: np.ndarray,
               A_eq: np.ndarray, b_eq: np.ndarray) -> List[LPResult]:
    """Solve a stack of identically-shaped LPs one by one.

    Same call signature as :func:`repro_torch.core.batched_lp.linprog_batch`
    (``A_ub``: ``[K, m_ub, n]`` etc., ``c`` shared or ``[K, n]``); used as
    the reference oracle in equivalence tests and benchmarks.
    """
    A_ub = np.asarray(A_ub, np.float64)
    K = A_ub.shape[0]
    c = np.broadcast_to(np.asarray(c, np.float64), (K, A_ub.shape[2]))
    return [linprog(c[k], A_ub[k], b_ub[k], A_eq[k], b_eq[k])
            for k in range(K)]
