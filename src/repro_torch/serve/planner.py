"""Planner-as-a-service: cross-fleet batched scheduling with a
fingerprinted plan cache (DESIGN.md §13).

The numpy port of :mod:`repro.serve.planner`: fingerprints, cache
behaviour and plans are ``==`` to the JAX package's; plans are
:class:`repro_torch.api.Plan` objects.

The paper's Algorithm 1 plans one fleet at a time; the planner turns
scheduling into a service that answers *populations* — "millions of
users each bringing their own device profile" — at high throughput:

* :func:`Planner.plan_many` resolves a batch of :class:`PlanRequest`\\ s
  through a **plan cache** keyed by quantized
  ``(profile, network, B, objective, wire)`` fingerprints; misses are
  grouped into shape buckets ``(kind, n_layers, M, E)`` and solved in
  shared tableau stacks by :func:`repro_torch.core.scheduler.solve_many`
  (bit-identical per fleet to the per-fleet engines).
* :meth:`Planner.submit` / :meth:`Planner.drain` form the admission
  loop: queued requests drain in size-bucketed batches of at most
  ``max_batch``, so padding waste inside each stacked simplex call stays
  near zero (and is logged via :class:`SolveManyStats`).

Fingerprint grid (documented contract, tested by ``tests/test_planner``):
every float entering the key — per-layer seconds, wire bytes,
bandwidths, ``sample_bytes`` — is quantized to **relative log buckets**
of width ``Q_REL = 1e-3``: ``bucket(x) = sign(x) * (1 +
rint(ln|x| / ln(1 + Q_REL)))`` with ``bucket(0) = 0``.  Two profiles
whose every entry agrees within ~0.05 % share a bucket (and may share a
plan); any entry perturbed past the grid separates the keys.  Because
``T_total`` and the period are positively-weighted max/sum compositions
of those entries, serving fleet A a plan cached from fleet B inside one
bucket mis-prices it by at most ``(1 + Q_REL)^2 - 1`` ≈ 2e-3 relative
before re-scoring — and the planner *re-scores* every cache hit on the
requester's own exact profile/network, so the returned
``t_total``/``t_period``/breakdown are always exact for the schedule
served (only the argmin, not the pricing, is shared).

Structural fields — topology kind, worker names, layer count, ``B``,
objective, wire mode, tree ``edge_of`` — enter the key exactly, so a
cache hit always carries a schedule that is *valid* for the requester
(same workers, same cut range); the quantization grid only ever blurs
profile magnitudes, never shapes.

Telemetry: ``hits`` / ``misses`` / ``evictions`` counters, ``hit_rate``,
and the solver-side :class:`SolveManyStats` (lanes, stacked calls,
padding waste) live on the planner object; the cache is a bounded LRU
like ``hybrid_step._JitStepCache``.

``python -m repro_torch.serve.planner --bench`` runs a synthetic-population
smoke benchmark (see :mod:`repro_torch.serve.population`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core.cost_model import (HierProfile, MultiProfile, Network,
                                         StarNetwork, TreeNetwork,
                                         TreeProfile, _t_total,
                                         _t_total_multi)
from repro_torch.core.fleet import Fleet
from repro_torch.core.scheduler import (MultiSchedulerResult,
                                        SolveManyStats, SolveRequest,
                                        solve_many)

__all__ = ["PLAN_CACHE_SIZE", "Q_REL", "PlanRequest", "Planner",
           "clear_plan_cache", "fingerprint", "plan_many", "quantize"]

_log = logging.getLogger(__name__)

#: Relative width of one fingerprint bucket.  1e-3 keeps false sharing
#: (two distinct fleets landing in one bucket) mis-priced by at most
#: ~2e-3 relative *before* the exact per-request re-score — see the
#: module docstring and the pinned bound in tests/test_planner.py.
Q_REL = 1e-3

#: Default plan-cache capacity (schedules are tiny; this is ~a few MB).
PLAN_CACHE_SIZE = 4096

_LN_STEP = float(np.log1p(Q_REL))


def quantize(x) -> np.ndarray:
    """Map values onto the relative log-bucket grid (int64 bucket ids).

    ``bucket(x) = sign(x) * (1 + rint(ln|x| / ln(1+Q_REL)))`` and
    ``bucket(0) = 0`` — the ``+1`` keeps tiny magnitudes from colliding
    with exact zero.  Pure float64 ops with round-half-even, so the same
    bytes hash to the same key in any process on IEEE-754 hardware.
    """
    a = np.atleast_1d(np.asarray(x, np.float64))
    mag = np.zeros(a.shape, np.int64)
    nz = a != 0.0
    mag[nz] = np.rint(np.log(np.abs(a[nz])) / _LN_STEP).astype(np.int64) + 1
    return np.where(a < 0.0, -mag, mag)


def _profile_kind(profile) -> str:
    if isinstance(profile, TreeProfile):
        return "tree"
    if isinstance(profile, MultiProfile):
        return "star"
    return "triple"


def fingerprint(profile: Union[HierProfile, MultiProfile],
                net: Union[Network, StarNetwork, TreeNetwork],
                B: int, objective: str = "latency",
                wire: str = "none", *, exact: bool = False) -> str:
    """Quantized cache key of one scheduling problem (sha256 hex).

    Structural fields enter exactly; float fields enter through
    :func:`quantize`.  The profile passed here is the *wire-adjusted*
    one (``api._prepare`` output), so ``wire`` is part of both the
    structure tag and the quantized ``MO``/``MG`` columns.

    ``exact=True`` hashes the raw float64 bytes instead of the bucket
    ids — the *exact* problem identity, used to memoize deterministic
    re-scoring (two requests share an exact digest only when every
    input bit matches, so the memo can never blur anything).
    """
    h = hashlib.sha256()

    def put(tag: str, payload: bytes) -> None:
        h.update(tag.encode())
        h.update(b"\x00")
        h.update(payload)
        h.update(b"\x01")

    def put_q(tag: str, arr) -> None:
        if exact:
            put(tag, np.ascontiguousarray(
                np.asarray(arr, np.float64)).tobytes())
        else:
            put(tag, quantize(arr).tobytes())

    kind = _profile_kind(profile)
    workers = profile.worker_names if isinstance(profile, MultiProfile) \
        else ("device", "edge", "cloud")
    put("kind", kind.encode())
    put("workers", "|".join(workers).encode())
    put("layers", "|".join(profile.layer_names).encode())
    put("B", int(B).to_bytes(8, "little", signed=True))
    put("objective", objective.encode())
    put("wire", wire.encode())
    put_q("L_f", profile.L_f)
    put_q("L_b", profile.L_b)
    put_q("L_u", profile.L_u)
    put_q("MP", profile.MP)
    put_q("MO", profile.MO)
    put_q("MG", profile.MG)
    put_q("Q", profile.sample_bytes)
    if isinstance(profile, TreeProfile):
        put("n_edges", int(profile.n_edges).to_bytes(4, "little"))
        put_q("cloud_speedup", profile.cloud_speedup)
    if isinstance(net, TreeNetwork):
        put("edge_of", np.asarray(net.edge_of, np.int64).tobytes())
        put_q("bw_de", net.bw_de)
        put_q("bw_ec", net.bw_ec)
    elif isinstance(net, StarNetwork):
        put_q("bw_de", net.bw_de)
        put_q("bw_ec", net.bw_ec)
    else:
        put_q("bw_de", net.bw_de)
        put_q("bw_ec", net.bw_ec)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One client's planning request, as accepted by :func:`plan_many`.

    Mirrors the :func:`repro_torch.api.plan` signature: ``fleet`` may be a
    pinned-profile fleet (``model=None``) or a spec fleet plus a model;
    ``tag`` is an opaque client label echoed nowhere but useful for
    correlating requests in logs/tests.
    """
    fleet: Fleet
    B: int
    objective: str = "latency"
    model: Any = None
    wire: Optional[str] = None
    pipeline_depth: int = 1
    tag: str = ""


@dataclasses.dataclass
class _Prepared:
    """A request after facade prep: solver inputs + cache key + bucket."""
    request: PlanRequest
    stack: Any
    profile: Union[HierProfile, MultiProfile]
    net: Union[Network, StarNetwork, TreeNetwork]
    wire: str
    fp: str
    xfp: str
    bucket: Tuple


class Planner:
    """Cross-fleet batch planner with a fingerprinted LRU plan cache.

    ``plan_many`` is the front door; ``submit``/``drain`` add a queued
    admission loop that caps each stacked solve at ``max_batch``
    requests per shape bucket.  Counters (``hits``, ``misses``,
    ``evictions``, ``hit_rate``) and solver telemetry
    (:attr:`solver_stats`) accumulate across calls; :meth:`clear`
    resets everything.
    """

    def __init__(self, cache_size: int = PLAN_CACHE_SIZE,
                 max_batch: int = 256) -> None:
        assert cache_size >= 1 and max_batch >= 1
        self.cache_size = cache_size
        self.max_batch = max_batch
        self._cache: "OrderedDict[str, Any]" = OrderedDict()
        # Memo of exact re-scoring: (exact problem digest, schedule) ->
        # rescored result.  Keys collide only for bit-identical pricing
        # problems, so this never blurs a price — it only deduplicates
        # the max-plus t_period recurrences across same-class clients.
        self._rescore_cache: "OrderedDict[Tuple[str, str], Any]" = \
            OrderedDict()
        self._queue: List[PlanRequest] = []
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.solver_stats = SolveManyStats()

    # ---- cache ----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __len__(self) -> int:
        return len(self._cache)

    def __contains__(self, fp: str) -> bool:
        return fp in self._cache

    def clear(self) -> None:
        """Drop the cache, the queue, and every counter."""
        self._cache.clear()
        self._rescore_cache.clear()
        self._queue.clear()
        self.hits = self.misses = self.evictions = 0
        self.solver_stats = SolveManyStats()

    def stats(self) -> Dict[str, Any]:
        s = self.solver_stats
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate,
                "cached": len(self._cache), "cache_size": self.cache_size,
                "solved_fleets": s.n_fleets, "lanes": s.lanes,
                "lp_calls": s.lp_calls, "refine_rounds": s.refine_rounds,
                "pad_waste": s.pad_waste}

    def _cache_get(self, fp: str):
        res = self._cache.get(fp)
        if res is not None:
            self._cache.move_to_end(fp)
        return res

    def _cache_put(self, fp: str, res) -> None:
        self._cache[fp] = res
        self._cache.move_to_end(fp)
        while len(self._cache) > self.cache_size:
            self._cache.popitem(last=False)
            self.evictions += 1

    # ---- planning -------------------------------------------------------

    def _prepare(self, r: PlanRequest) -> _Prepared:
        from repro_torch import api
        stack, profile, net, wire = api._prepare(r.model, r.fleet, r.wire)
        fp = fingerprint(profile, net, r.B, r.objective, wire)
        xfp = fingerprint(profile, net, r.B, r.objective, wire, exact=True)
        bucket = (_profile_kind(profile), profile.num_layers,
                  getattr(profile, "num_streams", 1),
                  getattr(net, "num_edges", 1))
        return _Prepared(request=r, stack=stack, profile=profile, net=net,
                         wire=wire, fp=fp, xfp=xfp, bucket=bucket)

    def _rescore(self, res, profile, net):
        """The cached schedule priced *exactly* on this request's own
        profile/network (cache hits share the argmin, never the price).
        ``search_log`` is dropped: it belongs to the solving request."""
        if isinstance(res, MultiSchedulerResult):
            bd = _t_total_multi(profile, net, res.schedule)
            tp = pipeline_mod.t_period_multi(profile, net, res.schedule)
        else:
            bd = _t_total(profile, net, res.schedule, "device")
            tp = pipeline_mod.t_period(profile, net, res.schedule, "device")
        return dataclasses.replace(res, breakdown=bd, t_total=bd.total,
                                   t_period=tp, search_log=[])

    def _rescore_cached(self, p: _Prepared, res):
        """:meth:`_rescore` memoized on ``(exact digest, schedule)``.

        The key is the *unquantized* problem identity plus the schedule
        being priced, so two requests share a memo entry only when every
        float of their profile/network matches bit for bit — identical
        inputs give identical prices, and the documented exact-re-scoring
        contract is preserved while same-class clients pay the max-plus
        ``t_period`` recurrence once instead of once each."""
        key = (p.xfp, res.schedule.describe())
        scored = self._rescore_cache.get(key)
        if scored is None:
            scored = self._rescore(res, p.profile, p.net)
            self._rescore_cache[key] = scored
            while len(self._rescore_cache) > self.cache_size:
                self._rescore_cache.popitem(last=False)
        else:
            self._rescore_cache.move_to_end(key)
        return scored

    def plan_many(self, requests: Sequence[PlanRequest]) -> List[Any]:
        """Plan a batch of requests; returns ``repro_torch.api.Plan``
        objects in request order.

        Resolution per request: cache hit → re-scored cached schedule;
        first miss of a fingerprint → solved; further requests with the
        same fingerprint in the same batch ride the in-flight solve and
        count as hits.  Misses are grouped by shape bucket and solved in
        chunks of at most ``max_batch`` through ``solve_many`` (one
        stacked simplex per chunk; equal shapes inside a bucket keep
        padding waste ~0).
        """
        from repro_torch import api
        prepared = [self._prepare(r) for r in requests]

        to_solve: "OrderedDict[str, _Prepared]" = OrderedDict()
        for p in prepared:
            if p.fp in self._cache:
                self.hits += 1
            elif p.fp in to_solve:
                self.hits += 1          # alias of an in-flight solve
            else:
                to_solve[p.fp] = p
                self.misses += 1

        buckets: "OrderedDict[Tuple, List[_Prepared]]" = OrderedDict()
        for p in to_solve.values():
            buckets.setdefault(p.bucket, []).append(p)
        for bucket, items in buckets.items():
            for lo in range(0, len(items), self.max_batch):
                chunk = items[lo:lo + self.max_batch]
                sreqs = [SolveRequest(p.profile, p.net, p.request.B,
                                      p.request.objective) for p in chunk]
                waste0 = (self.solver_stats.cells_native,
                          self.solver_stats.cells_padded)
                outs = solve_many(sreqs, stats=self.solver_stats)
                dn = self.solver_stats.cells_native - waste0[0]
                dp = self.solver_stats.cells_padded - waste0[1]
                _log.debug("planner bucket %s: %d fleets, pad waste %.4f",
                           bucket, len(chunk),
                           1.0 - dn / dp if dp else 0.0)
                for p, res in zip(chunk, outs):
                    self._cache_put(p.fp, res)

        plans = []
        for p in prepared:
            res = self._cache_get(p.fp)
            assert res is not None, "planner cache lost an in-flight plan"
            r = p.request
            plans.append(api.Plan(
                fleet=r.fleet, B=r.B, objective=r.objective,
                pipeline_depth=r.pipeline_depth, backend="batched",
                profile=p.profile, network=p.net,
                result=self._rescore_cached(p, res),
                wire=p.wire, model=p.stack))
        return plans

    # ---- admission loop -------------------------------------------------

    def submit(self, request: PlanRequest) -> None:
        """Queue one request for the next :meth:`drain`."""
        self._queue.append(request)

    def drain(self) -> List[Any]:
        """Plan every queued request (in submit order) and empty the
        queue.  Bucketing/chunking happens inside :meth:`plan_many`."""
        queue, self._queue = self._queue, []
        if not queue:
            return []
        return self.plan_many(queue)


# ---------------------------------------------------------------------------
# Module-level default planner (the `repro_torch.api.plan_many` backend).
# ---------------------------------------------------------------------------

_DEFAULT_PLANNER = Planner()


def plan_many(requests: Sequence[PlanRequest], *,
              planner: Optional[Planner] = None) -> List[Any]:
    """Plan many fleets through the shared default :class:`Planner`
    (or an explicit one)."""
    return (planner if planner is not None else _DEFAULT_PLANNER
            ).plan_many(requests)


def clear_plan_cache() -> None:
    """Reset the default planner's cache and counters."""
    _DEFAULT_PLANNER.clear()


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.serve.planner --bench
# ---------------------------------------------------------------------------

def _bench(n: int, seed: int, assert_hit_rate: Optional[float]) -> int:
    import time

    from repro_torch.serve.population import synthetic_population

    reqs = synthetic_population(n=n, seed=seed)
    pl = Planner()
    t0 = time.perf_counter()
    plans = pl.plan_many(reqs)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pl.plan_many(reqs)
    warm_s = time.perf_counter() - t0
    st = pl.stats()
    print(f"planner bench: n={len(plans)} fleets, seed={seed}")
    print(f"  cold: {cold_s:.3f}s ({len(plans) / cold_s:.1f} plans/s), "
          f"hit rate {st['hit_rate']:.3f} "
          f"({st['hits']} hits / {st['misses']} misses)")
    print(f"  warm replay: {warm_s:.3f}s "
          f"({len(plans) / warm_s:.1f} plans/s)")
    print(f"  solver: {st['solved_fleets']} fleets solved, "
          f"{st['lanes']} lanes, {st['lp_calls']} stacked calls, "
          f"pad waste {st['pad_waste']:.4f}")
    if assert_hit_rate is not None and st["hit_rate"] <= assert_hit_rate:
        print(f"FAIL: hit rate {st['hit_rate']:.3f} <= {assert_hit_rate}")
        return 1
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="cross-fleet planner benchmark / smoke test")
    ap.add_argument("--bench", action="store_true",
                    help="run the synthetic-population benchmark")
    ap.add_argument("--n", type=int, default=256,
                    help="population size (default 256)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--assert-hit-rate", type=float, nargs="?",
                    const=0.0, default=None, metavar="R",
                    help="exit 1 unless the cold hit rate exceeds R "
                         "(default 0 when given without a value)")
    args = ap.parse_args(argv)
    if not args.bench:
        ap.error("nothing to do: pass --bench")
    return _bench(args.n, args.seed, args.assert_hit_rate)


if __name__ == "__main__":
    raise SystemExit(main())
