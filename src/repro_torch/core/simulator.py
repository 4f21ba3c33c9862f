"""Discrete-event simulator of HierTrain iterations.

The numpy port of :mod:`repro.core.simulator` (deprecated shims
dropped); makespans are ``==`` to the JAX package's on the same inputs.

The analytic cost model (Eq. 12 and its M-device generalization) assumes
clean phase barriers.  This simulator executes the *procedure of §IV-B* —
segment-level compute jobs and link transfers with FIFO resource contention
— and measures the makespan.  :func:`_simulate_iteration` covers the
paper's 3-tier testbed; :func:`_simulate_iteration_multi` covers the
M-device star
(per-device compute resources, per-device radio links, shared backhaul);
:func:`simulate_pipeline` runs K consecutive iterations as a pipeline with
synchronous-SGD cross-iteration dependencies (DESIGN.md §7), validating
the closed-form steady-state period of :mod:`repro_torch.core.pipeline`.
Benchmarks ``fig6_model_validity``, ``fig_multidevice`` and
``fig_pipeline`` compare simulated against analytic makespans (the
paper's Fig. 6 shows "real and theoretical latencies highly match");
tests assert a tight bound.

Resources:
* one compute resource per physical worker (sequential execution),
* one resource per *directed* worker-pair pipe (full duplex).  Pairs
  without a physical link (device<->cloud, device<->device) get their own
  shaped pipe at the series bandwidth of the relayed route, matching the
  paper's Linux-TC emulation (see ``_route``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cost_model import (WIDX, HierProfile, MultiProfile,
                                         MultiSchedule, Network, Schedule,
                                         StarNetwork)


@dataclasses.dataclass
class _Task:
    name: str
    resources: Tuple[str, ...]   # sequence of resources (links in a route)
    durations: Tuple[float, ...]  # one duration per resource hop
    deps: Tuple[str, ...] = ()
    start: float = 0.0
    end: float = 0.0


class Des:
    """Tiny FIFO discrete-event executor over a task DAG."""

    def __init__(self) -> None:
        self.tasks: Dict[str, _Task] = {}
        self.res_free: Dict[str, float] = {}

    def add(self, name: str, resources: Sequence[str],
            durations: Sequence[float], deps: Sequence[str] = ()) -> None:
        assert name not in self.tasks, name
        for d in deps:
            assert d in self.tasks, f"unknown dep {d} of {name}"
        self.tasks[name] = _Task(name, tuple(resources), tuple(durations),
                                 tuple(deps))

    def run(self) -> float:
        # Dep-count + ready-heap dispatcher.  A task enters the heap the
        # moment its last dependency has been dispatched, keyed by
        # ``(max dep end, name)`` — the exact tuple the previous
        # rescan-every-dispatch implementation sorted the ready set by, so
        # the dispatch order (and therefore every FIFO resource queue) is
        # preserved while the per-dispatch cost drops from O(n) to O(log n).
        dependents: Dict[str, List[str]] = {n: [] for n in self.tasks}
        counts: Dict[str, int] = {}
        heap: List[Tuple[float, str]] = []
        for name, t in self.tasks.items():
            deps = set(t.deps)
            counts[name] = len(deps)
            for d in deps:
                dependents[d].append(name)
            if not deps:
                heap.append((0.0, name))
        heapq.heapify(heap)
        makespan = 0.0
        n_done = 0
        while heap:
            clock, name = heapq.heappop(heap)
            t = self.tasks[name]
            t.start = clock
            for res, dur in zip(t.resources, t.durations):
                free = self.res_free.get(res, 0.0)
                begin = max(clock, free)
                clock = begin + dur
                self.res_free[res] = clock
            t.end = clock
            n_done += 1
            if clock > makespan:
                makespan = clock
            for succ in dependents[name]:
                counts[succ] -= 1
                if counts[succ] == 0:
                    st = self.tasks[succ]
                    ready = max((self.tasks[d].end for d in st.deps),
                                default=0.0)
                    heapq.heappush(heap, (ready, succ))
        assert n_done == len(self.tasks), "dependency cycle in task graph"
        return makespan


def _route(net: Network, a: str, b: str) -> List[Tuple[str, float]]:
    """Directed link hops (resource name, bandwidth) from a to b.

    Each worker pair is an independent shaped pipe — matching the
    paper's Linux-TC emulation (§VI-B), where device->cloud traffic is
    throttled on its own class rather than contending with device->edge
    on a shared radio.  (With a physically-relayed route the DES diverges
    from Eq. 12 by up to ~38% on shipping-heavy schedules; see
    EXPERIMENTS.md §Fig.6 note.)"""
    if a == b:
        return []
    return [(f"link:{a}->{b}", net.bw(a, b))]


def _add_iteration(des: Des, profile: HierProfile, net: Network,
                   sched: Schedule, origin: str, tag: str = "",
                   prev: Optional[str] = None) -> None:
    """Add one iteration's task DAG to ``des``.

    ``tag`` prefixes every task name (the first iteration uses ``""`` so a
    depth-1 pipeline is *literally* the single-iteration DAG — same names,
    same dispatch order, bit-identical makespan).  ``prev`` is the previous
    iteration's tag (``None`` for the first): it adds the cross-iteration
    dependencies of §7 — each worker's forward task waits on its *own*
    previous-iteration weight update (synchronous SGD semantics), while
    links stay FIFO through the shared pipe resources.
    """
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    N = profile.num_layers
    wo, ws, wl = sched.worker_o, sched.worker_s, sched.worker_l
    o, s, l = WIDX[wo], WIDX[ws], WIDX[wl]
    ms, ml = sched.m_s, sched.m_l
    bo, bs, bl = sched.b_o, sched.b_s, sched.b_l
    Q = profile.sample_bytes

    def nm(base: str) -> str:
        return tag + base

    def lag(base: str) -> List[str]:
        return [prev + base] if prev is not None else []

    def xfer(name: str, a: str, b: str, nbytes: float,
             deps: Sequence[str] = ()) -> str:
        hops = _route(net, a, b)
        if not hops or nbytes <= 0.0:
            des.add(name, (), (), deps)
            return name
        des.add(name, tuple(h[0] for h in hops),
                tuple(nbytes / h[1] for h in hops), deps)
        return name

    def compute(name: str, worker: str, seconds: float,
                deps: Sequence[str] = ()) -> str:
        des.add(name, (f"cpu:{worker}",), (max(seconds, 0.0),), deps)
        return name

    # --- input distribution ---------------------------------------------
    xfer(nm("in_o"), origin, wo, bo * Q if wo != origin else 0.0)
    xfer(nm("in_s"), origin, ws, bs * Q if ws != origin else 0.0)
    xfer(nm("in_l"), origin, wl, bl * Q if wl != origin else 0.0)

    # --- forward ----------------------------------------------------------
    compute(nm("f_s"), ws, bs * F[s, ms], [nm("in_s")] + lag("u_s"))
    xfer(nm("act_s"), ws, wo, bs * profile.MO[ms - 1] if ms > 0 and bs > 0
         else 0.0, [nm("f_s")])
    compute(nm("f_l"), wl, bl * F[l, ml], [nm("in_l")] + lag("u_l"))
    xfer(nm("act_l"), wl, wo, bl * profile.MO[ml - 1] if ml > 0 and bl > 0
         else 0.0, [nm("f_l")])
    compute(nm("f_o1"), wo, bo * F[o, ms], [nm("in_o")] + lag("u_o"))
    compute(nm("f_o2"), wo, (bo + bs) * (F[o, ml] - F[o, ms]),
            [nm("f_o1"), nm("act_s")])
    compute(nm("f_o3"), wo, (bo + bs + bl) * (F[o, N] - F[o, ml]),
            [nm("f_o2"), nm("act_l")])

    # --- backward ---------------------------------------------------------
    compute(nm("b_o3"), wo, (bo + bs + bl) * (Bk[o, N] - Bk[o, ml]),
            [nm("f_o3")])
    xfer(nm("gact_l"), wo, wl, bl * profile.MG[ml - 1] if ml > 0 and bl > 0
         else 0.0, [nm("b_o3")])
    compute(nm("b_l"), wl, bl * Bk[l, ml], [nm("gact_l")])
    compute(nm("b_o2"), wo, (bo + bs) * (Bk[o, ml] - Bk[o, ms]),
            [nm("b_o3")])
    xfer(nm("gact_s"), wo, ws, bs * profile.MG[ms - 1] if ms > 0 and bs > 0
         else 0.0, [nm("b_o2")])
    compute(nm("b_s"), ws, bs * Bk[s, ms], [nm("gact_s")])
    compute(nm("b_o1"), wo, bo * Bk[o, ms], [nm("b_o2")])

    # --- weight update ----------------------------------------------------
    xfer(nm("wg_s_up"), ws, wo, MPc[ms] if bs > 0 else 0.0, [nm("b_s")])
    xfer(nm("wg_l_up"), wl, wo, MPc[ml] if bl > 0 else 0.0, [nm("b_l")])
    xfer(nm("wg_s_down"), wo, ws, MPc[ms] if bs > 0 else 0.0,
         [nm("wg_s_up"), nm("b_o1")])
    xfer(nm("wg_l_down"), wo, wl, MPc[ml] if bl > 0 else 0.0,
         [nm("wg_l_up"), nm("b_o1")])
    compute(nm("u_o"), wo, U[o, N], [nm("b_o1"), nm("wg_s_up"),
                                     nm("wg_l_up")])
    compute(nm("u_s"), ws, U[s, ms] if bs > 0 else 0.0, [nm("wg_s_down")])
    compute(nm("u_l"), wl, U[l, ml] if bl > 0 else 0.0, [nm("wg_l_down")])


def _simulate_iteration(profile: HierProfile, net: Network, sched: Schedule,
                        origin: str = "device") -> float:
    """Makespan (seconds) of one training iteration under `sched` on the
    canonical three-worker DES (``Plan.simulate`` for triple fleets)."""
    des = Des()
    _add_iteration(des, profile, net, sched, origin)
    return des.run()


def _simulate_iteration_multi(profile: MultiProfile, net: StarNetwork,
                              sched: MultiSchedule) -> float:
    """Makespan (seconds) of one M-device iteration under ``sched`` on the
    star DES (``Plan.simulate`` for star fleets).

    Mirrors :func:`_simulate_iteration` on the star topology: one compute
    resource per worker, one shaped pipe per worker pair (each device's
    radio is its own resource, so M uploads to the edge genuinely overlap),
    and edge/cloud-resident tasks ingest their sub-batch as M parallel
    transfers of ``b/M`` samples — one per device — matching the cost
    model's even-upload assumption.  Following the paper's §VI-B Linux-TC
    emulation one class further, the input-distribution flow gets its own
    shaped pipe per (device, worker) pair instead of contending with that
    device's activation flow: with a physically shared radio the DES
    diverges from the generalized Eq. 12 by up to ~26% on upload-heavy
    schedules (same family as the relayed-route divergence recorded in
    EXPERIMENTS.md §Fig.6).
    """
    des = Des()
    _add_iteration_multi(des, profile, net, sched)
    return des.run()


def _add_iteration_multi(des: Des, profile: MultiProfile, net: StarNetwork,
                         sched: MultiSchedule, tag: str = "",
                         prev: Optional[str] = None) -> None:
    """M-device counterpart of :func:`_add_iteration` (same tag/prev
    contract): one iteration's star-topology task DAG, with the §7
    cross-iteration update->forward dependencies when ``prev`` is given."""
    p = profile.prefix()
    F, Bk, U, MPc = p["F"], p["Bk"], p["U"], p["MP"]
    N = profile.num_layers
    M = profile.num_devices       # data holders; streams come from sched
    W = profile.num_workers
    edge_of = net.edge_of         # device -> edge index ((0,)*M on a star)
    backhaul = net.backhaul       # per-edge backhaul ([bw_ec] on a star)
    names = profile.worker_names
    widx = profile.widx
    o, l = widx[sched.worker_o], widx[sched.worker_l]
    s = [widx[w] for w in sched.s_workers]
    ml = sched.m_l
    bo, bl = sched.b_o, sched.b_l
    bs = list(sched.b_s)
    msmax = max(sched.m_s)
    bwm = net.bw_matrix()
    Q = profile.sample_bytes

    def nm(base: str) -> str:
        return tag + base

    def lag(base: str) -> List[str]:
        return [prev + base] if prev is not None else []

    def xfer(name: str, a: int, b: int, nbytes: float,
             deps: Sequence[str] = ()) -> str:
        if a == b or nbytes <= 0.0:
            des.add(name, (), (), deps)
            return name
        des.add(name, (f"link:{names[a]}->{names[b]}",),
                (nbytes / bwm[a, b],), deps)
        return name

    def compute(name: str, w: int, seconds: float,
                deps: Sequence[str] = ()) -> str:
        des.add(name, (f"cpu:{names[w]}",), (max(seconds, 0.0),), deps)
        return name

    def ingest(base: str, w: int, b: int) -> List[str]:
        """Input distribution for a task on worker ``w``: local (free) on a
        device, else ``b/M`` samples uploaded from every device at once,
        each on its own TC-shaped input-class radio pipe (see docstring).
        Relayed uploads cross one shaped input-class pipe per (shared
        hop, destination) pair, so same-destination flows serialize
        there — matching ``upload_bw``'s series composition instead of
        overbooking a backhaul M-fold: cloud-bound chunks cross the
        sender's per-edge backhaul pipe (``link:in:edge->cloud`` at E=1,
        the star's literal pipe name); chunks bound for a *foreign* edge
        cross their own uplink class (``...->cloud:{dst}``, keeping them
        off the cloud-bound class) plus that edge's downlink class."""
        if w < M or b == 0:
            des.add(nm(base), (), (), ())
            return [nm(base)]
        out = []
        chunk = b * Q / M
        for j in range(M):
            name = f"{nm(base)}_{j}"
            own = M + edge_of[j]         # device_j's aggregation edge
            radio = (f"link:in:{names[j]}->{names[w]}",
                     chunk / net.bw_de[j])
            bh_up = (f"link:in:{names[own]}->cloud",
                     chunk / backhaul[edge_of[j]])
            if w == W - 1:               # device_j -> its edge -> cloud
                # the radio hop is the (device, cloud) input class — its
                # own TC pipe, NOT shared with the (device, edge) class
                # (LM-fleet ingest is MBs per sample; sharing the first
                # hop diverged from upload_bw by ~50% there)
                hops = (radio, bh_up)
            elif w == own:               # direct radio hop to its edge
                hops = ((radio[0], chunk / bwm[j, w]),)
            else:                        # foreign edge: relay via cloud
                hops = (radio,
                        (f"{bh_up[0]}:{names[w]}", bh_up[1]),
                        (f"link:in:cloud->{names[w]}",
                         chunk / backhaul[w - M]))
            des.add(name, tuple(h[0] for h in hops),
                    tuple(h[1] for h in hops), ())
            out.append(name)
        return out

    # --- input distribution ---------------------------------------------
    in_o = ingest("in_o", o, bo)
    in_l = ingest("in_l", l, bl)

    # --- forward ----------------------------------------------------------
    acts: List[str] = []
    for i, si in enumerate(s):
        in_i = ingest(f"in_s{i}", si, bs[i])
        compute(nm(f"f_s{i}"), si, bs[i] * F[si, sched.m_s[i]],
                in_i + lag(f"u_s{i}"))
        acts.append(xfer(
            nm(f"act_s{i}"), si, o,
            bs[i] * profile.MO[sched.m_s[i] - 1]
            if sched.m_s[i] > 0 and bs[i] > 0 else 0.0, [nm(f"f_s{i}")]))
    compute(nm("f_l"), l, bl * F[l, ml], in_l + lag("u_l"))
    xfer(nm("act_l"), l, o, bl * profile.MO[ml - 1] if ml > 0 and bl > 0
         else 0.0, [nm("f_l")])
    bs_sum = sum(bs)
    catch_f = sum(bs[i] * (F[o, msmax] - F[o, sched.m_s[i]])
                  for i in range(len(s)))
    catch_b = sum(bs[i] * (Bk[o, msmax] - Bk[o, sched.m_s[i]])
                  for i in range(len(s)))
    compute(nm("f_o1"), o, bo * F[o, msmax], in_o + lag("u_o"))
    compute(nm("f_o2"), o,
            (bo + bs_sum) * (F[o, ml] - F[o, msmax]) + catch_f,
            [nm("f_o1")] + acts)
    compute(nm("f_o3"), o, (bo + bs_sum + bl) * (F[o, N] - F[o, ml]),
            [nm("f_o2"), nm("act_l")])

    # --- backward ---------------------------------------------------------
    compute(nm("b_o3"), o, (bo + bs_sum + bl) * (Bk[o, N] - Bk[o, ml]),
            [nm("f_o3")])
    xfer(nm("gact_l"), o, l, bl * profile.MG[ml - 1] if ml > 0 and bl > 0
         else 0.0, [nm("b_o3")])
    compute(nm("b_l"), l, bl * Bk[l, ml], [nm("gact_l")])
    compute(nm("b_o2"), o,
            (bo + bs_sum) * (Bk[o, ml] - Bk[o, msmax]) + catch_b,
            [nm("b_o3")])
    for i, si in enumerate(s):
        xfer(nm(f"gact_s{i}"), o, si,
             bs[i] * profile.MG[sched.m_s[i] - 1]
             if sched.m_s[i] > 0 and bs[i] > 0 else 0.0, [nm("b_o2")])
        compute(nm(f"b_s{i}"), si, bs[i] * Bk[si, sched.m_s[i]],
                [nm(f"gact_s{i}")])
    compute(nm("b_o1"), o, bo * Bk[o, msmax], [nm("b_o2")])

    # --- weight update ----------------------------------------------------
    wg_ups: List[str] = []
    for i, si in enumerate(s):
        wg_ups.append(xfer(nm(f"wg_s{i}_up"), si, o,
                           MPc[sched.m_s[i]] if bs[i] > 0 else 0.0,
                           [nm(f"b_s{i}")]))
        xfer(nm(f"wg_s{i}_down"), o, si,
             MPc[sched.m_s[i]] if bs[i] > 0 else 0.0,
             [nm(f"wg_s{i}_up"), nm("b_o1")])
        compute(nm(f"u_s{i}"), si,
                U[si, sched.m_s[i]] if bs[i] > 0 else 0.0,
                [nm(f"wg_s{i}_down")])
    xfer(nm("wg_l_up"), l, o, MPc[ml] if bl > 0 else 0.0, [nm("b_l")])
    xfer(nm("wg_l_down"), o, l, MPc[ml] if bl > 0 else 0.0,
         [nm("wg_l_up"), nm("b_o1")])
    compute(nm("u_o"), o, U[o, N], [nm("b_o1"), nm("wg_l_up")] + wg_ups)
    compute(nm("u_l"), l, U[l, ml] if bl > 0 else 0.0, [nm("wg_l_down")])


def simulate_pipeline(profile: Union[HierProfile, MultiProfile],
                      net: Union[Network, StarNetwork],
                      sched: Union[Schedule, MultiSchedule], K: int,
                      origin: str = "device") -> float:
    """Makespan of ``K`` consecutive iterations executed as a pipeline.

    Instantiates K copies of the single-iteration task DAG
    (:func:`_add_iteration` / :func:`_add_iteration_multi`) with the
    cross-iteration dependencies of DESIGN.md §7: each worker's iteration-k
    forward waits on that worker's iteration-(k-1) weight update
    (synchronous SGD), and every link/CPU stays a FIFO resource, so
    consecutive minibatches overlap wherever the dependency structure
    allows.  ``K = 1`` is bit-identical to :func:`simulate_iteration` /
    :func:`simulate_iteration_multi` (same task names, same DAG, same
    dispatch order).  The closed-form model (:mod:`repro_torch.core.pipeline`)
    predicts the asymptotic slope ``t_period``; the property suite asserts
    the measured DES period converges to it.
    """
    assert K >= 1
    multi = isinstance(sched, MultiSchedule)
    des = Des()
    prev: Optional[str] = None
    for k in range(K):
        # Equal-ready tie-breaks are by name, so all K prefetchable input
        # transfers (ready at t = 0) enter each FIFO pipe in *name* order.
        # Iteration tags are zero-padded *prefixes* built on "~" (which
        # sorts after every identifier character), so dispatch ties order
        # iteration-major: every bare first-iteration task first, then
        # "~000001...", "~000002", ... — a pipe never serves iteration
        # k+1's flow ahead of iteration k's.
        tag = "" if k == 0 else f"~{k:06d}"
        if multi:
            _add_iteration_multi(des, profile, net, sched, tag, prev)
        else:
            _add_iteration(des, profile, net, sched, origin, tag, prev)
        prev = tag
    return des.run()
