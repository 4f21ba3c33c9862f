"""Baseline schedulers from the paper's evaluation (§VI-C).

The numpy port of :mod:`repro.core.baselines`; results are ``==`` to
the JAX package's on the same inputs.

* **All-Edge / All-Cloud** — ship all ``B`` samples to one worker which trains
  the full model.  Expressed as degenerate HierTrain schedules
  (``m_s = m_l = 0``) and evaluated with the exact cost model.
* **JointDNN** [8] — device+cloud layer-granularity partition, whole batch,
  no sample parallelism.  The scheduling is a shortest path over a chain
  graph: state = (layer, location); switching location between consecutive
  layers pays the activation transfer forward *and* the gradient-activation
  transfer backward (both of size ``B * MO_i``).
* **JointDNN+** — our 3-location extension (device/edge/cloud) of the same
  shortest-path scheduling, as described in the paper.
* **JALAD** [13] — edge+cloud partition with the boundary activations
  compressed from 32-bit floats to ``c`` bits (paper uses ``c = 8``), i.e. a
  4x reduction on the *edge-cloud* link only.  Weights/gradients of disjoint
  layer sets never cross links.

All of these train the *full* batch on the chosen location(s): per-layer time
is ``B * (L^f + L^b)`` plus per-layer update time on the owning location.
The data originates at the device; if the first layer set does not run on the
device, the raw samples (``B * Q``) must first be shipped there.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import (WIDX, Breakdown, HierProfile,
                                         Network, Schedule, _t_total)


@dataclasses.dataclass
class BaselineResult:
    name: str
    t_total: float
    placement: List[str]  # per-layer location
    detail: Dict[str, float]


def all_on_one(profile: HierProfile, net: Network, B: int, worker: str,
               origin: str = "device") -> BaselineResult:
    """All-Edge / All-Cloud / device-only: one worker trains everything."""
    sched = Schedule(worker_o=worker, worker_s=worker, worker_l=worker,
                     m_s=0, m_l=0, b_o=B, b_s=0, b_l=0)
    bd = _t_total(profile, net, sched, origin)
    return BaselineResult(
        name=f"all-{worker}", t_total=bd.total,
        placement=[worker] * profile.num_layers,
        detail={"input_comm": bd.comm_input, "compute": bd.total -
                bd.comm_input})


def _partition_shortest_path(profile: HierProfile, net: Network, B: int,
                             locations: Sequence[str],
                             origin: str = "device",
                             act_compress: Dict[Tuple[str, str], float] | None
                             = None) -> Tuple[float, List[str]]:
    """Min-cost per-layer placement over a chain DNN (JointDNN's graph model).

    ``act_compress[(a, b)]`` scales activation bytes on link ``a-b``
    (JALAD's 8-bit compression => 0.25 on edge-cloud).
    """
    N = profile.num_layers
    act_compress = act_compress or {}

    def link_scale(a: str, b: str) -> float:
        return act_compress.get((a, b), act_compress.get((b, a), 1.0))

    def xfer(a: str, b: str, nbytes: float) -> float:
        if a == b or nbytes == 0.0:
            return 0.0
        return nbytes * link_scale(a, b) / net.bw(a, b)

    # Node cost: fwd + bwd + update of layer i at location j, full batch.
    # Edge cost between layer i and i+1 at (a -> b): activation fwd +
    # grad-activation bwd, both B * MO_i.
    INF = float("inf")
    dist = {}
    prev: Dict[Tuple[int, str], Tuple[int, str]] = {}
    for j in locations:
        inp = 0.0 if j == origin else B * profile.sample_bytes / \
            net.bw(origin, j)
        node = B * (profile.L_f[WIDX[j], 0] + profile.L_b[WIDX[j], 0]) + \
            profile.L_u[WIDX[j], 0]
        dist[(0, j)] = inp + node
    for i in range(1, N):
        for j in locations:
            node = B * (profile.L_f[WIDX[j], i] + profile.L_b[WIDX[j], i]) + \
                profile.L_u[WIDX[j], i]
            best, barg = INF, None
            for k in locations:
                edge = 2.0 * xfer(k, j, B * profile.MO[i - 1])
                cand = dist[(i - 1, k)] + edge
                if cand < best:
                    best, barg = cand, k
            dist[(i, j)] = best + node
            prev[(i, j)] = (i - 1, barg)
    end = min(((dist[(N - 1, j)], j) for j in locations))
    # Recover placement.
    placement = [""] * N
    cur = (N - 1, end[1])
    while True:
        placement[cur[0]] = cur[1]
        if cur[0] == 0:
            break
        cur = prev[cur]
    return end[0], placement


def jointdnn(profile: HierProfile, net: Network, B: int,
             origin: str = "device") -> BaselineResult:
    t, placement = _partition_shortest_path(
        profile, net, B, locations=("device", "cloud"), origin=origin)
    return BaselineResult("jointdnn", t, placement, {})


def jointdnn_plus(profile: HierProfile, net: Network, B: int,
                  origin: str = "device") -> BaselineResult:
    t, placement = _partition_shortest_path(
        profile, net, B, locations=("device", "edge", "cloud"),
        origin=origin)
    return BaselineResult("jointdnn+", t, placement, {})


def jalad(profile: HierProfile, net: Network, B: int, origin: str = "device",
          compress_bits: int = 8) -> BaselineResult:
    scale = compress_bits / 32.0
    t, placement = _partition_shortest_path(
        profile, net, B, locations=("edge", "cloud"), origin=origin,
        act_compress={("edge", "cloud"): scale})
    return BaselineResult("jalad", t, placement,
                          {"compress_bits": float(compress_bits)})


def run_all(profile: HierProfile, net: Network, B: int,
            origin: str = "device") -> Dict[str, BaselineResult]:
    return {
        "all-edge": all_on_one(profile, net, B, "edge", origin),
        "all-cloud": all_on_one(profile, net, B, "cloud", origin),
        "jointdnn": jointdnn(profile, net, B, origin),
        "jointdnn+": jointdnn_plus(profile, net, B, origin),
        "jalad": jalad(profile, net, B, origin),
    }
