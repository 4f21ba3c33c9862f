"""Deterministic synthetic fleet populations for the planner benchmark.

The numpy port of :mod:`repro.serve.population`, over the port's
``lenet5``, ``alexnet`` and ``dense`` LM stacks; the requests and their
fingerprints are ``==`` to the JAX package's.

Models the serving regime the planner targets: a large client population
drawn from a *finite catalog of device classes* (phone models ×
firmware throttles × radio plans), where many clients share a class —
exactly the structure that makes a fingerprinted plan cache pay off —
but classes themselves are heterogeneous in compute, uplink and
backhaul.

Four families, mixing the paper's Table-II CNN testbeds with the LM
fleet (DESIGN.md §8):

========  ========  ====  ====================================
family    topology   M    base profile
========  ========  ====  ====================================
lenet5    triple     1    ``Fleet.from_table2("lenet5")``
alexnet   triple     1    ``Fleet.from_table2("alexnet")``
lm-m2     star       2    dense LM, ``Fleet.lm_default(2)``
lm-m3     star       3    dense LM, ``Fleet.lm_default(3)``
========  ========  ====  ====================================

Each family gets ``count // 8`` device classes (min 1); per class the
device compute rows, uplink bandwidths and the backhaul are scaled by
factors drawn from ``np.random.default_rng(seed)``, and every client
fleet is pinned (``Fleet.from_profile``) so requests are fully
self-describing.  Everything is a pure function of ``(n, seed)`` —
float64 ops only — so the same population (same fingerprints) is
reproduced in any process.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.cost_model import (HierProfile, MultiProfile, Network,
                                         StarNetwork)
from repro_torch.core.fleet import Fleet
from repro_torch.serve.planner import PlanRequest

__all__ = ["FAMILIES", "synthetic_population"]

#: (family, weight numerator / 32, batch size).  LM counts are kept
#: smaller because one M=3 stage-A grid is ~20x a lenet5 grid.
FAMILIES: Tuple[Tuple[str, int, int], ...] = (
    ("lenet5", 12, 128),
    ("alexnet", 10, 64),
    ("lm-m2", 7, 64),
    ("lm-m3", 3, 64),
)

#: LM clients carry down-sampled ~200 kB training samples (the 2 MB raw
#: default would pin every schedule to TASK-O on the slowest radio and
#: make the population's schedule diversity trivial).
_LM_SAMPLE_BYTES = 2e5


def _lm_stack():
    from repro_torch.models.lm.layerstack import lm_layerstack
    from repro_torch.models.lm.model import LMConfig
    cfg = LMConfig(name="pop-lm", family="dense", n_layers=6,
                   d_model=256, n_heads=4, n_kv_heads=2, d_ff=768,
                   vocab=32_000)
    return lm_layerstack(cfg, seq_len=256)


def _base(family: str):
    """(base profile, base network) of one family — built once."""
    if family in ("lenet5", "alexnet"):
        from repro_torch.models.cnn import alexnet, lenet5
        model = {"lenet5": lenet5, "alexnet": alexnet}[family]()
        fleet = Fleet.from_table2(family, m=1, topology="triple")
        return fleet.profile_for(model), fleet.network()
    m = {"lm-m2": 2, "lm-m3": 3}[family]
    fleet = Fleet.lm_default(m=m, sample_bytes=_LM_SAMPLE_BYTES)
    return fleet.profile_for(_lm_stack()), fleet.network()


def _perturb_triple(prof: HierProfile, net: Network, comp: float,
                    up: float, bh: float) -> Tuple[HierProfile, Network]:
    L_f, L_b, L_u = prof.L_f.copy(), prof.L_b.copy(), prof.L_u.copy()
    L_f[0] *= comp
    L_b[0] *= comp
    L_u[0] *= comp
    return (HierProfile(prof.layer_names, L_f, L_b, L_u, prof.MP.copy(),
                        prof.MO.copy(), prof.sample_bytes, prof.MG.copy()),
            Network(bw_de=net.bw_de * up, bw_ec=net.bw_ec * bh))


def _perturb_star(prof: MultiProfile, net: StarNetwork,
                  comp: np.ndarray, up: np.ndarray, bh: float
                  ) -> Tuple[MultiProfile, StarNetwork]:
    M = prof.num_devices
    L_f, L_b, L_u = prof.L_f.copy(), prof.L_b.copy(), prof.L_u.copy()
    L_f[:M] *= comp[:, None]
    L_b[:M] *= comp[:, None]
    L_u[:M] *= comp[:, None]
    return (MultiProfile(prof.layer_names, prof.worker_names, L_f, L_b,
                         L_u, prof.MP.copy(), prof.MO.copy(),
                         prof.sample_bytes, prof.MG.copy()),
            StarNetwork(bw_de=net.bw_de * up, bw_ec=net.bw_ec * bh))


def family_counts(n: int) -> List[Tuple[str, int, int]]:
    """Deterministic ``(family, count, B)`` split of an ``n``-client
    population (weights from :data:`FAMILIES`; remainder to the first)."""
    total_w = sum(w for _, w, _ in FAMILIES)
    counts = [(fam, n * w // total_w, B) for fam, w, B in FAMILIES]
    short = n - sum(c for _, c, _ in counts)
    fam0, c0, b0 = counts[0]
    counts[0] = (fam0, c0 + short, b0)
    return counts


def synthetic_population(n: int = 1024, seed: int = 0,
                         classes_per: int = 8) -> List[PlanRequest]:
    """``n`` pinned-fleet :class:`PlanRequest`\\ s over the four families.

    Each family draws ``count // classes_per`` device classes (min 1);
    clients are assigned classes uniformly, and two clients of one class
    are *identical* fleets (same fingerprint).  Fully deterministic in
    ``(n, seed, classes_per)``.
    """
    rng = np.random.default_rng(seed)
    reqs: List[PlanRequest] = []
    for family, count, B in family_counts(n):
        if count <= 0:
            continue
        prof, net = _base(family)
        n_classes = max(1, count // classes_per)
        if isinstance(prof, MultiProfile):
            M = prof.num_devices
            comp = rng.uniform(0.7, 1.4, size=(n_classes, M))
            up = rng.uniform(0.7, 1.4, size=(n_classes, M))
        else:
            comp = rng.uniform(0.7, 1.4, size=(n_classes, 1))
            up = rng.uniform(0.7, 1.4, size=(n_classes, 1))
        bh = rng.uniform(0.85, 1.25, size=n_classes)
        assign = rng.integers(0, n_classes, size=count)
        for i in range(count):
            k = int(assign[i])
            if isinstance(prof, MultiProfile):
                p, nw = _perturb_star(prof, net, comp[k], up[k],
                                      float(bh[k]))
            else:
                p, nw = _perturb_triple(prof, net, float(comp[k, 0]),
                                        float(up[k, 0]), float(bh[k]))
            reqs.append(PlanRequest(fleet=Fleet.from_profile(p, nw), B=B,
                                    tag=f"{family}/c{k}/{i}"))
    return reqs
