"""``Fleet`` — the unified topology primitive behind ``repro_torch.api``
(DESIGN.md §9).

A fleet is *M heterogeneous devices + one edge server + one cloud*; the
paper's classic (device, edge, cloud) triple is exactly a fleet at
``M = 1``.  A :class:`Fleet` carries everything the scheduler needs that
is **hardware**, not workload: per-tier compute specs, per-device compute
slowdowns, per-device uplinks and the edge→cloud backhaul — or, in
*pinned-profile* mode, an already-built profile/network pair (used by the
synthetic Table-II benchmarks).

Topology nativity
-----------------
``topology`` records which concrete stack a fleet resolves to:

* ``"triple"`` — the paper's 3-worker types (:class:`HierProfile` /
  :class:`Network` / ``Schedule``) and their scheduler/DES.  Only valid
  at ``M = 1``.
* ``"star"`` — the M-device generalization (:class:`MultiProfile` /
  :class:`StarNetwork` / ``MultiSchedule``).
* ``"tree"`` — the two-level generalization: M devices partitioned
  across E edge servers, each with its own backhaul pipe
  (:class:`TreeProfile` / :class:`TreeNetwork`, still ``MultiSchedule``
  — idle edges hold empty stream slots).  At ``E = 1`` the tree stack
  is bit-identical to the star (DESIGN.md §12), the same way the star
  at ``M = 1`` is bit-identical to the triple.

For the **latency** objective the two stacks are bit-for-bit equivalent
at ``M = 1`` (the equivalence suite asserts it), so the choice is
invisible.  The discrete-event simulators and the steady-state period
model, however, shape network pipes differently (per-destination TC
input classes on the star — see EXPERIMENTS.md §Fig.6), so DES traces
and throughput-objective scores agree only on schedules without input
uploads.  ``topology="auto"`` therefore resolves to ``"triple"`` at
``M = 1`` (the exact paper stack) and ``"star"`` otherwise; benchmarks
that sweep M pass ``topology="star"`` so the M=1 row stays comparable to
the rest of the sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.cost_model import (HierProfile, MultiProfile, Network,
                                   StarNetwork, TreeNetwork, TreeProfile)
from repro_torch.core.profiler import (ALEXNET_TESTBED, LM_TESTBED, PAPER_TESTBED,
                                 WorkerSpec, analytic_profile,
                                 multi_analytic_profile)

MBPS = 1e6 / 8.0                      # paper quotes Mbps; model uses B/s

TRIPLE = "triple"
STAR = "star"
TREE = "tree"

# The paper's §VI-B testbed radios: mobile-edge fixed at 5 Mbps.
MOBILE_EDGE_MBPS = 5.0

# Heterogeneous CNN device fleet (deterministic so BENCH records stay
# comparable across PRs): per-device compute slowdown vs the paper's
# reference device, and per-device uplink Mbps.  The first device is the
# paper's testbed device exactly (slowdown 1.0, 5 Mbps).
FLEET_SLOWDOWNS = (1.0, 1.4, 1.9, 2.5, 1.2, 1.6, 2.2, 3.0)
FLEET_UPLINK_MBPS = (5.0, 4.5, 4.0, 3.5, 5.0, 4.2, 3.8, 3.2)

# LM fleet: same heterogeneity shape on LTE/WiFi-class radios (raw
# payloads are MBs), device-resident ~2 MB raw samples tokenized
# on-device (see benchmarks/fig_lm_fleet.py for the workload story).
LM_FLEET_SLOWDOWNS = (1.0, 1.4, 1.9, 2.5)
LM_FLEET_UPLINK_MBPS = (50.0, 40.0, 30.0, 25.0)
LM_BACKHAUL_MBPS = 200.0
LM_RAW_SAMPLE_BYTES = 2e6

# Per-model worker calibration — the paper's profiling stage measures
# each model on each worker, so effective throughput is model-specific.
TABLE2_TESTBEDS: Dict[str, Dict[str, WorkerSpec]] = {
    "lenet5": PAPER_TESTBED,
    "alexnet": ALEXNET_TESTBED,
}


@dataclasses.dataclass
class Fleet:
    """M devices + edge + cloud, in spec mode or pinned-profile mode.

    Spec mode (the default constructors): ``workers`` maps the three
    tiers (``device``/``edge``/``cloud``) to :class:`WorkerSpec`;
    ``device_slowdowns[i]`` scales the device tier for device *i*;
    ``uplink_mbps[i]`` is device *i*'s radio; ``backhaul_mbps`` the
    edge↔cloud link; ``sample_bytes`` optionally overrides the model's
    per-sample wire size (the LM fleet's raw-payload regime).

    Pinned-profile mode (:meth:`from_profile`): ``_profile``/``_network``
    hold a prebuilt profile/network pair and the spec fields are unused.

    ``wire`` is the fleet's default cut-point transfer codec
    (``"none"`` | ``"int8"``, see :mod:`repro_torch.core.wire`): a property of
    the deployment's links, not the workload, so it lives here and
    :func:`repro_torch.api.plan` picks it up (overridable per plan).
    """
    workers: Optional[Dict[str, WorkerSpec]] = None
    device_slowdowns: Tuple[float, ...] = (1.0,)
    uplink_mbps: Tuple[float, ...] = (MOBILE_EDGE_MBPS,)
    backhaul_mbps: float = 3.0
    sample_bytes: Optional[float] = None
    topology: str = "auto"
    wire: str = "none"
    # -- tree-topology spec fields (ignored on triple/star fleets) --------
    edge_of: Optional[Tuple[int, ...]] = None
    edge_backhaul_mbps: Optional[Tuple[float, ...]] = None
    edge_scales: Optional[Tuple[float, ...]] = None
    cloud_speedup: float = 1.0
    _profile: Optional[Union[HierProfile, MultiProfile]] = None
    _network: Optional[Union[Network, StarNetwork, TreeNetwork]] = None

    def __post_init__(self) -> None:
        from repro_torch.core.wire import validate_wire
        validate_wire(self.wire)
        if self.topology == "auto":
            self.topology = TRIPLE if self.num_devices == 1 else STAR
        if self.topology not in (TRIPLE, STAR, TREE):
            raise ValueError(f"unknown fleet topology: {self.topology!r}")
        if self.topology == TRIPLE and self.num_devices != 1:
            raise ValueError("the classic triple has exactly one device; "
                             "use topology='star' for M >= 2")
        if self._profile is not None:
            names = getattr(self._profile, "worker_names",
                            ("device", "edge", "cloud"))
            if len(set(names)) != len(names):
                dupes = sorted({n for n in names if names.count(n) > 1})
                raise ValueError(
                    f"duplicate worker names in fleet: {dupes}")
        if self.topology == TREE:
            if self._profile is None:
                if self.edge_of is None:
                    raise ValueError("a tree fleet needs edge_of — the "
                                     "device→edge assignment")
                self.edge_of = tuple(int(e) for e in self.edge_of)
                if len(self.edge_of) != self.num_devices:
                    raise ValueError("edge_of needs one entry per device")
                e = self.num_edges
                if sorted(set(self.edge_of)) != list(range(e)):
                    raise ValueError("edge_of must use contiguous edge "
                                     f"indices 0..{e - 1} with every edge "
                                     "non-empty")
                if self.edge_backhaul_mbps is None:
                    self.edge_backhaul_mbps = (self.backhaul_mbps,) * e
                self.edge_backhaul_mbps = tuple(
                    float(b) for b in self.edge_backhaul_mbps)
                if len(self.edge_backhaul_mbps) != e:
                    raise ValueError("need one backhaul per edge")
                if self.edge_scales is not None and \
                        len(self.edge_scales) != e:
                    raise ValueError("need one edge_scale per edge")
        if self._profile is None:
            assert len(self.device_slowdowns) == len(self.uplink_mbps), \
                "need one uplink per device"

    # ---- constructors ---------------------------------------------------

    @classmethod
    def from_profile(cls, profile: Union[HierProfile, MultiProfile],
                     net: Union[Network, StarNetwork],
                     topology: str = "auto", wire: str = "none") -> "Fleet":
        """Wrap an existing profile/network pair (synthetic benchmarks,
        measured profiles).  A :class:`HierProfile` +
        :class:`Network` pair is triple-native; a :class:`MultiProfile` +
        :class:`StarNetwork` pair is star-native (even at M = 1); a
        :class:`TreeProfile` + :class:`TreeNetwork` pair is tree-native
        (even at E = 1)."""
        if isinstance(profile, TreeProfile):
            assert isinstance(net, TreeNetwork), \
                "a TreeProfile needs a TreeNetwork"
            assert profile.num_devices == net.num_devices and \
                profile.n_edges == net.num_edges
            if topology == "auto":
                topology = TREE
            if topology != TREE:
                raise ValueError(
                    "a TreeProfile/TreeNetwork pair is tree-native; reduce "
                    "with profile.to_multi() / net.to_star() for a star "
                    "fleet")
            m = profile.num_devices
            return cls(device_slowdowns=(1.0,) * m,
                       uplink_mbps=(0.0,) * m, topology=topology,
                       wire=wire, edge_of=net.edge_of, _profile=profile,
                       _network=net)
        if isinstance(profile, MultiProfile):
            assert isinstance(net, StarNetwork), \
                "a MultiProfile needs a StarNetwork"
            assert profile.num_devices == net.num_devices
            if topology == "auto":
                topology = STAR
            if topology != STAR:
                raise ValueError(
                    "a MultiProfile/StarNetwork pair is star-native; "
                    "reduce with profile.three_worker() for a triple fleet")
            m = profile.num_devices
        else:
            assert isinstance(profile, HierProfile) and \
                isinstance(net, Network), \
                "a HierProfile needs a Network"
            if topology == "auto":
                topology = TRIPLE
            if topology != TRIPLE:
                raise ValueError(
                    "a HierProfile/Network pair is triple-native; lift "
                    "with MultiProfile.from_hier / StarNetwork."
                    "from_network for a star fleet")
            m = 1
        return cls(device_slowdowns=(1.0,) * m, uplink_mbps=(0.0,) * m,
                   topology=topology, wire=wire, _profile=profile,
                   _network=net)

    @classmethod
    def from_table2(cls, model: str = "lenet5", m: int = 1,
                    edge_cloud_mbps: float = 3.0,
                    topology: str = "auto", wire: str = "none",
                    n_edges: int = 1,
                    cloud_speedup: float = 1.0) -> "Fleet":
        """The paper-calibrated CNN testbed (§VI-B) extended to the
        deterministic heterogeneous device fleet of the M-sweeps.
        ``model`` picks the per-model worker calibration
        (``lenet5`` / ``alexnet``); ``m = 1`` is the paper's exact
        testbed (slowdown 1.0, 5 Mbps uplink).  ``n_edges > 1`` (or
        ``topology="tree"``) partitions the devices contiguously across
        ``n_edges`` edge servers, each with its own ``edge_cloud_mbps``
        backhaul pipe."""
        assert 1 <= m <= len(FLEET_SLOWDOWNS)
        if n_edges > 1 and topology in ("auto", TREE):
            topology = TREE
        if topology == TREE:
            assert 1 <= n_edges <= m
            edge_of = tuple(i * n_edges // m for i in range(m))
            return cls(workers=TABLE2_TESTBEDS[model],
                       device_slowdowns=FLEET_SLOWDOWNS[:m],
                       uplink_mbps=FLEET_UPLINK_MBPS[:m],
                       backhaul_mbps=edge_cloud_mbps, topology=TREE,
                       wire=wire, edge_of=edge_of,
                       cloud_speedup=cloud_speedup)
        return cls(workers=TABLE2_TESTBEDS[model],
                   device_slowdowns=FLEET_SLOWDOWNS[:m],
                   uplink_mbps=FLEET_UPLINK_MBPS[:m],
                   backhaul_mbps=edge_cloud_mbps, topology=topology,
                   wire=wire)

    @classmethod
    def lm_default(cls, m: int = 1,
                   backhaul_mbps: float = LM_BACKHAUL_MBPS,
                   sample_bytes: float = LM_RAW_SAMPLE_BYTES,
                   wire: str = "none") -> "Fleet":
        """The LM fleet (DESIGN.md §8): mobile-NPU/edge-GPU/cloud tiers,
        LTE/WiFi-class radios, device-resident ~2 MB raw samples.
        Star-native at every M so sweeps stay internally comparable."""
        assert 1 <= m <= len(LM_FLEET_SLOWDOWNS)
        return cls(workers=LM_TESTBED,
                   device_slowdowns=LM_FLEET_SLOWDOWNS[:m],
                   uplink_mbps=LM_FLEET_UPLINK_MBPS[:m],
                   backhaul_mbps=backhaul_mbps, sample_bytes=sample_bytes,
                   topology=STAR, wire=wire)

    # ---- views ----------------------------------------------------------

    @property
    def num_devices(self) -> int:
        if self._profile is not None:
            return self._profile.num_devices \
                if isinstance(self._profile, MultiProfile) else 1
        return len(self.device_slowdowns)

    M = num_devices

    @property
    def num_edges(self) -> int:
        """Edge-server count: 1 on triple/star, ``E`` on a tree."""
        if isinstance(self._profile, TreeProfile):
            return self._profile.n_edges
        if self.topology == TREE and self.edge_of is not None:
            return max(self.edge_of) + 1
        return 1

    @property
    def pinned(self) -> bool:
        return self._profile is not None

    def profile_for(self, model=None
                    ) -> Union[HierProfile, MultiProfile]:
        """The native profile: pinned, or built from the model via the
        analytic profiler (triple → :class:`HierProfile`, star →
        :class:`MultiProfile`)."""
        if self._profile is not None:
            return self._profile
        if model is None:
            raise ValueError(
                "this Fleet carries worker specs, not a profile — pass a "
                "model to plan()/profile_for(), or build the Fleet with "
                "Fleet.from_profile(profile, net)")
        if self.topology == TRIPLE:
            return analytic_profile(model, self.workers,
                                    sample_bytes=self.sample_bytes)
        star = multi_analytic_profile(model, self.workers,
                                      device_slowdowns=self.device_slowdowns,
                                      sample_bytes=self.sample_bytes)
        if self.topology == TREE:
            return TreeProfile.from_multi(star, n_edges=self.num_edges,
                                          edge_scales=self.edge_scales,
                                          cloud_speedup=self.cloud_speedup)
        return star

    def network(self) -> Union[Network, StarNetwork, TreeNetwork]:
        """The native network (triple → :class:`Network`, star →
        :class:`StarNetwork`, tree → :class:`TreeNetwork`)."""
        if self._network is not None:
            return self._network
        if self.topology == TRIPLE:
            return Network(bw_de=self.uplink_mbps[0] * MBPS,
                           bw_ec=self.backhaul_mbps * MBPS)
        if self.topology == TREE:
            return TreeNetwork(
                bw_de=np.array(self.uplink_mbps) * MBPS,
                bw_ec=np.array(self.edge_backhaul_mbps) * MBPS,
                edge_of=self.edge_of)
        return StarNetwork(bw_de=np.array(self.uplink_mbps) * MBPS,
                           bw_ec=self.backhaul_mbps * MBPS)

    def describe(self) -> str:
        m = self.num_devices
        tree = f", E={self.num_edges}" if self.topology == TREE else ""
        wire = f", wire={self.wire}" if self.wire != "none" else ""
        if self.pinned:
            return (f"M={m} ({self.topology}{tree}; pinned "
                    f"profile/network{wire})")
        ups = "/".join(f"{u:g}" for u in self.uplink_mbps)
        if self.topology == TREE:
            bhs = "/".join(f"{b:g}" for b in self.edge_backhaul_mbps)
            return (f"M={m} ({self.topology}{tree}; uplinks {ups} Mbps, "
                    f"backhauls {bhs} Mbps{wire})")
        return (f"M={m} ({self.topology}; uplinks {ups} Mbps, "
                f"backhaul {self.backhaul_mbps:g} Mbps{wire})")
