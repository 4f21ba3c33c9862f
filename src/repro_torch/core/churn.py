"""Elastic-fleet churn: typed membership events, deterministic Poisson
traces, and schedule remapping (DESIGN.md §10).

The numpy port of :mod:`repro.core.churn`; traces, membership edits and
remapped schedules are ``==`` to the JAX package's on the same inputs.

HierTrain's scheduler assumes a static device/edge/cloud fleet, but the
MECC deployments the paper targets are *mobile* fleets: devices join,
leave, die, and see their radios fade mid-training.  This module is the
event layer the hierarchical training loop
(:func:`repro_torch.train.loop._run_loop` via ``Plan.train(churn=...)``)
consumes:

* **Typed events** — :class:`DeviceJoin`, :class:`DeviceLeave`,
  :class:`DeviceCrash`, :class:`LinkDegrade` — each pinned to the train
  step *before* which it takes effect.  Events only ever target devices;
  the edge and cloud are infrastructure.
* **Deterministic traces** — :func:`poisson_trace` draws per-step event
  counts from independent Poisson processes using a counter-based
  Philox generator, so a trace is a pure function of its seed (same
  property the synthetic data pipeline relies on for crash-safe resume).
* **Membership edits** — :func:`apply_event` maps an event onto the
  ``(EMA'd profile, baseline profile, network)`` triple using the
  membership primitives on :class:`~repro_torch.core.cost_model.MultiProfile`
  / :class:`~repro_torch.core.cost_model.StarNetwork`.  Survivor rows are
  byte-identical to the pre-churn rows, which is what makes the
  post-churn re-solve bit-equal to a cold solve on a fresh fleet of the
  survivors.
* **Schedule remap** — :func:`remap_schedule` projects the in-flight
  schedule onto the new membership (a departed TASK-S worker's samples
  fold into TASK O's sub-batch, joiners enter idle), giving the warm
  incumbent the re-solve feeds into the dominance prune.

Churn is native to the star topology: membership is a property of the
M-device star, and the paper's fixed three-worker triple has no notion
of it (``Plan.train(churn=...)`` raises on ``topology="triple"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cost_model import (MultiProfile, MultiSchedule,
                                         StarNetwork)
from repro_torch.core.fleet import MBPS


@dataclasses.dataclass(frozen=True)
class DeviceJoin:
    """Device ``name`` joins before step ``step``.

    ``slowdown`` seeds the joiner's compute rows from the fleet's
    reference device tier (the initial baseline profile's first device
    row at slowdown 1.0) — i.e. the joiner's
    :class:`~repro_torch.core.profiler.WorkerSpec` tier expressed the same way
    ``Fleet.device_slowdowns`` expresses heterogeneity.  The online EMA
    refines the seed as soon as the straggler monitor reports the
    device.  ``uplink_mbps`` is its radio.
    """
    step: int
    name: str
    slowdown: float = 1.0
    uplink_mbps: float = 5.0


@dataclasses.dataclass(frozen=True)
class DeviceLeave:
    """Device ``name`` departs gracefully before step ``step``."""
    step: int
    name: str


@dataclasses.dataclass(frozen=True)
class DeviceCrash:
    """Device ``name`` dies mid-step: same membership edit as a leave,
    but the step in flight is lost and must be re-run by the survivors
    (the loop charges the lost fill latency as recovery time)."""
    step: int
    name: str


@dataclasses.dataclass(frozen=True)
class LinkDegrade:
    """Device ``name``'s uplink is multiplied by ``factor`` before step
    ``step`` (``factor < 1`` fades, ``factor > 1`` heals).  Membership is
    unchanged; only the network edits."""
    step: int
    name: str
    factor: float


ChurnEvent = Union[DeviceJoin, DeviceLeave, DeviceCrash, LinkDegrade]


@dataclasses.dataclass(frozen=True)
class ChurnTrace:
    """An ordered stream of churn events.

    Events with ``step == s`` take effect at the *top* of train step
    ``s``, before its schedule is (re-)solved and before its batch is
    split — so step ``s`` itself already runs on the post-churn fleet.
    """
    events: Tuple[ChurnEvent, ...]

    def __post_init__(self) -> None:
        steps = [e.step for e in self.events]
        assert steps == sorted(steps), "trace events must be step-ordered"

    def events_at(self, step: int) -> Tuple[ChurnEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def since(self, step: int) -> "ChurnTrace":
        """The sub-trace from ``step`` onward — what a run resumed at
        ``step`` still has to apply (earlier events are already baked
        into the checkpointed membership)."""
        return ChurnTrace(tuple(e for e in self.events if e.step >= step))

    @property
    def max_step(self) -> int:
        return max((e.step for e in self.events), default=-1)


def poisson_trace(device_names: Sequence[str], total_steps: int, *,
                  join_rate: float = 0.02, leave_rate: float = 0.02,
                  crash_rate: float = 0.01, degrade_rate: float = 0.02,
                  seed: int = 0, min_devices: int = 1,
                  max_devices: Optional[int] = None,
                  slowdown_range: Tuple[float, float] = (1.0, 3.0),
                  uplink_mbps_range: Tuple[float, float] = (3.0, 5.0),
                  degrade_factor_range: Tuple[float, float] = (0.25, 0.75),
                  first_step: int = 1) -> ChurnTrace:
    """Deterministic Poisson churn trace over ``total_steps`` train steps.

    Per step and per event type, the event count is drawn from an
    independent Poisson process with the given per-step rate; targets
    and magnitudes are drawn uniformly.  The generator is a
    counter-based Philox keyed on ``seed``, so the trace is a pure
    function of its arguments — two runs (or a killed run and its
    resume) see the identical stream.

    Membership is tracked while generating: leaves/crashes never shrink
    the fleet below ``min_devices``, joins never grow it past
    ``max_devices``, and joiner names (``dev_j0``, ``dev_j1``, ...) never
    collide with a live or past member.
    """
    assert min_devices >= 1 and first_step >= 1
    rng = np.random.Generator(np.random.Philox(key=seed))
    live = list(device_names)
    used = set(live)
    events: list = []
    next_id = 0
    for step in range(first_step, total_steps):
        for kind, rate in (("leave", leave_rate), ("crash", crash_rate),
                           ("degrade", degrade_rate), ("join", join_rate)):
            for _ in range(int(rng.poisson(rate))):
                if kind in ("leave", "crash"):
                    if len(live) <= min_devices:
                        continue
                    name = live.pop(int(rng.integers(len(live))))
                    cls = DeviceLeave if kind == "leave" else DeviceCrash
                    events.append(cls(step, name))
                elif kind == "degrade":
                    name = live[int(rng.integers(len(live)))]
                    factor = float(rng.uniform(*degrade_factor_range))
                    events.append(LinkDegrade(step, name, factor))
                else:
                    if max_devices is not None and len(live) >= max_devices:
                        continue
                    while f"dev_j{next_id}" in used:
                        next_id += 1
                    name = f"dev_j{next_id}"
                    next_id += 1
                    slow = float(rng.uniform(*slowdown_range))
                    up = float(rng.uniform(*uplink_mbps_range))
                    events.append(DeviceJoin(step, name, slow, up))
                    live.append(name)
                    used.add(name)
    return ChurnTrace(tuple(events))


RefRows = Tuple[np.ndarray, np.ndarray, np.ndarray]


def reference_rows(base: MultiProfile) -> RefRows:
    """The fleet's reference device tier — per-layer ``(L_f, L_b, L_u)``
    of the baseline profile's first device row — against which
    :class:`DeviceJoin` slowdowns are expressed.  Captured once at loop
    start (and checkpointed) so joins are reproducible across resume
    even after the first device itself has churned out."""
    return (base.L_f[0].copy(), base.L_b[0].copy(), base.L_u[0].copy())


def apply_event(prof: MultiProfile, base: MultiProfile, net: StarNetwork,
                ref: RefRows, event: ChurnEvent
                ) -> Tuple[MultiProfile, MultiProfile, StarNetwork, bool]:
    """Apply one event to the ``(EMA'd profile, baseline profile,
    network)`` triple; returns the edited triple plus whether fleet
    *membership* changed (joins/leaves/crashes — the cases that force a
    schedule re-solve and a batch remap; a pure link fade keeps the
    schedule feasible and only re-scores it)."""
    if isinstance(event, DeviceJoin):
        lf, lb, lu = ref
        s = float(event.slowdown)
        if s <= 0:
            raise ValueError("join slowdown must be positive")
        prof = prof.add_device(event.name, lf * s, lb * s, lu * s)
        base = base.add_device(event.name, lf * s, lb * s, lu * s)
        net = net.add_device(event.uplink_mbps * MBPS)
        return prof, base, net, True
    if isinstance(event, (DeviceLeave, DeviceCrash)):
        i = prof.device_index(event.name)
        return (prof.drop_device(event.name), base.drop_device(event.name),
                net.drop_device(i), True)
    if isinstance(event, LinkDegrade):
        i = prof.device_index(event.name)
        return prof, base, net.scale_uplink(i, event.factor), False
    raise TypeError(f"unknown churn event: {event!r}")


def remap_schedule(sched: MultiSchedule, profile: MultiProfile
                   ) -> Optional[MultiSchedule]:
    """Project a live schedule onto a new fleet membership.

    A departed TASK-S worker's samples fold into TASK O's sub-batch
    (TASK O runs the full model, so it can absorb any front-end stream
    without violating the cut constraints — exact batch-B SGD is
    preserved because the *set* of samples in the step is unchanged);
    joiners enter with an idle TASK-S slot (``m_s = 0``, ``b_s = 0``)
    until the next re-solve assigns them work.  Returns ``None`` when
    the departed worker held TASK O or TASK L — the cut structure
    itself is gone and only a cold solve can rebuild it.

    The remapped schedule is feasible on the new fleet, so its exact
    cost is a valid incumbent for the warm-started re-solve.
    """
    names = set(profile.worker_names)
    if sched.worker_o not in names or sched.worker_l not in names:
        return None
    kept = [(w, m, b) for w, m, b in
            zip(sched.s_workers, sched.m_s, sched.b_s) if w in names]
    lost = sum(b for w, _, b in
               zip(sched.s_workers, sched.m_s, sched.b_s) if w not in names)
    taken = {sched.worker_o, sched.worker_l, *(w for w, _, _ in kept)}
    joiners = [w for w in profile.worker_names if w not in taken]
    s_workers = tuple(w for w, _, _ in kept) + tuple(joiners)
    m_s = tuple(m for _, m, _ in kept) + (0,) * len(joiners)
    b_s = tuple(b for _, _, b in kept) + (0,) * len(joiners)
    return MultiSchedule(worker_o=sched.worker_o, worker_l=sched.worker_l,
                         s_workers=s_workers, m_s=m_s, m_l=sched.m_l,
                         b_o=sched.b_o + lost, b_s=b_s, b_l=sched.b_l)
