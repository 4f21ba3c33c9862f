"""One front door: ``Fleet`` → :func:`plan` → :class:`Plan` (DESIGN.md §9).

The port of :mod:`repro.api`.  Planning is numpy and device-free, and
returns the same schedule, ``t_total`` and ``t_period`` as the JAX
package; execution runs the hybrid-SGD step in PyTorch on the card::

    from repro_torch.api import Fleet, plan
    from repro_torch.models.cnn import alexnet

    fleet = Fleet.from_table2(model="alexnet", m=1, wire="int8")
    p = plan(alexnet(), fleet, B=64)                   # Algorithm 1
    params = p.init_params(seed=0)                     # on cuda
    step = p.step_fn(lr=0.05)                          # hybrid SGD step
    params, loss = step(params, x, y)

    out = p.train(data, steps=100)                     # straggler-aware loop

``step_fn``, ``init_params`` and ``train`` default to ``device="cuda"``
and raise when there is no card; pass ``device="cpu"`` to run on the
CPU.  This slice executes the triple and the star; the tree step (and
so ``train`` on a tree fleet), ``simulate``, ``baseline``, ``explain``
and ``plan_many`` come later (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.core import pipeline as _pipeline
from repro_torch.core import scheduler as _scheduler
from repro_torch.core.cost_model import Breakdown, MultiSchedule, Schedule
from repro_torch.core.fleet import STAR, TREE, TRIPLE, Fleet
from repro_torch.core.hybrid_step import (hybrid_step_from_schedule,
                                          multi_hybrid_step_from_schedule)
from repro_torch.core.layerstack import LayerStack, as_layerstack
from repro_torch.core.wire import apply_wire, validate_wire

__all__ = ["Fleet", "Plan", "plan", "as_layerstack"]

def _later(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, "
        f"'Modules to port': {item})")


def _resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """``None`` means the card; raise rather than fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device by default "
                           "and none is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


@dataclasses.dataclass
class Plan:
    """The resolved HierTrain decision for one (model, fleet, B) triple.

    ``schedule`` is the topology-native object (a ``Schedule`` on the
    classic triple, a ``MultiSchedule`` on a star) — use
    :attr:`multi_schedule` for the unified view.  ``result`` is the full
    native scheduler result (LP/prune counters, search log).
    """
    fleet: Fleet
    B: int
    objective: str
    pipeline_depth: int
    backend: str
    profile: Any                  # HierProfile | MultiProfile (native;
    #                               wire-compressed MO/MG when wire != none)
    network: Any                  # Network | StarNetwork (native)
    result: Any                   # SchedulerResult | MultiSchedulerResult
    wire: str = "none"            # cut-point transfer codec (core/wire.py)
    model: Optional[LayerStack] = None

    # ---- the decision ---------------------------------------------------

    @property
    def schedule(self) -> Union[Schedule, MultiSchedule]:
        return self.result.schedule

    @property
    def multi_schedule(self) -> MultiSchedule:
        """The schedule in the unified M-device representation."""
        s = self.schedule
        return s if isinstance(s, MultiSchedule) \
            else MultiSchedule.from_schedule(s)

    @property
    def breakdown(self) -> Breakdown:
        """Exact per-phase Eq.-12 latencies of the chosen schedule."""
        return self.result.breakdown

    @property
    def t_total(self) -> float:
        """Predicted single-iteration (barrier) latency, seconds."""
        return self.result.t_total

    @property
    def t_period(self) -> float:
        """Predicted pipelined steady-state period (DESIGN.md §7)."""
        return self.result.t_period

    def pipeline_time(self, K: Optional[int] = None) -> float:
        """Model wall-clock of a depth-K pipelined run:
        ``T(K) = T_fill + (K - 1) * T_period``.  ``K`` defaults to the
        plan's ``pipeline_depth``."""
        K = self.pipeline_depth if K is None else K
        return _pipeline.t_pipeline(self.profile, self.network,
                                    self.schedule, K)

    # ---- execution ------------------------------------------------------

    def _require_model(self) -> LayerStack:
        if self.model is None:
            raise ValueError(
                "this Plan was built without a model (profile-only "
                "fleet); pass a model/LayerStack to plan() to execute")
        return self.model

    def step_fn(self, lr: float = 0.05,
                device: Optional[Union[str, torch.device]] = None
                ) -> Callable:
        """A ``(params, x, y) -> (new_params, loss)`` hybrid-SGD step for
        the chosen schedule (exact batch-B SGD semantics).  ``x``/``y``
        may be numpy arrays or tensors; they are moved to ``device``
        (default ``cuda``), where ``params`` must already live."""
        stack = self._require_model()
        dev = _resolve_device(device)
        sched = self.schedule
        wire = self.wire
        if self.fleet.topology == TREE:
            raise _later("the tree hybrid step", "the tree step + "
                         "_sharded_tail_grads")
        run = hybrid_step_from_schedule if self.fleet.topology == TRIPLE \
            else multi_hybrid_step_from_schedule

        def step(params, x, y):
            return run(stack, params, torch.as_tensor(x, device=dev),
                       torch.as_tensor(y, device=dev), sched, lr, wire=wire)
        return step

    def init_params(self, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Any:
        """Consensus initial weights (one ``{"w", "b"}`` dict per
        cut-point), drawn from a ``torch.Generator`` seeded with ``seed``
        on ``device`` (default ``cuda``)."""
        stack = self._require_model()
        dev = _resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return stack.init(gen, dev)

    # ---- not ported yet -------------------------------------------------

    def simulate(self, K: int = 1) -> float:
        raise _later("Plan.simulate", "simulator/baselines copies")

    def baseline(self, tier: str) -> float:
        raise _later("Plan.baseline", "simulator/baselines copies")

    def explain(self) -> str:
        raise _later("Plan.explain", "simulator/baselines copies")

    def train(self, data, steps: int, lr: float = 0.05,
              resched_every: int = 20, ema: float = 0.3, seed: int = 0,
              worker_slowdown: Optional[Callable[[int], Dict[str, float]]]
              = None,
              log: Optional[Callable[[str], None]] = None, *,
              churn=None, ckpt_dir: Optional[str] = None,
              ckpt_every: int = 50, keep: int = 3,
              fail_at: Optional[int] = None,
              device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, Any]:
        """Straggler-aware HierTrain loop: real hybrid steps on
        ``device`` (default ``cuda``) for the numerics, the calibrated
        cost model for the wall clock, online EMA re-profiling +
        re-scheduling every ``resched_every`` steps, and pipelined
        fill+period accounting when the plan was built with
        ``pipeline_depth > 1``.  Returns ``{params, history, wall,
        final_schedule, resumed_from, churn_log}``; schedules, walls and
        the churn log equal :meth:`repro.api.Plan.train`'s.

        ``churn`` — a :class:`repro_torch.core.churn.ChurnTrace` of
        membership events for elastic star fleets (DESIGN.md §10);
        raises ``NotImplementedError`` naming the topology on any other
        fleet.  ``ckpt_dir``/``ckpt_every``/``keep`` enable atomic keep-N
        checkpointing and crash-safe resume: rerun the same call after a
        crash and the loop restores the newest checkpoint and continues,
        bitwise equal to an uninterrupted run.  ``fail_at`` injects a
        failure after that step (testing)."""
        from repro_torch.train.loop import HierLoopConfig, _run_loop
        if churn is not None and self.fleet.topology != STAR:
            raise NotImplementedError(
                "churn (elastic membership) is only implemented for the "
                f"star topology; this plan's fleet is "
                f"topology={self.fleet.topology!r}")
        if self.fleet.topology == TREE:
            raise _later("Plan.train on a tree fleet", "the tree step + "
                         "_sharded_tail_grads")
        stack = self._require_model()
        dev = _resolve_device(device)
        cfg = HierLoopConfig(
            total_steps=steps, batch=self.B, lr=lr,
            resched_every=resched_every, ema=ema, seed=seed,
            pipeline_depth=self.pipeline_depth, objective=self.objective,
            wire=self.wire, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
            keep=keep, fail_at=fail_at)
        return _run_loop(cfg, stack, self.profile, self.network, data,
                         worker_slowdown, log,
                         topology=self.fleet.topology, device=dev,
                         initial_schedule=self.schedule, churn=churn)


def _prepare(model, fleet: Fleet, wire: Optional[str]):
    """Resolve the wire codec, adapt the model to a :class:`LayerStack`,
    build the wire-adjusted profile and the native network."""
    wire = fleet.wire if wire is None else validate_wire(wire)
    stack = as_layerstack(model) if model is not None else None
    profile = apply_wire(fleet.profile_for(stack), stack, wire)
    net = fleet.network()
    return stack, profile, net, wire


def plan_many(requests, **kwargs):
    raise _later("plan_many", "serve")


def plan(model, fleet: Fleet, B: int, *, objective: str = "latency",
         pipeline_depth: int = 1, backend: str = "batched",
         wire: Optional[str] = None,
         prune: bool = True, refine_passes: int = 4,
         keep_log: bool = False,
         warm_start: Optional[Union[Schedule, MultiSchedule]] = None
         ) -> Plan:
    """Solve Algorithm 1 for ``(model, fleet, B)`` and return a
    :class:`Plan`.  The arguments are those of :func:`repro.api.plan`,
    and so is the result: the same numpy engines run on the same profile.

    ``model`` is anything :func:`repro_torch.core.layerstack.as_layerstack`
    accepts, or ``None`` for pinned-profile fleets used purely for
    scheduling.  ``wire=None`` inherits ``fleet.wire``; ``"int8"`` plans
    with the compressed ``MO``/``MG`` wire sizes and executes the
    matching quantize→dequantize codec in :meth:`Plan.step_fn`.
    """
    if pipeline_depth < 1:
        raise ValueError("pipeline_depth must be >= 1")
    stack, profile, net, wire = _prepare(model, fleet, wire)
    if fleet.topology == TRIPLE:
        result = _scheduler._solve_3w(
            profile, net, B, keep_log=keep_log, backend=backend,
            prune=prune, objective=objective, warm_start=warm_start)
    else:
        result = _scheduler._solve_multi(
            profile, net, B, keep_log=keep_log, backend=backend,
            prune=prune, refine_passes=refine_passes, objective=objective,
            warm_start=warm_start)
    return Plan(fleet=fleet, B=B, objective=objective,
                pipeline_depth=pipeline_depth, backend=backend,
                profile=profile, network=net, result=result, wire=wire,
                model=stack)
