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
CPU.  They run on the triple, the star and the tree; ``simulate``,
``baseline``, ``explain``, ``plan_many`` and the CLI are numpy and give
the JAX package's numbers and strings ``==``.  On a tree, ``step_fn``'s
``cloud_mesh`` runs the cloud tail data-parallel over a
``torch.distributed`` device mesh (one process per rank).

CLI smoke: ``python -m repro_torch.api --explain lenet5 [--m 2]
[--batch 64] [--topology tree --edges 2] [--wire int8]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch.core import pipeline as _pipeline
from repro_torch.core import scheduler as _scheduler
from repro_torch.core import simulator as _simulator
from repro_torch.core.cost_model import (Breakdown, MultiSchedule, Schedule,
                                         _t_total_multi)
from repro_torch.core.fleet import STAR, TREE, TRIPLE, Fleet
from repro_torch.core.hybrid_step import (hybrid_step_from_schedule,
                                          multi_hybrid_step_from_schedule,
                                          tree_schedule_step,
                                          tree_stream_edges)
from repro_torch.core.layerstack import LayerStack, as_layerstack
from repro_torch.core.wire import apply_wire, validate_wire
from repro_torch.device import resolve_device

__all__ = ["Fleet", "Plan", "plan", "plan_many", "as_layerstack"]

OBJECTIVES = _scheduler.OBJECTIVES


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

    # ---- validation -----------------------------------------------------

    def simulate(self, K: int = 1) -> float:
        """Discrete-event-simulated makespan of ``K`` pipelined
        iterations (``K = 1``: one barrier iteration).  Runs the
        topology-native DES, so triple fleets reproduce the paper's
        three-worker simulation exactly."""
        if K == 1:
            if self.fleet.topology == TRIPLE:
                return _simulator._simulate_iteration(
                    self.profile, self.network, self.schedule)
            return _simulator._simulate_iteration_multi(
                self.profile, self.network, self.schedule)
        return _simulator.simulate_pipeline(self.profile, self.network,
                                            self.schedule, K)

    def baseline(self, tier: str) -> float:
        """Exact ``T_total`` of the all-on-one-worker baseline schedule
        (``tier`` in ``"device" | "edge" | "cloud"``) on this fleet's
        cost model — the paper's All-Edge/All-Cloud comparison points."""
        if tier not in ("device", "edge", "cloud"):
            raise ValueError(f"unknown baseline tier: {tier!r} "
                             f"(pick 'device', 'edge' or 'cloud')")
        if self.fleet.topology == TRIPLE:
            from repro_torch.core.baselines import all_on_one
            return all_on_one(self.profile, self.network, self.B,
                              tier).t_total
        prof = self.profile
        names = prof.worker_names
        S = prof.num_streams
        wo = tier if tier in ("edge", "cloud") else names[0]
        if wo == "edge" and wo not in names:    # tree: edge_0.. at E >= 2
            wo = names[prof.num_devices]
        rest = [w for w in names if w != wo]
        sched = MultiSchedule(worker_o=wo, worker_l=rest[-1],
                              s_workers=tuple(rest[:-1]), m_s=(0,) * S,
                              m_l=0, b_o=self.B, b_s=(0,) * S, b_l=0)
        return _t_total_multi(prof, self.network, sched).total

    # ---- execution ------------------------------------------------------

    def _require_model(self) -> LayerStack:
        if self.model is None:
            raise ValueError(
                "this Plan was built without a model (profile-only "
                "fleet); pass a model/LayerStack to plan() to execute")
        return self.model

    def stream_edges(self) -> tuple:
        """Per-TASK-S-stream hosting edge (tree fleets): a device stream
        sits under its radio's edge, an edge's own stream under itself,
        and a cloud-hosted stream merges with the front group (index 0 —
        on an E=1 tree every stream maps to edge 0, which is what keeps
        the step identical to the star's)."""
        return tree_stream_edges(self.profile, self.network,
                                 self.multi_schedule)

    def step_fn(self, lr: float = 0.05, cloud_mesh=None,
                device: Optional[Union[str, torch.device]] = None
                ) -> Callable:
        """A ``(params, x, y) -> (new_params, loss)`` hybrid-SGD step for
        the chosen schedule (exact batch-B SGD semantics).  ``x``/``y``
        may be numpy arrays or tensors; they are moved to ``device``
        (default ``cuda``), where ``params`` must already live.

        ``cloud_mesh`` (tree fleets only) runs the cloud tail segment
        ``m_l..N`` data-parallel over the ``pod``/``data`` axes of a
        ``DeviceMesh`` (:func:`repro_torch.core.hybrid_step.
        tree_hybrid_sgd_step`); every rank calls the step with the same
        params and batch and ends with the same params."""
        stack = self._require_model()
        if cloud_mesh is not None and self.fleet.topology != TREE:
            raise ValueError("cloud_mesh is a tree-topology option; this "
                             f"plan's fleet is {self.fleet.topology!r}")
        dev = resolve_device(device)
        sched = self.schedule
        wire = self.wire
        if self.fleet.topology == TREE:
            run = tree_schedule_step(self.profile, self.network, cloud_mesh)
        elif self.fleet.topology == TRIPLE:
            run = hybrid_step_from_schedule
        else:
            run = multi_hybrid_step_from_schedule

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
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return stack.init(gen, dev)

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
        stack = self._require_model()
        dev = resolve_device(device)
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

    # ---- reporting ------------------------------------------------------

    def explain(self) -> str:
        """Human-readable cut/split/cost breakdown of the decision."""
        bd = self.breakdown
        s = self.schedule
        res = self.result
        name = self.model.name if self.model is not None else "(profile)"
        ms = s.m_s if isinstance(s.m_s, int) else \
            "/".join(str(m) for m in s.m_s)
        t_edge, t_cloud = self.baseline("edge"), self.baseline("cloud")
        lines = [
            f"HierTrain plan — model={name}  fleet[{self.fleet.describe()}]",
            f"  batch B={self.B}  objective={self.objective}  "
            f"backend={self.backend}  wire={self.wire}",
            f"  schedule: {s.describe()}",
            f"  cuts: m_s={ms}  m_l={s.m_l}  of N={self.profile.num_layers}"
            f" layers",
            f"  predicted: T_total={bd.total:.6g}s  "
            f"T_period={self.t_period:.6g}s",
            f"  phases (s): f1={bd.t_f1:.4g} b1={bd.t_b1:.4g} "
            f"f2={bd.t_f2:.4g} b2={bd.t_b2:.4g} f3={bd.t_f3:.4g} "
            f"b3={bd.t_b3:.4g} update={bd.t_update:.4g}",
            f"  comm (s): input={bd.comm_input:.4g} "
            f"activation={bd.comm_activation:.4g} "
            f"weight-sync={bd.comm_weightgrad:.4g}",
            f"  baselines: all-edge={t_edge:.6g}s "
            f"({t_edge / bd.total:.2f}x)  all-cloud={t_cloud:.6g}s "
            f"({t_cloud / bd.total:.2f}x)",
        ]
        if self.pipeline_depth > 1:
            K = self.pipeline_depth
            tk = self.pipeline_time(K)
            lines.append(
                f"  pipelined: T(K={K})={tk:.6g}s vs barrier "
                f"{K * bd.total:.6g}s ({K * bd.total / tk:.2f}x)")
        search = (f"  search: {res.n_candidates} candidates, "
                  f"{res.n_pruned} pruned, {res.n_lp_solved} LPs")
        if getattr(res, "n_lp_refine", 0):
            search += (f" (+{res.n_lp_refine} refine LPs, "
                       f"{res.refine_rounds} rounds)")
        lines.append(search)
        return "\n".join(lines)


def _prepare(model, fleet: Fleet, wire: Optional[str]):
    """Resolve the wire codec, adapt the model to a :class:`LayerStack`,
    build the wire-adjusted profile and the native network.  Used by
    :func:`plan` and by the cross-fleet planner
    (``repro_torch.serve.planner``), so both see identical solver
    inputs."""
    wire = fleet.wire if wire is None else validate_wire(wire)
    stack = as_layerstack(model) if model is not None else None
    profile = apply_wire(fleet.profile_for(stack), stack, wire)
    net = fleet.network()
    return stack, profile, net, wire


def plan_many(requests, **kwargs):
    """Batch front door: plan many fleets in shared tableau stacks with a
    fingerprinted plan cache (``repro_torch.serve.planner``, DESIGN.md
    §13).  Takes :class:`repro_torch.serve.planner.PlanRequest` items;
    returns plans in request order."""
    from repro_torch.serve import planner as _planner
    return _planner.plan_many(requests, **kwargs)


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


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.api --explain <config>
# ---------------------------------------------------------------------------

_CLI_CONFIGS = ("lenet5", "alexnet", "lm")


def _cli_model_and_fleet(config: str, m: int, edge_cloud_mbps, topology,
                         n_edges: int = 1):
    if config in ("lenet5", "alexnet"):
        from repro_torch.models import cnn
        model = getattr(cnn, config)()
        return model, Fleet.from_table2(
            model=config, m=m,
            edge_cloud_mbps=3.0 if edge_cloud_mbps is None
            else edge_cloud_mbps,
            topology=topology, n_edges=n_edges)
    if config == "lm":
        if topology == TRIPLE:
            raise SystemExit("the lm fleet is star-native; drop "
                             "--topology triple")
        from repro_torch.core.fleet import LM_BACKHAUL_MBPS
        from repro_torch.models.lm.layerstack import lm_layerstack
        from repro_torch.models.lm.model import LMConfig
        cfg = LMConfig(name="api-lm", family="dense", n_layers=6,
                       d_model=256, n_heads=4, n_kv_heads=2, d_ff=768,
                       vocab=32_000)
        fleet = Fleet.lm_default(
            m=m, backhaul_mbps=LM_BACKHAUL_MBPS if edge_cloud_mbps is None
            else edge_cloud_mbps)
        return lm_layerstack(cfg, seq_len=256), fleet
    raise SystemExit(f"unknown config {config!r}; pick one of "
                     f"{_CLI_CONFIGS}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.api",
        description="Plan a HierTrain schedule and explain it.")
    ap.add_argument("--explain", metavar="CONFIG", required=True,
                    help=f"one of {', '.join(_CLI_CONFIGS)}")
    ap.add_argument("--m", type=int, default=1,
                    help="number of devices in the fleet")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--edge-cloud-mbps", type=float, default=None,
                    help="edge-cloud backhaul (default: 3 Mbps for the "
                         "CNN testbeds, 200 Mbps for the lm fleet)")
    ap.add_argument("--objective", choices=OBJECTIVES, default="latency")
    ap.add_argument("--pipeline-depth", type=int, default=1)
    ap.add_argument("--topology", choices=("auto", TRIPLE, STAR, TREE),
                    default="auto")
    ap.add_argument("--edges", type=int, default=1,
                    help="edge-server count (tree topology; devices are "
                         "partitioned contiguously)")
    ap.add_argument("--wire", choices=("none", "int8"), default="none",
                    help="cut-point transfer codec: int8 plans with and "
                         "executes compressed activation/gradient wires")
    args = ap.parse_args(argv)
    model, fleet = _cli_model_and_fleet(args.explain, args.m,
                                        args.edge_cloud_mbps, args.topology,
                                        n_edges=args.edges)
    p = plan(model, fleet, args.batch, objective=args.objective,
             pipeline_depth=args.pipeline_depth, wire=args.wire)
    print(p.explain())
    print(f"  simulated (DES): {p.simulate():.6g}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
