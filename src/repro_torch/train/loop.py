"""Fault-tolerant training loops.

The port of :mod:`repro.train.loop`: ``run_train_loop`` / ``LoopConfig``,
the generic loop around a single-process train step
(:func:`repro_torch.train.step.make_train_step`), and the hierarchical
loop behind :meth:`repro_torch.api.Plan.train` (on the triple, the star
and the tree).  The hierarchical loop's planning, straggler EMA and
simulated wall clock are numpy and give the JAX package's schedules and
walls ``==``; the numerics run the port's hybrid-SGD step in PyTorch on
the plan's device.

Failure model and mitigations:

* **Checkpoint/restart** — atomic keep-N checkpoints every
  ``ckpt_every`` steps (:mod:`repro_torch.checkpoint.store`, the JAX
  package's on-disk format); on start the loop restores the latest and
  resumes at the recorded step.
* **Deterministic skip-ahead** — the data pipeline is stateless
  (batch k is pure in (seed, k)), so resume needs no pipeline replay.
* **Failure injection** — ``fail_at`` raises mid-run (after the
  gradient step and its checkpoint) to exercise the recovery path; a
  restarted run is bitwise equal to an uninterrupted one.
* **Straggler mitigation** (HierTrain-native) — measured per-step worker
  times feed an EMA profile and the Algorithm-1 scheduler re-solves every
  ``resched_every`` steps: a slowed worker automatically sheds
  samples/layers.  This is the paper's profiling stage run *online*.
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.core import scheduler
from repro_torch.core.churn import (DeviceCrash, apply_event, reference_rows,
                                    remap_schedule)
from repro_torch.core.cost_model import (WORKERS, HierProfile, MultiProfile,
                                         MultiSchedule, Schedule,
                                         StarNetwork, TreeProfile, _t_total,
                                         _t_total_multi)
from repro_torch.core.hybrid_step import (hybrid_step_from_schedule,
                                          multi_hybrid_step_from_schedule,
                                          tree_schedule_step)
from repro_torch.core.pipeline import t_period, t_period_multi
from repro_torch.tree import leaves


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    fail_at: Optional[int] = None     # raise after completing this step
    seed: int = 0


def run_train_loop(cfg: LoopConfig, state: Any, train_step: Callable,
                   batch_fn: Callable[[int], Dict[str, Any]],
                   log: Optional[Callable[[str], None]] = print
                   ) -> Dict[str, Any]:
    """Run (or resume) ``train_step(state, batch, step)`` for steps
    ``[start, total_steps)``, where ``start`` is the newest checkpoint's
    step in ``cfg.ckpt_dir`` (0 without one).  ``batch_fn(step)`` gives
    batch ``step`` as numpy arrays (a pure function of the step, so a
    resumed run replays no data); it is moved to the device the state
    lives on.  Returns ``{state, history, resumed_from}``: ``history``
    holds the float metrics every ``log_every`` steps with ``steps_per_s``
    and ``at``."""
    manager = CheckpointManager(cfg.ckpt_dir, cfg.keep) if cfg.ckpt_dir \
        else None
    start = 0
    resumed_from = None
    if manager is not None:
        step, restored = manager.restore_latest(state)
        if restored is not None:
            state, start, resumed_from = restored, step, step

    dev = leaves(state)[0].device
    history: List[Dict[str, float]] = []
    t_last = time.perf_counter()
    for step in range(start, cfg.total_steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_fn(step).items()}
        state, metrics = train_step(state, batch, step)
        if cfg.log_every and (step + 1) % cfg.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            m["steps_per_s"] = cfg.log_every / (now - t_last)
            t_last = now
            m["at"] = step + 1
            history.append(m)
            if log:
                log(f"step {step+1}: loss={m['loss']:.4f} "
                    f"gnorm={m.get('grad_norm', float('nan')):.3f} "
                    f"({m['steps_per_s']:.2f} it/s)")
        if manager is not None and (step + 1) % cfg.ckpt_every == 0:
            manager.save(step + 1, state, extra={"seed": cfg.seed})
        if cfg.fail_at is not None and step + 1 == cfg.fail_at:
            raise InjectedFailure(f"injected failure after step {step+1}")
    return {"state": state, "history": history,
            "resumed_from": resumed_from}


@dataclasses.dataclass
class HierLoopConfig:
    total_steps: int
    batch: int
    lr: float = 0.05
    resched_every: int = 20           # straggler mitigation cadence
    ema: float = 0.3
    seed: int = 0
    pipeline_depth: int = 1           # K minibatches in flight (§7); 1 =
    #                                   barrier-per-iteration execution
    objective: str = "latency"        # scheduler objective (§7)
    wire: str = "none"                # cut-point transfer codec (§11);
    #                                   the caller's profile must carry
    #                                   matching (compressed) MO/MG
    ckpt_dir: Optional[str] = None    # crash-safe resume (DESIGN.md §10)
    ckpt_every: int = 50
    keep: int = 3
    fail_at: Optional[int] = None     # raise after completing this step


def _sched_to_json(s) -> Dict[str, Any]:
    """JSON form of a (Multi)Schedule — ints and strings only, so the
    round-trip through the checkpoint manifest is exact."""
    if isinstance(s, MultiSchedule):
        return {"kind": "star", "worker_o": s.worker_o,
                "worker_l": s.worker_l, "s_workers": list(s.s_workers),
                "m_s": list(s.m_s), "m_l": s.m_l, "b_o": s.b_o,
                "b_s": list(s.b_s), "b_l": s.b_l}
    return {"kind": "triple", "worker_o": s.worker_o,
            "worker_s": s.worker_s, "worker_l": s.worker_l, "m_s": s.m_s,
            "m_l": s.m_l, "b_o": s.b_o, "b_s": s.b_s, "b_l": s.b_l}


def _sched_from_json(d: Dict[str, Any]):
    if d["kind"] == "star":
        return MultiSchedule(
            worker_o=d["worker_o"], worker_l=d["worker_l"],
            s_workers=tuple(d["s_workers"]), m_s=tuple(d["m_s"]),
            m_l=d["m_l"], b_o=d["b_o"], b_s=tuple(d["b_s"]), b_l=d["b_l"])
    return Schedule(d["worker_o"], d["worker_s"], d["worker_l"], d["m_s"],
                    d["m_l"], d["b_o"], d["b_s"], d["b_l"])


def _prof_arrays(p) -> Dict[str, np.ndarray]:
    return {"L_f": np.asarray(p.L_f), "L_b": np.asarray(p.L_b),
            "L_u": np.asarray(p.L_u)}


def _profile_from_arrays(template, worker_names, arrays):
    """Rebuild a profile from checkpointed timing rows.  The per-layer
    columns (MP/MO/MG/sample_bytes) are hardware-membership invariant, so
    they come from the caller's template; the per-worker rows and (for a
    star) the membership come from the checkpoint.  A tree template gives
    a tree profile (its ``n_edges`` and ``cloud_speedup``), so a re-solve
    after a restore plans a tree."""
    if worker_names is None:
        return HierProfile(
            layer_names=template.layer_names, L_f=arrays["L_f"],
            L_b=arrays["L_b"], L_u=arrays["L_u"], MP=template.MP,
            MO=template.MO, sample_bytes=template.sample_bytes,
            MG=template.MG)
    common = dict(
        layer_names=template.layer_names, worker_names=tuple(worker_names),
        L_f=arrays["L_f"], L_b=arrays["L_b"], L_u=arrays["L_u"],
        MP=template.MP, MO=template.MO,
        sample_bytes=template.sample_bytes, MG=template.MG)
    if isinstance(template, TreeProfile):
        return TreeProfile(n_edges=template.n_edges,
                           cloud_speedup=template.cloud_speedup, **common)
    return MultiProfile(**common)


def _ema_profile_update(prof, baseline, slow: Dict[str, float],
                        worker_names, ema: float) -> None:
    """EMA every worker toward its *currently observed* speed.

    Workers absent from ``slow`` decay toward the baseline profile
    (factor 1.0) — this is what lets a healed straggler recover.  The
    profile's cached prefix sums are dropped, so the next solve sees the
    new rows.
    """
    for i, w in enumerate(worker_names):
        factor = slow.get(w, 1.0)
        for name in ("L_f", "L_b", "L_u"):
            cur = getattr(prof, name)
            target = getattr(baseline, name)[i] * factor
            cur[i] = (1 - ema) * cur[i] + ema * target
    if hasattr(prof, "_prefix"):
        del prof._prefix


def _loop_ops(topology: str, model, profile, net, cfg: HierLoopConfig):
    """Topology-native function bundle for :func:`_run_loop`.  History
    formats are per topology: the triple records scalar ``m_s`` and a
    3-tuple ``b``, the star and the tree record the ``m_s`` tuple and an
    (M+2)-tuple ``b``.  ``model`` is used only by ``step``."""
    if topology == "triple":
        return dict(
            names=WORKERS,
            widx={w: i for i, w in enumerate(WORKERS)},
            solve=lambda p, warm=None: scheduler._solve_3w(
                p, net, cfg.batch, objective=cfg.objective,
                warm_start=warm),
            fill=lambda p, s: _t_total(p, net, s).total,
            period=lambda p, s: t_period(p, net, s),
            step=lambda params, x, y, s: hybrid_step_from_schedule(
                model, params, x, y, s, cfg.lr, wire=cfg.wire),
            hist=lambda s: {"m_s": s.m_s, "m_l": s.m_l,
                            "b": (s.b_o, s.b_s, s.b_l)},
            tag="hier",
        )
    assert topology in ("star", "tree"), topology
    # The tree step pre-merges each edge's same-cut streams; the
    # stream→edge map depends on the live schedule, so it is re-derived
    # from each step's schedule.  Straggler EMAs are already per-edge: every edge server
    # is its own row of ``worker_names``.
    run = tree_schedule_step(profile, net) if topology == "tree" \
        else multi_hybrid_step_from_schedule
    return dict(
        names=profile.worker_names,
        widx=profile.widx,
        solve=lambda p, warm=None: scheduler._solve_multi(
            p, net, cfg.batch, objective=cfg.objective, warm_start=warm),
        fill=lambda p, s: _t_total_multi(p, net, s).total,
        period=lambda p, s: t_period_multi(p, net, s),
        step=lambda params, x, y, s: run(model, params, x, y, s, cfg.lr,
                                         wire=cfg.wire),
        hist=lambda s: {"m_s": s.m_s, "m_l": s.m_l,
                        "b": (s.b_o, *s.b_s, s.b_l)},
        tag="tree-hier" if topology == "tree" else "multi-hier",
    )


class _Planner:
    """The loop's numpy half: fleet membership, the straggler EMA,
    re-solves and the simulated wall clock.  :func:`_run_loop` calls
    :meth:`advance` at the top of every step and runs the step on
    :attr:`sched`; :func:`replay` calls it with no step at all, and gets
    the same schedules and walls (the wall clock is a pure function of
    the cost model)."""

    def __init__(self, cfg: HierLoopConfig, model, profile, net, *,
                 topology: str, initial_schedule=None, churn=None):
        if churn is not None and topology != "star":
            raise ValueError(
                "churn is native to the star topology: membership is a "
                "property of the M-device fleet; the paper's fixed "
                "three-worker triple has no notion of join/leave "
                "(use Fleet.from_table2() or topology='star')")
        self.cfg, self.model, self.template = cfg, model, profile
        self.topology, self.churn = topology, churn
        self.net = net
        self.ops = _loop_ops(topology, model, profile, net, cfg)
        self.prof = copy.deepcopy(profile)
        # Baseline for the straggler EMA and the simulated "true" speeds;
        # membership-edited alongside ``prof`` under churn.
        self.base_prof = copy.deepcopy(profile)
        self.ref = reference_rows(self.base_prof) if churn is not None \
            else None
        # The solver is a pure function of the profile values, so a
        # caller that already planned this exact (profile, net, B,
        # objective) — Plan.train — seeds the loop and skips the solve.
        self.sched = initial_schedule if initial_schedule is not None \
            else self.ops["solve"](self.prof).schedule
        self.wall = 0.0
        self.churn_log: List[Dict[str, Any]] = []

    @property
    def is_star(self) -> bool:
        return self.topology == "star"

    def advance(self, step: int,
                worker_slowdown: Optional[Callable[[int], Dict[str, float]]]
                ) -> None:
        """Apply step ``step``'s churn events, straggler EMA and re-solve,
        and charge its simulated time to :attr:`wall`."""
        cfg, ops = self.cfg, self.ops
        prev_sched = self.sched
        events = self.churn.events_at(step) if self.churn is not None \
            else ()
        if events:
            # A crash kills the in-flight attempt: survivors discover it
            # at the barrier after ~one fill of the pre-crash schedule
            # at baseline speeds, then re-run the step on the new fleet.
            lost = ops["fill"](self.base_prof, self.sched) \
                if any(isinstance(e, DeviceCrash) for e in events) \
                else 0.0
            self.wall += lost
            for ev in events:
                self.prof, self.base_prof, self.net, _ = apply_event(
                    self.prof, self.base_prof, self.net, self.ref, ev)
            # ops closures capture (membership, net) — rebuild on churn
            ops = self.ops = _loop_ops(self.topology, self.model, self.prof,
                                       self.net, cfg)
            warm = remap_schedule(self.sched, self.prof)
            t0 = time.perf_counter()
            res = ops["solve"](self.prof, warm)
            resolve_s = time.perf_counter() - t0
            self.sched = res.schedule
            self.churn_log.append({
                "step": step,
                "events": [f"{type(e).__name__}:{e.name}"
                           for e in events],
                "m": len(ops["names"]) - 2,
                "warm": warm is not None, "lost_s": lost,
                "resolve_s": resolve_s, "n_pruned": res.n_pruned,
                "n_candidates": res.n_candidates})
        slow = worker_slowdown(step) if worker_slowdown else {}
        if worker_slowdown is not None and step > 0 and \
                step % cfg.resched_every == 0:
            _ema_profile_update(self.prof, self.base_prof, slow,
                                ops["names"], cfg.ema)
            self.sched = ops["solve"](self.prof, self.sched).schedule
        # timing from the cost model under the *actual* current speeds
        true_prof = copy.deepcopy(self.base_prof)
        widx = ops["widx"]
        for w, factor in (slow or {}).items():
            if w not in widx:   # straggler report for a departed device
                continue
            i = widx[w]
            true_prof.L_f[i] *= factor
            true_prof.L_b[i] *= factor
            true_prof.L_u[i] *= factor
        if hasattr(true_prof, "_prefix"):   # deepcopy carries the cache
            del true_prof._prefix
        if cfg.pipeline_depth > 1 and step % cfg.pipeline_depth != 0 \
                and self.sched == prev_sched:
            self.wall += ops["period"](true_prof, self.sched)
        else:   # window head or pipe broken by a re-schedule: pay fill
            self.wall += ops["fill"](true_prof, self.sched)

    # ---- checkpoint state ------------------------------------------------

    def like(self, extra: Dict[str, Any]) -> Dict[str, Any]:
        """Zero grids in the shape of the checkpointed profile rows."""
        cols = np.asarray(self.template.L_f).shape[1]
        rows = len(extra["worker_names"]) if self.is_star \
            else np.asarray(self.template.L_f).shape[0]

        def grid():
            return {k: np.zeros((rows, cols)) for k in ("L_f", "L_b", "L_u")}

        like = {"prof": grid()}
        if self.is_star:
            like["base"] = grid()
            like["ref"] = {k: np.zeros(cols) for k in ("L_f", "L_b", "L_u")}
        return like

    def state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(arrays, extra)`` to checkpoint: the profile rows, the
        schedule, the wall clock and (star) the membership."""
        tree = {"prof": _prof_arrays(self.prof)}
        extra = {"wall": self.wall, "topology": self.topology,
                 "sched": _sched_to_json(self.sched)}
        if self.is_star:
            base = self.base_prof
            rows = self.ref if self.ref is not None else (
                np.asarray(base.L_f[0]), np.asarray(base.L_b[0]),
                np.asarray(base.L_u[0]))
            tree["base"] = _prof_arrays(base)
            tree["ref"] = {"L_f": np.asarray(rows[0]),
                           "L_b": np.asarray(rows[1]),
                           "L_u": np.asarray(rows[2])}
            extra["worker_names"] = list(self.prof.worker_names)
            extra["bw_de"] = [float(v) for v in np.asarray(self.net.bw_de)]
            extra["bw_ec"] = float(self.net.bw_ec)
        return tree, extra

    def restore(self, tree: Dict[str, Any], extra: Dict[str, Any]) -> None:
        self.wall = float(extra["wall"])
        self.sched = _sched_from_json(extra["sched"])
        # Star membership may have churned, so names come from the
        # checkpoint; tree and triple fleets have fixed membership and
        # rebuild from the caller's template.
        names = tuple(extra["worker_names"]) if self.is_star else (
            self.template.worker_names if self.topology == "tree" else None)
        self.prof = _profile_from_arrays(self.template, names, tree["prof"])
        if self.is_star:
            self.base_prof = _profile_from_arrays(self.template, names,
                                                  tree["base"])
            self.net = StarNetwork(
                bw_de=np.asarray(extra["bw_de"], dtype=np.float64),
                bw_ec=float(extra["bw_ec"]))
            self.ref = (np.asarray(tree["ref"]["L_f"]),
                        np.asarray(tree["ref"]["L_b"]),
                        np.asarray(tree["ref"]["L_u"]))
        self.ops = _loop_ops(self.topology, self.model, self.prof, self.net,
                             self.cfg)


def replay(cfg: HierLoopConfig, profile, net,
           worker_slowdown: Optional[Callable[[int], Dict[str, float]]]
           = None, *, topology: str, initial_schedule=None, churn=None
           ) -> List[Dict[str, Any]]:
    """The schedules and simulated walls of a ``cfg.total_steps`` run,
    from the loop's planning alone: no model, no step executed.  Each
    entry is ``{"step", "wall", "sched"}`` as in :func:`_run_loop`'s
    history."""
    planner = _Planner(cfg, None, profile, net, topology=topology,
                       initial_schedule=initial_schedule, churn=churn)
    out = []
    for step in range(cfg.total_steps):
        planner.advance(step, worker_slowdown)
        out.append({"step": step + 1, "wall": planner.wall,
                    "sched": planner.sched})
    return out


def _run_loop(cfg: HierLoopConfig, model, profile, net, data,
              worker_slowdown: Optional[Callable[[int], Dict[str, float]]]
              = None, log: Optional[Callable[[str], None]] = None, *,
              topology: str, device: torch.device, initial_schedule=None,
              churn=None) -> Dict[str, Any]:
    """Train a layer stack under the HierTrain schedule, re-solving the
    schedule online as (simulated) worker speeds drift — the engine
    behind :meth:`repro_torch.api.Plan.train` on every topology.

    ``model`` is a :class:`~repro_torch.core.layerstack.LayerStack`;
    ``data.batch(step)`` must return ``{"x", "labels"}`` arrays (numpy or
    tensors) whose leading axis is the sample axis; they are moved to
    ``device``, where the params live.

    ``worker_slowdown(step)`` returns per-worker-name slowdown factors —
    the straggler injection used by tests/benchmarks.  Timing is
    simulated with the calibrated cost model; the numerics are the real
    hybrid step.  Re-scheduling is gated on cadence alone (every
    ``resched_every`` steps): each tick EMAs *every* worker toward its
    observed speed, so a healed straggler decays back to the baseline
    profile and the loop returns to the pre-straggle schedule.

    With ``cfg.pipeline_depth = K > 1`` the wall clock models pipelined
    steady-state execution (DESIGN.md §7): the first step of each
    K-window pays the Eq.-12 fill latency and the remaining ``K - 1``
    pay one ``t_period`` each — and a re-schedule that changes the
    schedule breaks the pipe, so the fill is re-paid at that step.

    **Elastic fleets** (DESIGN.md §10, star only): ``churn`` is a
    :class:`~repro_torch.core.churn.ChurnTrace`.  Events pinned to step
    ``s`` apply at the top of step ``s``; a membership change remaps the
    live schedule onto the survivors and re-solves with it as a warm
    incumbent, a crash also charges the lost in-flight fill, and a join
    seeds the newcomer's rows from the fleet's reference tier.  Measured
    solver seconds land only in ``churn_log``: the simulated ``wall``
    stays a pure function of (cost model, trace, seed).

    **Crash-safe resume**: with ``cfg.ckpt_dir`` set, every
    ``cfg.ckpt_every`` steps the loop atomically checkpoints params, the
    EMA'd and baseline profiles, the reference rows, the schedule, the
    network, the simulated wall clock and the step.  On start it
    restores the newest readable checkpoint and continues, bitwise equal
    to an uninterrupted run from the resume step on (``history`` then
    covers only the resumed tail; ``resumed_from`` records the step).
    ``cfg.fail_at`` injects a failure after that step completes (after
    its checkpoint) to exercise the path.
    """
    planner = _Planner(cfg, model, profile, net, topology=topology,
                       initial_schedule=initial_schedule, churn=churn)
    params = model.init(
        torch.Generator(device=device).manual_seed(cfg.seed), device)
    start = 0
    resumed_from = None

    manager = CheckpointManager(cfg.ckpt_dir, cfg.keep) \
        if cfg.ckpt_dir and cfg.ckpt_every else None
    if manager is not None:
        def _like(ckpt_step, extra):
            if extra.get("seed") != cfg.seed:
                raise ValueError(
                    f"checkpoint seed {extra.get('seed')} does not "
                    f"match cfg.seed {cfg.seed}: refusing to resume a "
                    "different run")
            # The freshly initialised params give the structure and the
            # device; the restored leaves replace them.
            return {"params": params, **planner.like(extra)}

        ckpt_step, tree, extra = manager.restore_latest_with(_like)
        if ckpt_step is not None:
            start = resumed_from = ckpt_step
            params = tree["params"]
            planner.restore(tree, extra)

    history = []
    for step in range(start, cfg.total_steps):
        planner.advance(step, worker_slowdown)
        sched = planner.sched
        b = data.batch(step)
        x = torch.as_tensor(b["x"], device=device)
        y = torch.as_tensor(b["labels"], device=device)
        params, loss = planner.ops["step"](params, x, y, sched)
        loss = float(loss)
        if log and (step + 1) % 10 == 0:
            log(f"{planner.ops['tag']} step {step+1}: loss={loss:.4f} "
                f"sched=({sched.describe()}) wall={planner.wall:.2f}s")
        history.append({"step": step + 1, "loss": loss,
                        "wall": planner.wall, **planner.ops["hist"](sched),
                        "sched": sched})
        if manager is not None and (step + 1) % cfg.ckpt_every == 0:
            tree, extra = planner.state()
            tree["params"] = params
            extra.update(step=step + 1, seed=cfg.seed)
            manager.save(step + 1, tree, extra=extra)
        if cfg.fail_at is not None and step + 1 == cfg.fail_at:
            raise InjectedFailure(
                f"injected failure after step {step+1}")
    return {"params": params, "history": history, "wall": planner.wall,
            "final_schedule": planner.sched, "resumed_from": resumed_from,
            "churn_log": planner.churn_log}
