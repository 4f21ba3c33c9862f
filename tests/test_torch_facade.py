"""The port's numpy facade against the JAX package's: ``simulate``,
``baseline``, ``explain``, the CLI and the planner service.

All of it is numpy on both sides, fed the same cut meta, so every number
and string is held ``==``:

* ``Plan.simulate(1)``, ``Plan.simulate(K)``, ``Plan.baseline`` for the
  three tiers and ``Plan.explain()`` over lenet5 / alexnet x the triple,
  M=2 and M=4 stars and E=1 and E=2 trees x both wires (and a pipelined
  plan, whose ``explain`` adds a line);
* ``python -m repro_torch.api --explain ...`` prints what
  ``python -m repro.api --explain ...`` prints (``capsys``), the ``lm``
  config included;
* ``plan_many``'s plans, ``fingerprint`` keys and ``synthetic_population``
  are ``==`` to ``repro.serve``'s; the plan cache's hit / alias /
  eviction counters, exact re-scoring, the admission loop and the bench
  entry behave as tests/test_planner.py pins them for the reference.
* chip_smoke.py's AlexNet paths (numpy only): the star, triple and
  fig_tree plans and their loops' schedules cross the wire at the rows
  its quantizer phase derives and holds bitwise, and its E=2 straggler
  moves the schedule and lets it come back.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.models import cnn as jcnn
from repro.serve import planner as jplanner
from repro.serve import population as jpopulation
from repro_torch.models import cnn as tcnn
from repro_torch.serve import planner as tplanner
from repro_torch.serve import population as tpopulation
from repro_torch.train import loop
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

FLEETS = {
    "triple": dict(m=1),
    "star2": dict(m=2),
    "star4": dict(m=4),
    "tree_e1": dict(m=2, topology="tree", n_edges=1),
    "tree_e2": dict(m=4, topology="tree", n_edges=2),
}


def plan_pair(name: str, fleet: str, wire: str, **kw):
    return (japi.plan(getattr(jcnn, name)(), japi.Fleet.from_table2(
                name, wire=wire, **FLEETS[fleet]), 64, **kw),
            tapi.plan(getattr(tcnn, name)(), tapi.Fleet.from_table2(
                name, wire=wire, **FLEETS[fleet]), 64, **kw))


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("name", ["lenet5", "alexnet"])
def test_facade_equals_jax(name, fleet, wire):
    jp, tp = plan_pair(name, fleet, wire)
    assert tp.fleet.topology == jp.fleet.topology
    assert repr(tp.schedule) == repr(jp.schedule)
    assert tp.simulate() == jp.simulate()
    assert tp.simulate(K=3) == jp.simulate(K=3)
    for tier in ("device", "edge", "cloud"):
        assert tp.baseline(tier) == jp.baseline(tier)
    assert tp.explain() == jp.explain()
    if tp.fleet.topology == "tree":
        assert tp.stream_edges() == jp.stream_edges()


@pytest.mark.parametrize("objective", ["latency", "throughput"])
def test_pipelined_explain_equals_jax(objective):
    jp, tp = plan_pair("lenet5", "tree_e2", "int8", objective=objective,
                       pipeline_depth=4)
    assert "pipelined: T(K=4)" in tp.explain()
    assert tp.explain() == jp.explain()
    assert tp.pipeline_time() == jp.pipeline_time()


def test_baseline_rejects_an_unknown_tier():
    _, tp = plan_pair("lenet5", "star2", "none")
    with pytest.raises(ValueError, match="unknown baseline tier"):
        tp.baseline("fog")


def test_profile_only_plan_explains_as_jax():
    jp, _ = plan_pair("lenet5", "star2", "none")
    from repro_torch.core.cost_model import MultiProfile, StarNetwork
    prof = MultiProfile(**{f: getattr(jp.profile, f) for f in (
        "layer_names", "worker_names", "L_f", "L_b", "L_u", "MP", "MO",
        "sample_bytes", "MG")})
    net = StarNetwork(bw_de=jp.network.bw_de, bw_ec=jp.network.bw_ec)
    tp = tapi.plan(None, tapi.Fleet.from_profile(prof, net), 64)
    want = japi.plan(None, japi.Fleet.from_profile(jp.profile, jp.network),
                     64)
    assert "model=(profile)" in tp.explain()
    assert tp.explain() == want.explain()
    assert tp.simulate() == want.simulate()


CLI_ARGS = [
    "--explain lenet5",
    "--explain lenet5 --m 2 --batch 32",
    "--explain alexnet --m 4 --wire int8",
    "--explain alexnet --m 4 --topology tree --edges 2 --wire int8",
    "--explain lenet5 --m 2 --topology tree --edges 1",
    "--explain lenet5 --m 3 --objective throughput --pipeline-depth 3",
    "--explain alexnet --edge-cloud-mbps 2 --topology star",
    "--explain lm --m 2",
]


@pytest.mark.parametrize("args", CLI_ARGS)
def test_cli_prints_what_the_reference_prints(args, capsys):
    assert japi.main(args.split()) == 0
    want = capsys.readouterr().out
    assert tapi.main(args.split()) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "simulated (DES)" in got


def test_cli_rejects_what_the_reference_rejects():
    for args in ("--explain vgg", "--explain lm --topology triple"):
        with pytest.raises(SystemExit) as want:
            japi.main(args.split())
        with pytest.raises(SystemExit) as got:
            tapi.main(args.split())
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The planner service
# ---------------------------------------------------------------------------


def fp_pair(jreq, treq):
    _, jprof, jnet, jwire = japi._prepare(jreq.model, jreq.fleet, jreq.wire)
    _, tprof, tnet, twire = tapi._prepare(treq.model, treq.fleet, treq.wire)
    return (jplanner.fingerprint(jprof, jnet, jreq.B, jreq.objective, jwire),
            tplanner.fingerprint(tprof, tnet, treq.B, treq.objective, twire))


def test_population_equals_jax():
    jreqs = jpopulation.synthetic_population(n=40, seed=3)
    treqs = tpopulation.synthetic_population(n=40, seed=3)
    assert tpopulation.family_counts(40) == jpopulation.family_counts(40)
    assert [(r.tag, r.B, r.objective, r.wire) for r in treqs] == \
        [(r.tag, r.B, r.objective, r.wire) for r in jreqs]
    for j, t in zip(jreqs, treqs):
        jprof, tprof = j.fleet._profile, t.fleet._profile
        assert type(tprof).__name__ == type(jprof).__name__
        for f in ("L_f", "L_b", "L_u", "MP", "MO", "MG"):
            np.testing.assert_array_equal(getattr(tprof, f),
                                          getattr(jprof, f))
        assert tprof.sample_bytes == jprof.sample_bytes
        np.testing.assert_array_equal(t.fleet.network().bw_de,
                                      j.fleet.network().bw_de)
        np.testing.assert_array_equal(t.fleet.network().bw_ec,
                                      j.fleet.network().bw_ec)


def test_fingerprints_equal_jax():
    for jreq, treq in zip(jpopulation.synthetic_population(n=24, seed=5),
                          tpopulation.synthetic_population(n=24, seed=5)):
        jfp, tfp = fp_pair(jreq, treq)
        assert tfp == jfp
    for e, wire in ((1, "none"), (2, "int8")):
        jreq = jplanner.PlanRequest(
            fleet=japi.Fleet.from_table2("lenet5", m=4, n_edges=e,
                                         topology="tree"),
            B=64, model=jcnn.lenet5(), wire=wire)
        treq = tplanner.PlanRequest(
            fleet=tapi.Fleet.from_table2("lenet5", m=4, n_edges=e,
                                         topology="tree"),
            B=64, model=tcnn.lenet5(), wire=wire)
        jfp, tfp = fp_pair(jreq, treq)
        assert tfp == jfp
    assert np.array_equal(tplanner.quantize([0.0, -1.0, 3.7e-3, 250.0]),
                          jplanner.quantize([0.0, -1.0, 3.7e-3, 250.0]))


def test_fingerprint_near_miss_separates():
    req = tpopulation.synthetic_population(n=8, seed=7)[0]
    _, prof, net, wire = tapi._prepare(None, req.fleet, None)
    base = tplanner.fingerprint(prof, net, req.B)
    bumped = dataclasses.replace(prof, L_f=prof.L_f * (1 + 8 * tplanner.Q_REL))
    assert tplanner.fingerprint(bumped, net, req.B) != base
    assert tplanner.fingerprint(prof, net, req.B + 1) != base
    assert tplanner.fingerprint(prof, net, req.B, "throughput") != base
    nudged = dataclasses.replace(prof, L_f=prof.L_f * (1 + 1e-7))
    assert tplanner.fingerprint(nudged, net, req.B) == base
    assert tplanner.fingerprint(nudged, net, req.B, exact=True) != \
        tplanner.fingerprint(prof, net, req.B, exact=True)


def assert_plans_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert repr(g.schedule) == repr(w.schedule)
        assert g.t_total == w.t_total
        assert g.t_period == w.t_period
        assert repr(g.breakdown) == repr(w.breakdown)
        assert g.result.search_log == w.result.search_log


def test_plan_many_equals_jax():
    jreqs = jpopulation.synthetic_population(n=32, seed=0)
    treqs = tpopulation.synthetic_population(n=32, seed=0)
    jpl, tpl = jplanner.Planner(), tplanner.Planner()
    want, got = jpl.plan_many(jreqs), tpl.plan_many(treqs)
    assert all(isinstance(p, tapi.Plan) for p in got)
    assert_plans_equal(got, want)
    js, ts = jpl.stats(), tpl.stats()
    assert ts == js


def test_api_plan_many_on_the_default_planner():
    tplanner.clear_plan_cache()
    reqs = tpopulation.synthetic_population(n=8, seed=0)[:2]
    plans = tapi.plan_many(reqs)
    assert len(plans) == 2 and tplanner._DEFAULT_PLANNER.misses >= 1
    for r, p in zip(reqs, plans):
        ref = tapi.plan(r.model, r.fleet, r.B, objective=r.objective)
        assert p.result.schedule == ref.result.schedule
        assert p.result.t_total == ref.result.t_total
        assert p.result.t_period == ref.result.t_period
    tplanner.clear_plan_cache()
    assert len(tplanner._DEFAULT_PLANNER) == 0


def _classes(reqs, k):
    out, seen = [], set()
    for r in reqs:
        cls = r.tag.rsplit("/", 1)[0]
        if cls not in seen:
            seen.add(cls)
            out.append(r)
        if len(out) == k:
            return out
    raise AssertionError(f"population has < {k} classes")


def test_cache_hits_aliases_and_eviction():
    reqs = tpopulation.synthetic_population(n=64, seed=1)
    distinct = _classes(reqs, 3)
    planner = tplanner.Planner(cache_size=2)
    planner.plan_many([distinct[0], distinct[0]])   # miss + in-flight alias
    assert (planner.hits, planner.misses) == (1, 1)
    assert len(planner) == 1
    planner.plan_many([distinct[0]])                # warm hit
    assert (planner.hits, planner.misses) == (2, 1)
    planner.plan_many([distinct[1], distinct[2]])   # overflows size-2 LRU
    assert planner.evictions == 1
    assert len(planner) == 2
    st = planner.stats()
    assert st["evictions"] == 1 and st["hit_rate"] == pytest.approx(2 / 5)
    planner.clear()
    assert len(planner) == 0 and planner.hits == 0
    assert planner.stats()["lp_calls"] == 0


def test_cache_hit_is_rescored_not_copied():
    reqs = tpopulation.synthetic_population(n=64, seed=1)
    r = _classes(reqs, 1)[0]
    twin = [q for q in reqs
            if q.tag.rsplit("/", 1)[0] == r.tag.rsplit("/", 1)[0]][1]
    p0, p1 = tplanner.Planner().plan_many([r, twin])
    assert p1.result.schedule == p0.result.schedule
    assert p1.result.t_total == p0.result.t_total
    assert p1.result.search_log == []


def test_admission_loop_submit_drain():
    reqs = tpopulation.synthetic_population(n=8, seed=0)
    planner = tplanner.Planner(max_batch=2)
    for r in reqs:
        planner.submit(r)
    plans = planner.drain()
    assert planner.drain() == []
    assert_plans_equal(plans, tplanner.Planner().plan_many(reqs))


def test_bench_entry_smoke(capsys):
    rc = tplanner.main(["--bench", "--n", "32", "--seed", "0",
                        "--assert-hit-rate"])
    assert rc == 0
    assert "plans/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# chip_smoke.py's tree paths
# ---------------------------------------------------------------------------


def test_chip_smoke_tree_slowdown_moves_and_restores():
    """chip_smoke.py's straggler on the fig_tree E=2 AlexNet plan (numpy
    only): the schedule changes at a re-solve and is back by the last
    step, and the checkpoint it resumes from lies inside the window."""
    import chip_smoke
    p = tapi.plan(tcnn.alexnet(), chip_smoke.tree_fleet(tapi, 2),
                  chip_smoke.B)
    got = loop.replay(chip_smoke.train_config(loop, p), p.profile,
                      p.network, chip_smoke.train_slowdown("tree E=2"),
                      topology="tree", initial_schedule=p.schedule)
    scheds = [r["sched"] for r in got]
    assert len(got) == chip_smoke.TRAIN_STEPS
    assert any(a != b for a, b in zip(scheds, scheds[1:]))
    assert scheds[-1] == p.schedule


def test_chip_smoke_tree_plans_cross_five_streams_at_its_wire_rows():
    """Every AlexNet path of chip_smoke.py (the M=1 and M=4 plans, the
    E=1, E=2 and E=4 fig_tree plans, and every schedule of the M=1, M=4
    and E=2 loops' replays) crosses the wire at exactly the rows
    ``chip_smoke.alexnet_wire_rows`` derives, and its quantizer phase
    holds each of them bitwise.  The E=2 and E=4 plans quantize 10 times
    a step (five streams carry samples past cut > 0), the E=1 plan 8
    times (its 31-row stream included)."""
    import chip_smoke

    def rows(s):
        return {b for m, b in zip(s.m_s, s.b_s) if m and b} | \
            ({s.b_l} if s.m_l and s.b_l else set())

    want, per_step = set(), {}
    # (fleet, the straggler of its Plan.train path, or None)
    paths = [(tapi.Fleet.from_table2("alexnet", m=m, wire="int8"), m)
             for m in (1, 4)]
    paths += [(chip_smoke.tree_fleet(tapi, e), "tree E=2" if e == 2
               else None) for e in (1, 2, 4)]
    for fleet, slow in paths:
        p = tapi.plan(tcnn.alexnet(), fleet, chip_smoke.B)
        want |= rows(p.multi_schedule)
        if fleet.topology == "tree":
            per_step[fleet.num_edges] = 2 * chip_smoke.crossings(
                p.multi_schedule)
        if slow is not None:
            for r in loop.replay(chip_smoke.train_config(loop, p), p.profile,
                                 p.network, chip_smoke.train_slowdown(slow),
                                 topology=fleet.topology,
                                 initial_schedule=p.schedule):
                want |= rows(chip_smoke.as_multi(tapi, r["sched"]))
    assert per_step == {1: 8, 2: 10, 4: 10}
    got = chip_smoke.alexnet_wire_rows(tapi, loop, tcnn)
    assert set(got) == want == {39, 38, 35, 34, 33, 31, 14, 13, 12, 11, 8,
                                6, 5, 4, 3, 2}
    cases = chip_smoke.quant_cases(torch, "cpu",
                                   torch.Generator().manual_seed(0), got)
    held = {x.shape[0] for _, x, u in cases
            if x.shape[1] == chip_smoke.WIRE_SHAPE_N
            and x.dtype == torch.float32}
    assert held == want
