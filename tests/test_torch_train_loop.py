"""The port's ``Plan.train`` against ``repro.api.Plan.train``: planning,
resume and the profiler.

* Planning is numpy on both sides, so the history's schedules (by
  ``repr``), simulated walls, ``final_schedule`` and ``churn_log`` are
  ``==`` to JAX's: tiny_mlp and lenet5 on the triple and M=2 / M=4
  stars, with a straggler (the plan's TASK-O worker slowed 30x over
  steps [2, 10)) that moves the schedule, at ``pipeline_depth`` 1 and 3.
* The numerics start from the same weights: the port stack's ``init``
  returns the JAX init (a test-only monkeypatch), and with
  ``wire="none"`` each step's loss is within rel 1e-5 and the final
  params within rtol 5e-5 / atol 1e-6 (tests/test_torch_hybrid_step.py).
  The int8 wire and the LM stack are in tests/test_torch_train_int8_lm.py.
* Kill/resume in the port is bitwise (triple and star, ``fail_at`` 4 and
  10, as tests/test_train_loop.py), and a run resumed by the port from a
  checkpoint that ``repro`` wrote mid-straggle continues with JAX's
  schedules and walls.
* ``replay`` (the loop's planning with no step) gives the loop's
  schedules and walls, also under churn; chip_smoke.py's stragglers move
  the AlexNet schedules and let them come back.
* ``measure_profile`` has the reference's layers, ``MP``/``MO``/``MG``,
  ``sample_bytes`` and ``L_u``, and positive finite ``L_f``/``L_b``.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import cost_model as jcm
from repro.core.profiler import analytic_profile as j_analytic
from repro.core.profiler import measure_profile as j_measure
from repro.data.pipeline import SyntheticImages as JImages
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core.churn import poisson_trace
from repro_torch.core.profiler import analytic_profile, measure_profile
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.train import loop
from tests.test_torch_cnn import model_pair
from tests.test_torch_hybrid_step import NONE_TOL
from tests.test_torch_lm import flat
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

B = 24
STEPS = 12
SLOW_WINDOW = (2, 10)


@functools.lru_cache(maxsize=None)
def models(name: str):
    """(JAX model, port model), one pair per name for the whole file, so
    JAX's cached compiled steps are reused across cases."""
    return model_pair(name)


@functools.lru_cache(maxsize=None)
def jax_init(name: str, seed: int):
    jm, _ = models(name)
    return jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def fleets(name: str, m: int, wire: str = "none"):
    table = "alexnet" if name.startswith("alexnet") else "lenet5"
    return (japi.Fleet.from_table2(table, m=m, wire=wire),
            tapi.Fleet.from_table2(table, m=m, wire=wire))


def data_pair(model, seed: int = 0):
    args = (model.input_shape, model.num_classes, B, seed)
    return JImages(*args), SyntheticImages(*args)


def slowdown(worker: str, factor: float = 30.0, window=SLOW_WINDOW):
    lo, hi = window
    return lambda step: {worker: factor} if lo <= step < hi else {}


def port_plan(monkeypatch, plan, init_np):
    """The port plan with its stack's ``init`` returning ``init_np``."""
    monkeypatch.setattr(plan.model, "init",
                        lambda gen, dev: params_from_numpy(init_np, dev))
    return plan


def history_key(out):
    return [(h["step"], repr(h["sched"]), h["wall"], h["m_s"], h["m_l"],
             h["b"]) for h in out["history"]]


def assert_plans_equal(got, want):
    assert history_key(got) == history_key(want)
    assert repr(got["final_schedule"]) == repr(want["final_schedule"])
    assert got["wall"] == want["wall"]
    assert got["resumed_from"] == want["resumed_from"]
    assert [{k: v for k, v in e.items() if k != "resolve_s"}
            for e in got["churn_log"]] == \
        [{k: v for k, v in e.items() if k != "resolve_s"}
         for e in want["churn_log"]]


def assert_params_close(got, want, **tol):
    for pt, pj in zip(got, want):
        for a, b in zip(flat(pt), jax.tree.leaves(pj)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)


def same_params(a, b) -> bool:
    return all(torch.equal(x, y) for p, q in zip(a, b)
               for x, y in zip(flat(p), flat(q)))


def changes(out) -> int:
    h = out["history"]
    return sum(a["sched"] != b["sched"] for a, b in zip(h, h[1:]))


# ---------------------------------------------------------------------------
# Plan.train against repro.api.Plan.train
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("name", ["tiny_mlp", "lenet5"])
def test_train_matches_jax(monkeypatch, name, m, depth):
    jm, tm = models(name)
    jfleet, tfleet = fleets(name, m)
    jp = japi.plan(jm, jfleet, B, pipeline_depth=depth)
    tp = port_plan(monkeypatch, tapi.plan(tm, tfleet, B,
                                          pipeline_depth=depth),
                   jax_init(name, 3))
    assert repr(tp.schedule) == repr(jp.schedule)
    jdata, tdata = data_pair(tm)
    kw = dict(steps=STEPS, lr=0.05, resched_every=4, ema=0.8, seed=3,
              worker_slowdown=slowdown(tp.schedule.worker_o))
    want = jp.train(jdata, **kw)
    got = tp.train(tdata, device="cpu", **kw)
    assert changes(got) >= 1, "the straggler never moved the schedule"
    assert_plans_equal(got, want)
    for a, b in zip(got["history"], want["history"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    assert_params_close(got["params"], want["params"], **NONE_TOL)


# ---------------------------------------------------------------------------
# Crash-safe resume
# ---------------------------------------------------------------------------


def _tiny_fleet(mod, topology: str):
    """The kill/resume fleets of tests/test_train_loop.py, in either
    package (``mod`` is ``japi`` or ``tapi``)."""
    jm, tm = models("tiny_mlp")
    if mod is japi:
        cm, model = jcm, jm
        from repro.core import profiler as prof_mod
    else:
        cm, model = tcm, tm
        from repro_torch.core import profiler as prof_mod
    if topology == "triple":
        return mod.Fleet.from_profile(prof_mod.analytic_profile(model),
                                      cm.Network(bw_de=5e6 / 8,
                                                 bw_ec=1e6 / 8)), 16
    return mod.Fleet.from_profile(
        prof_mod.multi_analytic_profile(model, device_slowdowns=(1.0, 1.2)),
        cm.StarNetwork(bw_de=np.array([4.0, 3.0]) * 1e6 / 8,
                       bw_ec=2.0 * 1e6 / 8)), 24


RESUME_SLOW = {"triple": ("edge", 6.0), "star": ("cloud", 30.0)}


def _resume_kw(topology: str):
    worker, factor = RESUME_SLOW[topology]
    return dict(steps=14, lr=0.05, resched_every=4, ema=0.8, seed=3,
                worker_slowdown=slowdown(worker, factor, (2, 12)))


@pytest.mark.parametrize("fail_at", [4, 10])
@pytest.mark.parametrize("topology", ["triple", "star"])
def test_kill_resume_bitwise(tmp_path, topology, fail_at):
    _, tm = models("tiny_mlp")
    fleet, b = _tiny_fleet(tapi, topology)
    data = SyntheticImages(tm.input_shape, tm.num_classes, b, seed=0)
    kw = dict(_resume_kw(topology), device="cpu")
    ref = tapi.plan(tm, fleet, b).train(data, **kw)
    with pytest.raises(loop.InjectedFailure):
        tapi.plan(tm, fleet, b).train(data, ckpt_dir=str(tmp_path),
                                      ckpt_every=3, fail_at=fail_at, **kw)
    out = tapi.plan(tm, fleet, b).train(data, ckpt_dir=str(tmp_path),
                                        ckpt_every=3, **kw)
    resume = (fail_at // 3) * 3
    assert out["resumed_from"] == resume
    assert same_params(ref["params"], out["params"])
    tail = [h for h in ref["history"] if h["step"] > resume]
    assert len(tail) == len(out["history"]) > 0
    for ha, hb in zip(tail, out["history"]):
        assert ha["loss"] == hb["loss"] and ha["wall"] == hb["wall"]
        assert ha["sched"] == hb["sched"]
    assert ref["wall"] == out["wall"]


@pytest.mark.parametrize("topology", ["triple", "star"])
def test_resume_from_a_jax_checkpoint(tmp_path, monkeypatch, topology):
    """JAX dies after step 7 mid-straggle, having checkpointed step 6; the
    port resumes from that checkpoint and continues as JAX's
    uninterrupted run does."""
    jm, tm = models("tiny_mlp")
    jfleet, b = _tiny_fleet(japi, topology)
    tfleet, _ = _tiny_fleet(tapi, topology)
    kw = _resume_kw(topology)
    jdata = JImages(jm.input_shape, jm.num_classes, b, seed=0)
    tdata = SyntheticImages(tm.input_shape, tm.num_classes, b, seed=0)
    want = japi.plan(jm, jfleet, b).train(jdata, **kw)
    with pytest.raises(Exception, match="injected failure"):
        japi.plan(jm, jfleet, b).train(jdata, ckpt_dir=str(tmp_path),
                                       ckpt_every=3, fail_at=7, **kw)
    tp = port_plan(monkeypatch, tapi.plan(tm, tfleet, b),
                   jax_init("tiny_mlp", 3))
    got = tp.train(tdata, ckpt_dir=str(tmp_path), ckpt_every=3,
                   device="cpu", **kw)
    assert got["resumed_from"] == 6
    tail = [h for h in want["history"] if h["step"] > 6]
    assert [(repr(h["sched"]), h["wall"]) for h in got["history"]] == \
        [(repr(h["sched"]), h["wall"]) for h in tail]
    assert got["wall"] == want["wall"]
    assert repr(got["final_schedule"]) == repr(want["final_schedule"])
    for a, c in zip(got["history"], tail):
        assert a["loss"] == pytest.approx(c["loss"], rel=1e-5)
    assert_params_close(got["params"], want["params"], **NONE_TOL)


def test_resume_refuses_another_seed(tmp_path):
    _, tm = models("tiny_mlp")
    fleet, b = _tiny_fleet(tapi, "star")
    data = SyntheticImages(tm.input_shape, tm.num_classes, b, seed=0)
    kw = dict(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu")
    tapi.plan(tm, fleet, b).train(data, seed=1, **kw)
    with pytest.warns(RuntimeWarning, match="unreadable"):
        with pytest.raises(ValueError, match="seed"):
            tapi.plan(tm, fleet, b).train(data, seed=2, **kw)


# ---------------------------------------------------------------------------
# The planning replay, and chip_smoke.py's stragglers
# ---------------------------------------------------------------------------


def test_replay_equals_the_loop_under_churn():
    _, tm = models("tiny_mlp")
    fleet, b = _tiny_fleet(tapi, "star")
    p = tapi.plan(tm, fleet, b, pipeline_depth=3)
    trace = poisson_trace(p.profile.worker_names[:-2], 16, seed=1,
                          join_rate=0.15, leave_rate=0.1, crash_rate=0.08,
                          degrade_rate=0.1)
    kw = dict(steps=16, resched_every=4, ema=0.8, seed=3,
              worker_slowdown=slowdown("cloud", 30.0, (2, 12)))
    out = p.train(SyntheticImages(tm.input_shape, tm.num_classes, b),
                  churn=trace, device="cpu", **kw)
    cfg = loop.HierLoopConfig(total_steps=16, batch=b, resched_every=4,
                              ema=0.8, seed=3, pipeline_depth=3,
                              objective=p.objective)
    got = loop.replay(cfg, p.profile, p.network, kw["worker_slowdown"],
                      topology="star", initial_schedule=p.schedule,
                      churn=trace)
    assert out["churn_log"] and changes(out) >= 1
    assert [(h["step"], h["wall"], h["sched"]) for h in out["history"]] == \
        [(r["step"], r["wall"], r["sched"]) for r in got]


@pytest.mark.parametrize("m", [1, 4])
def test_chip_smoke_slowdowns_move_and_restore(m):
    """chip_smoke.py's straggler on each AlexNet plan (numpy only): the
    schedule changes at a re-solve and is back by the last step."""
    import chip_smoke
    from repro_torch.models.cnn import alexnet
    p = tapi.plan(alexnet(), tapi.Fleet.from_table2("alexnet", m=m,
                                                    wire="int8"),
                  chip_smoke.B)
    got = loop.replay(chip_smoke.train_config(loop, p), p.profile,
                      p.network, chip_smoke.train_slowdown(m),
                      topology=p.fleet.topology, initial_schedule=p.schedule)
    scheds = [r["sched"] for r in got]
    assert len(got) == chip_smoke.TRAIN_STEPS
    assert any(a != b for a, b in zip(scheds, scheds[1:]))
    assert scheds[-1] == p.schedule
    assert chip_smoke.FAIL_AT // chip_smoke.CKPT_EVERY * \
        chip_smoke.CKPT_EVERY > chip_smoke.TRAIN_WINDOW[0]


# ---------------------------------------------------------------------------
# measure_profile, and the card as the default device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny_mlp", "lenet5"])
def test_measure_profile_matches_jax(name):
    jm, tm = models(name)
    want = j_measure(jm, batch=4, repeats=1)
    got = measure_profile(tm, batch=4, repeats=1, device="cpu")
    assert got.layer_names == want.layer_names
    for f in ("MP", "MO", "MG", "L_u"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.sample_bytes == want.sample_bytes
    for f in ("L_f", "L_b"):
        v = getattr(got, f)
        assert v.shape == getattr(want, f).shape
        assert np.isfinite(v).all() and (v > 0).all()
    # the analytic profile's per-layer columns are those of JAX's too
    a, ja = analytic_profile(tm), j_analytic(jm)
    np.testing.assert_array_equal(a.L_f, ja.L_f)


def test_train_and_measure_profile_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tm = models("tiny_mlp")
    p = tapi.plan(tm, tapi.Fleet.from_table2("lenet5"), 16)
    data = SyntheticImages(tm.input_shape, tm.num_classes, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.train(data, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_profile(tm)
    assert len(p.train(data, steps=1, device="cpu")["history"]) == 1
