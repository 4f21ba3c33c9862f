"""The port's elastic-fleet churn against ``repro.core.churn``.

``poisson_trace``, ``apply_event`` and ``remap_schedule`` give ``==``
results to the JAX package's on the same inputs; the cases of
tests/test_churn.py run on the port (the loop-level ones through
``Plan.train(device="cpu")``); and a churned ``Plan.train`` logs the
JAX package's churn events, schedules and walls.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import churn as jchurn
from repro.core import cost_model as jcm
from repro.core.profiler import multi_analytic_profile as j_map
from repro.data.pipeline import SyntheticImages as JImages
from repro.models import cnn as jcnn
from repro_torch.core.churn import (ChurnTrace, DeviceCrash, DeviceJoin,
                                    DeviceLeave, LinkDegrade, apply_event,
                                    poisson_trace, reference_rows,
                                    remap_schedule)
from repro_torch.core.cost_model import (MultiSchedule, StarNetwork,
                                         _validate_multi)
from repro_torch.core.profiler import multi_analytic_profile
from repro_torch.core.scheduler import _solve_multi
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.models import cnn as tcnn
from repro_torch.train.loop import InjectedFailure
from tests.test_torch_cnn import tiny_mlp
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

JAX_MODEL = tiny_mlp(jcnn)


def _tiny_mlp():
    return tiny_mlp(tcnn)


def _star(model, slowdowns=(1.0, 1.2, 1.8), mods=None):
    """(profile, network) of the heterogeneous star in the port or, with
    ``mods="jax"``, in the JAX package."""
    bw = np.linspace(4.0, 3.0, len(slowdowns)) * 1e6 / 8
    if mods == "jax":
        return (j_map(model, device_slowdowns=slowdowns),
                jcm.StarNetwork(bw_de=bw, bw_ec=2.0 * 1e6 / 8))
    return (multi_analytic_profile(model, device_slowdowns=slowdowns),
            StarNetwork(bw_de=bw, bw_ec=2.0 * 1e6 / 8))


def _event_key(e):
    return type(e).__name__, dataclasses.astuple(e)


def _data(B: int):
    return SyntheticImages((8,), 5, B, seed=0)


def _params(a, b):
    return all(torch.equal(x, y) for p, q in zip(a, b) for k in p
               for x, y in [(p[k], q[k])])


# ---------------------------------------------------------------------------
# == against repro.core.churn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_poisson_trace_equals_jax(seed):
    devs = ("device_0", "device_1", "device_2")
    kw = dict(seed=seed, join_rate=0.1, leave_rate=0.1, crash_rate=0.05,
              degrade_rate=0.1, min_devices=1, max_devices=4)
    got = poisson_trace(devs, 200, **kw)
    want = jchurn.poisson_trace(devs, 200, **kw)
    assert got.events
    assert [_event_key(e) for e in got.events] == \
        [_event_key(e) for e in want.events]


def _profile_key(p):
    return (p.worker_names, p.L_f.tobytes(), p.L_b.tobytes(),
            p.L_u.tobytes())


def test_apply_event_and_remap_equal_jax():
    model = _tiny_mlp()
    prof, net = _star(model)
    jprof, jnet = _star(JAX_MODEL, mods="jax")
    ref, jref = reference_rows(prof), jchurn.reference_rows(jprof)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(ref, jref))
    sched_kw = dict(worker_o="cloud", worker_l="edge",
                    s_workers=("device_0", "device_1", "device_2"),
                    m_s=(2, 2, 0), m_l=4, b_o=10, b_s=(8, 6, 0), b_l=0)
    sched, jsched = MultiSchedule(**sched_kw), jcm.MultiSchedule(**sched_kw)
    base, jbase = prof, jprof
    events = (("DeviceJoin", (3, "dev_j0", 2.0, 4.0)),
              ("LinkDegrade", (4, "device_0", 0.5)),
              ("DeviceLeave", (5, "device_1")),
              ("DeviceCrash", (6, "device_2")))
    for name, args in events:
        prof, base, net, changed = apply_event(
            prof, base, net, ref, globals()[name](*args))
        jprof, jbase, jnet, jchanged = jchurn.apply_event(
            jprof, jbase, jnet, jref, getattr(jchurn, name)(*args))
        assert changed == jchanged
        assert _profile_key(prof) == _profile_key(jprof)
        assert _profile_key(base) == _profile_key(jbase)
        assert np.asarray(net.bw_de).tobytes() == \
            np.asarray(jnet.bw_de).tobytes() and net.bw_ec == jnet.bw_ec
        assert repr(remap_schedule(sched, prof)) == \
            repr(jchurn.remap_schedule(jsched, jprof))


# ---------------------------------------------------------------------------
# tests/test_churn.py, on the port
# ---------------------------------------------------------------------------


def test_poisson_trace_deterministic():
    devs = ("device_0", "device_1", "device_2")
    kw = dict(join_rate=0.1, leave_rate=0.1, crash_rate=0.05,
              degrade_rate=0.1)
    a = poisson_trace(devs, 200, seed=7, **kw)
    assert a == poisson_trace(devs, 200, seed=7, **kw)
    assert a != poisson_trace(devs, 200, seed=8, **kw)


def test_poisson_trace_respects_bounds():
    devs = ("device_0", "device_1")
    tr = poisson_trace(devs, 500, seed=0, join_rate=0.2, leave_rate=0.3,
                       crash_rate=0.2, min_devices=1, max_devices=3)
    live = set(devs)
    for e in tr.events:
        if isinstance(e, (DeviceLeave, DeviceCrash)):
            live.discard(e.name)
        elif isinstance(e, DeviceJoin):
            assert e.name not in live
            live.add(e.name)
        assert 1 <= len(live) <= 3


def test_trace_ordering_and_since():
    tr = ChurnTrace((DeviceLeave(2, "a"), DeviceJoin(5, "b"),
                     LinkDegrade(5, "b", 0.5)))
    assert tr.events_at(5) == (DeviceJoin(5, "b"),
                               LinkDegrade(5, "b", 0.5))
    assert tr.since(5).events == tr.events_at(5)
    assert tr.max_step == 5
    with pytest.raises(AssertionError):
        ChurnTrace((DeviceJoin(5, "b"), DeviceLeave(2, "a")))


def test_apply_events_roundtrip_membership():
    prof, net = _star(_tiny_mlp())
    ref = reference_rows(prof)
    prof2, base2, net2, changed = apply_event(
        prof, prof, net, ref, DeviceJoin(3, "dev_j0", slowdown=2.0,
                                         uplink_mbps=4.0))
    assert changed
    assert prof2.worker_names[:-2] == ("device_0", "device_1",
                                       "device_2", "dev_j0")
    i = prof2.device_index("dev_j0")
    np.testing.assert_array_equal(prof2.L_f[i], ref[0] * 2.0)
    assert net2.bw_de[i] == 4.0 * 1e6 / 8
    np.testing.assert_array_equal(prof2.L_f[:3], prof.L_f[:3])

    prof3, base3, net3, changed = apply_event(
        prof2, base2, net2, ref, DeviceLeave(4, "device_1"))
    assert changed
    assert "device_1" not in prof3.worker_names
    assert len(net3.bw_de) == 3

    _, _, net4, changed = apply_event(prof3, base3, net3, ref,
                                      LinkDegrade(5, "device_0", 0.5))
    assert not changed
    assert net4.bw_de[0] == net3.bw_de[0] * 0.5

    with pytest.raises(ValueError):
        prof.add_device("device_0", ref[0], ref[1], ref[2])
    with pytest.raises(ValueError):
        prof.drop_device("edge")
    with pytest.raises(ValueError):
        net.scale_uplink(0, 0.0)


def test_drop_last_device_rejected():
    prof, _ = _star(_tiny_mlp(), slowdowns=(1.0,))
    with pytest.raises(ValueError):
        prof.drop_device("device_0")


def test_remap_folds_lost_samples_into_task_o():
    prof, _ = _star(_tiny_mlp())
    sched = MultiSchedule(worker_o="cloud", worker_l="edge",
                          s_workers=("device_0", "device_1", "device_2"),
                          m_s=(2, 2, 0), m_l=4, b_o=10, b_s=(8, 6, 0),
                          b_l=0)
    _validate_multi(prof, sched)
    prof2 = prof.drop_device("device_1")
    re = remap_schedule(sched, prof2)
    _validate_multi(prof2, re)
    assert re.b_o == sched.b_o + 6 and re.batch == sched.batch
    assert "device_1" not in re.s_workers
    prof3 = prof.add_device("dev_j0", prof.L_f[0], prof.L_b[0],
                            prof.L_u[0])
    re2 = remap_schedule(sched, prof3)
    j = re2.s_workers.index("dev_j0")
    assert re2.m_s[j] == 0 and re2.b_s[j] == 0
    assert re2.batch == sched.batch
    sched_o = MultiSchedule(worker_o="device_0", worker_l="cloud",
                            s_workers=("device_1", "device_2"),
                            m_s=(2, 0), m_l=4, b_o=18, b_s=(6, 0), b_l=0)
    assert remap_schedule(sched_o, prof.drop_device("device_0")) is None


@pytest.mark.parametrize("objective", ["latency", "throughput"])
def test_warm_solve_bit_identical(objective):
    prof, net = _star(_tiny_mlp(), slowdowns=(1.0, 1.3, 1.7, 2.2))
    full = _solve_multi(prof, net, 24, objective=objective).schedule
    survivors = prof.drop_device("device_2")
    net_s = net.drop_device(2)
    warm = remap_schedule(full, survivors)
    assert warm is not None
    cold = _solve_multi(survivors, net_s, 24, objective=objective)
    ws = _solve_multi(survivors, net_s, 24, objective=objective,
                      warm_start=warm)
    assert ws.schedule == cold.schedule and ws.t_total == cold.t_total
    assert ws.n_pruned >= cold.n_pruned


def test_warm_solve_wrong_batch_rejected():
    prof, net = _star(_tiny_mlp())
    sched = _solve_multi(prof, net, 24).schedule
    with pytest.raises(ValueError):
        _solve_multi(prof, net, 32, warm_start=sched)


def test_churn_at_step0_equals_fresh_survivor_fleet():
    model = _tiny_mlp()
    prof, net = _star(model)
    trace = ChurnTrace((DeviceLeave(0, "device_1"),))
    churned = tapi.plan(model, tapi.Fleet.from_profile(prof, net), 24) \
        .train(_data(24), steps=5, seed=3, churn=trace, device="cpu")
    fresh = tapi.plan(
        model, tapi.Fleet.from_profile(prof.drop_device("device_1"),
                                       net.drop_device(1)), 24) \
        .train(_data(24), steps=5, seed=3, device="cpu")
    assert _params(churned["params"], fresh["params"])
    for ha, hb in zip(churned["history"], fresh["history"]):
        assert ha["loss"] == hb["loss"] and ha["sched"] == hb["sched"]


def test_midrun_churn_schedule_matches_cold_solve():
    model = _tiny_mlp()
    prof, net = _star(model)
    trace = ChurnTrace((DeviceLeave(3, "device_2"),))
    out = tapi.plan(model, tapi.Fleet.from_profile(prof, net), 24) \
        .train(_data(24), steps=6, seed=3, churn=trace, device="cpu")
    assert len(out["churn_log"]) == 1 and out["churn_log"][0]["warm"]
    cold = _solve_multi(prof.drop_device("device_2"), net.drop_device(2),
                        24).schedule
    assert out["history"][3]["sched"] == cold
    assert out["final_schedule"] == cold


def _trace(prof):
    trace = poisson_trace(prof.worker_names[:-2], 18, seed=1,
                          join_rate=0.15, leave_rate=0.1, crash_rate=0.08,
                          degrade_rate=0.1)
    assert trace.events, "trace unexpectedly empty; pick another seed"
    return trace


def test_churn_run_deterministic_and_resumable(tmp_path):
    model = _tiny_mlp()
    prof, net = _star(model)
    fleet = tapi.Fleet.from_profile(prof, net)
    kw = dict(steps=18, seed=3, churn=_trace(prof), device="cpu")
    ref = tapi.plan(model, fleet, 24).train(_data(24), **kw)
    again = tapi.plan(model, fleet, 24).train(_data(24), **kw)
    assert ref["wall"] == again["wall"]

    with pytest.raises(InjectedFailure):
        tapi.plan(model, fleet, 24).train(
            _data(24), ckpt_dir=str(tmp_path), ckpt_every=4, fail_at=11,
            **kw)
    out = tapi.plan(model, fleet, 24).train(
        _data(24), ckpt_dir=str(tmp_path), ckpt_every=4, **kw)
    assert out["resumed_from"] == 8
    assert _params(ref["params"], out["params"])
    tail = [h for h in ref["history"] if h["step"] > 8]
    assert len(tail) == len(out["history"])
    for ha, hb in zip(tail, out["history"]):
        assert ha["loss"] == hb["loss"] and ha["wall"] == hb["wall"]
        assert ha["sched"] == hb["sched"]
    assert ref["wall"] == out["wall"]


def test_churn_rejected_on_triple():
    from repro_torch.core.cost_model import Network
    from repro_torch.core.profiler import analytic_profile
    model = _tiny_mlp()
    fleet = tapi.Fleet.from_profile(analytic_profile(model),
                                    Network(5e6 / 8, 1e6 / 8))
    with pytest.raises(NotImplementedError, match="triple"):
        tapi.plan(model, fleet, 16).train(
            _data(16), steps=2, churn=ChurnTrace((DeviceLeave(0, "x"),)),
            device="cpu")


# ---------------------------------------------------------------------------
# A churned Plan.train against repro.api.Plan.train
# ---------------------------------------------------------------------------


def test_churned_train_logs_equal_jax():
    """Same trace, same fleet: the churn log (solver seconds aside), the
    schedules, the walls and the final schedule are ``==``."""
    prof, net = _star(_tiny_mlp())
    jprof, jnet = _star(JAX_MODEL, mods="jax")
    trace = _trace(prof)
    jtrace = jchurn.ChurnTrace(tuple(
        getattr(jchurn, type(e).__name__)(*dataclasses.astuple(e))
        for e in trace.events))
    kw = dict(steps=18, seed=3)
    got = tapi.plan(_tiny_mlp(), tapi.Fleet.from_profile(prof, net), 24) \
        .train(_data(24), churn=trace, device="cpu", **kw)
    want = japi.plan(JAX_MODEL, japi.Fleet.from_profile(jprof, jnet), 24) \
        .train(JImages((8,), 5, 24, seed=0), churn=jtrace, **kw)

    def log(out):
        return [{k: v for k, v in e.items() if k != "resolve_s"}
                for e in out["churn_log"]]
    assert log(got) == log(want) and log(got)
    assert [(repr(h["sched"]), h["wall"]) for h in got["history"]] == \
        [(repr(h["sched"]), h["wall"]) for h in want["history"]]
    assert repr(got["final_schedule"]) == repr(want["final_schedule"])
    assert got["wall"] == want["wall"]
