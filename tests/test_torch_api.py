"""The port's ``Fleet`` → ``plan`` → ``Plan`` facade against ``repro.api``.

* ``repro_torch.api.plan`` picks the same schedule, ``t_total`` and
  ``t_period`` as ``repro.api.plan`` (``==``): the planner is a numpy
  copy fed the same cut meta;
* a two-step ``Plan.step_fn(device="cpu")`` run on the narrowed AlexNet
  with the int8 wire matches JAX's ``Plan.step_fn``: each step within the
  int8 tolerance of tests/test_torch_hybrid_step.py, the run within the
  int8 loss budget;
* ``step_fn`` / ``init_params`` run on the card unless told otherwise,
  and raise when there is none.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.models import cnn as tcnn
from tests.test_torch_cnn import batch, jax_params, model_pair, to_jax
from tests.test_torch_hybrid_step import (INT8_LOSS, INT8_TOL,
                                          assert_params_close)

E2E_LOSS_GAP = 0.02

jax.config.update("jax_platform_name", "cpu")


def _fleets(mod, name: str, m: int, wire: str, topology: str):
    if topology == "tree":
        return mod.Fleet.from_table2(name, m=m, wire=wire, n_edges=2)
    return mod.Fleet.from_table2(name, m=m, wire=wire)


@pytest.mark.parametrize("backend", ["batched", "reference"])
@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("name", ["lenet5", "alexnet"])
def test_plan_equals_jax(name, m, wire, backend):
    jp = japi.plan(getattr(jcnn, name)(), _fleets(japi, name, m, wire,
                                                  "auto"), 64,
                   backend=backend)
    tp = tapi.plan(getattr(tcnn, name)(), _fleets(tapi, name, m, wire,
                                                  "auto"), 64,
                   backend=backend)
    assert repr(tp.schedule) == repr(jp.schedule)
    assert repr(tp.multi_schedule) == repr(jp.multi_schedule)
    assert tp.t_total == jp.t_total
    assert tp.t_period == jp.t_period
    assert tp.pipeline_time(3) == jp.pipeline_time(3)
    assert repr(tp.breakdown) == repr(jp.breakdown)
    assert tp.wire == jp.wire == wire
    np.testing.assert_array_equal(tp.profile.MO, jp.profile.MO)
    np.testing.assert_array_equal(tp.profile.MG, jp.profile.MG)


@pytest.mark.parametrize("objective", ["latency", "throughput"])
def test_tree_plan_equals_jax_and_step_waits(objective):
    jp = japi.plan(jcnn.alexnet(), _fleets(japi, "alexnet", 4, "int8",
                                           "tree"), 64, objective=objective)
    tp = tapi.plan(tcnn.alexnet(), _fleets(tapi, "alexnet", 4, "int8",
                                           "tree"), 64, objective=objective)
    assert repr(tp.schedule) == repr(jp.schedule)
    assert (tp.t_total, tp.t_period) == (jp.t_total, jp.t_period)
    with pytest.raises(NotImplementedError, match="tree"):
        tp.step_fn(device="cpu")


@pytest.mark.parametrize("m,B", [(1, 16), (4, 32)])
def test_two_steps_match_jax_plan(m, B):
    """Each step, started from the same params, matches JAX's step at the
    int8 tolerance.  Run independently, the two packages drift further:
    a last-bit difference flips an int8 rounding at the crossing, the
    next step starts from params that differ by that flip's effect, and
    those differences flip more roundings (measured on the M=4 plan:
    step-2 loss gap 1.6e-4, params 7.7e-4 apart).  The independent run
    is held to the repo's int8 loss budget, ``E2E_LOSS_GAP`` = 0.02 of
    tests/test_wire.py."""
    jm, tm = model_pair("alexnet_narrow")
    jplan = japi.plan(jm, japi.Fleet.from_table2("alexnet", m=m,
                                                 wire="int8"), B)
    tplan = tapi.plan(tm, tapi.Fleet.from_table2("alexnet", m=m,
                                                 wire="int8"), B)
    assert repr(tplan.schedule) == repr(jplan.schedule)
    s = tplan.multi_schedule
    assert any(c > 0 and b > 0 for c, b in zip(s.m_s, s.b_s)), \
        "the plan must cross the int8 wire"
    p_np = jax_params(jm, 13)
    jparams, tparams = to_jax(p_np), params_from_numpy(p_np)
    jstep = jplan.step_fn(lr=0.05)
    tstep = tplan.step_fn(lr=0.05, device="cpu")
    for k in range(2):
        x, y = batch(jm, B, 20 + k)
        start = params_from_numpy([{n: np.asarray(v) for n, v in q.items()}
                                   for q in jparams])
        jparams, jl = jstep(jparams, x, y)          # donates its params
        same_start, sl = tstep(start, x, y)
        assert abs(float(sl) - float(jl)) <= INT8_LOSS
        assert_params_close(same_start, jparams, **INT8_TOL)
        tparams, tl = tstep(tparams, x, y)
        assert np.isfinite(float(tl))
        assert abs(float(tl) - float(jl)) <= E2E_LOSS_GAP


def test_init_params_seeded_on_the_requested_device():
    p = tapi.plan(tcnn.lenet5(), tapi.Fleet.from_table2("lenet5"), 16)
    a = p.init_params(seed=3, device="cpu")
    b = p.init_params(seed=3, device="cpu")
    assert all(t.device.type == "cpu" for q in a for t in q.values())
    assert all(torch.equal(q[k], r[k]) for q, r in zip(a, b) for k in q)


def test_step_fn_and_init_params_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = tapi.plan(tcnn.lenet5(), tapi.Fleet.from_table2("lenet5"), 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.step_fn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        p.init_params(seed=0)
    assert callable(p.step_fn(device="cpu"))


@pytest.mark.parametrize("call", ["simulate", "baseline", "explain", "train",
                                  "plan_many"])
def test_unported_entry_points_say_so(call):
    p = tapi.plan(tcnn.lenet5(), tapi.Fleet.from_table2("lenet5"), 16)
    fn = {"simulate": lambda: p.simulate(),
          "baseline": lambda: p.baseline("edge"),
          "explain": lambda: p.explain(),
          "train": lambda: p.train(None, steps=1),
          "plan_many": lambda: tapi.plan_many([])}[call]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn()


def test_profile_only_plan_cannot_execute():
    jprof = japi.plan(jcnn.lenet5(), japi.Fleet.from_table2("lenet5"),
                      16).profile
    from repro_torch.core.cost_model import HierProfile, Network
    from repro_torch.core.fleet import MBPS
    prof = HierProfile(**{f: getattr(jprof, f) for f in
                          ("layer_names", "L_f", "L_b", "L_u", "MP", "MO",
                           "MG", "sample_bytes")})
    p = tapi.plan(None, tapi.Fleet.from_profile(
        prof, Network(bw_de=5.0 * MBPS, bw_ec=3.0 * MBPS)), 16)
    assert p.schedule.b_o + p.schedule.b_s + p.schedule.b_l == 16
    with pytest.raises(ValueError, match="without a model"):
        p.step_fn(device="cpu")
