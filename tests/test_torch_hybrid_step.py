"""The port's hybrid-SGD step: exact batch-B SGD, and parity with JAX.

* torch hybrid == torch vanilla SGD over random schedules (the
  ``test_hybrid_equals_reference_sgd`` property of
  tests/test_hybrid_step.py), at its rtol 2e-5 / atol 2e-6;
* torch vs JAX ``hybrid_step_from_schedule`` and
  ``multi_hybrid_step_from_schedule`` on the same schedule, params and
  batch.  ``wire="none"``: rtol 5e-5 / atol 1e-6 (the lenet bound of
  tests/test_hybrid_step.py).  ``wire="int8"``: loss within 1e-4, params
  rtol 1e-3 / atol 1e-5 — a last-bit activation difference between the
  frameworks can flip one rounding, which moves that element by one
  scale step.  Measured on these inputs (no rounding flipped): loss
  within 1.5e-6 and params within 6e-8 abs, under both wires;
* the M=1 star step is bitwise equal to the triple step, under both
  wires;
* the engine's walk over nested param dicts gives the results of the
  flat ``{"w", "b"}`` walk it replaced, bit for bit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as jcm
from repro.core import hybrid_step as jhs
from repro_torch.convert import params_from_numpy
from repro_torch.core import hybrid_step as ths
from repro_torch.core.cost_model import MultiSchedule, Schedule
from tests.test_torch_cnn import batch, jax_params, model_pair, to_jax
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

NONE_TOL = dict(rtol=5e-5, atol=1e-6)
INT8_TOL = dict(rtol=1e-3, atol=1e-5)
INT8_LOSS = 1e-4


def assert_params_close(got, want_np, **tol):
    for pt, pj in zip(got, want_np):
        for k in ("w", "b"):
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       **tol)


def assert_params_equal(a, b):
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, b) for k in p)


@pytest.mark.parametrize("seed", range(12))
def test_hybrid_equals_reference_sgd(seed):
    rng = np.random.default_rng(seed)
    _, model = model_pair("tiny_mlp")
    N = model.num_layers
    B = 12
    m_s = int(rng.integers(0, N + 1))
    m_l = int(rng.integers(m_s, N + 1))
    b_s = int(rng.integers(0, B)) if m_s > 0 else 0
    b_l = int(rng.integers(0, B - b_s)) if m_l > 0 else 0
    sched = Schedule("cloud", "device", "edge", m_s, m_l, B - b_s - b_l,
                     b_s, b_l)
    params = params_from_numpy(jax_params(model_pair("tiny_mlp")[0], seed))
    x, y = (torch.from_numpy(a) for a in batch(model, B, seed))
    ref_p, ref_loss = ths.reference_sgd_step(model, params, x, y, 0.05)
    hyb_p, hyb_loss = ths.hybrid_step_from_schedule(model, params, x, y,
                                                    sched, 0.05)
    assert float(hyb_loss) == pytest.approx(float(ref_loss), rel=1e-5)
    for pr, ph in zip(ref_p, hyb_p):
        for k in ("w", "b"):
            np.testing.assert_allclose(pr[k].numpy(), ph[k].numpy(),
                                       rtol=2e-5, atol=2e-6)


def test_degenerate_schedules_equal_reference():
    """m_s = m_l = 0 (single worker) and m_s = m_l = N (full DP)."""
    jm, model = model_pair("tiny_mlp")
    params = params_from_numpy(jax_params(jm, 2))
    x, y = (torch.from_numpy(a) for a in batch(model, 9, 2))
    ref, _ = ths.reference_sgd_step(model, params, x, y, 0.1)
    N = model.num_layers
    for sched in (Schedule("cloud", "device", "edge", 0, 0, 9, 0, 0),
                  Schedule("cloud", "device", "edge", N, N, 3, 3, 3),
                  Schedule("cloud", "device", "edge", N, N, 0, 5, 4)):
        hyb, _ = ths.hybrid_step_from_schedule(model, params, x, y, sched,
                                               0.1)
        for pr, ph in zip(ref, hyb):
            np.testing.assert_allclose(pr["w"].numpy(), ph["w"].numpy(),
                                       rtol=2e-5, atol=2e-6)


TRIPLE = dict(args=("cloud", "edge", "device", 1, 3, 4, 5, 3))
STAR = dict(worker_o="cloud", worker_l="device_3",
            s_workers=("device_0", "device_1", "device_2", "edge"),
            m_s=(1, 2, 1, 0), m_l=3, b_o=3, b_s=(2, 3, 1, 2), b_l=1)


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("topology", ["triple", "star"])
@pytest.mark.parametrize("name", ["lenet5", "alexnet_narrow"])
def test_step_matches_jax(name, topology, wire):
    jm, tm = model_pair(name)
    p_np = jax_params(jm, 7)
    x, y = batch(jm, 12, 8)
    if topology == "triple":
        jsched, tsched = jcm.Schedule(*TRIPLE["args"]), \
            Schedule(*TRIPLE["args"])
        jrun, trun = jhs.hybrid_step_from_schedule, \
            ths.hybrid_step_from_schedule
    else:
        jsched, tsched = jcm.MultiSchedule(**STAR), MultiSchedule(**STAR)
        jrun, trun = jhs.multi_hybrid_step_from_schedule, \
            ths.multi_hybrid_step_from_schedule
    jp, jl = jax.jit(lambda p, xx, yy: jrun(jm, p, xx, yy, jsched, 0.05,
                                            wire=wire))(
        to_jax(p_np), jnp.asarray(x), jnp.asarray(y))
    tp, tl = trun(tm, params_from_numpy(p_np), torch.from_numpy(x),
                  torch.from_numpy(y), tsched, 0.05, wire=wire)
    if wire == "none":
        assert float(tl) == pytest.approx(float(jl), rel=1e-5)
        assert_params_close(tp, jp, **NONE_TOL)
    else:
        assert abs(float(tl) - float(jl)) <= INT8_LOSS
        assert_params_close(tp, jp, **INT8_TOL)


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_m1_star_equals_triple_bitwise(wire):
    jm, tm = model_pair("alexnet_narrow")
    params = params_from_numpy(jax_params(jm, 9))
    x, y = (torch.from_numpy(a) for a in batch(jm, 10, 10))
    for cuts in ((1, 3, 3, 4, 3), (2, 2, 4, 6, 0), (0, 5, 6, 0, 4)):
        m_s, m_l, b_o, b_s, b_l = cuts
        tri = Schedule("cloud", "edge", "device", m_s, m_l, b_o, b_s, b_l)
        star = MultiSchedule.from_schedule(tri)
        pt, lt = ths.hybrid_step_from_schedule(tm, params, x, y, tri, 0.05,
                                               wire=wire)
        ps, ls = ths.multi_hybrid_step_from_schedule(tm, params, x, y, star,
                                                     0.05, wire=wire)
        assert torch.equal(lt, ls)
        assert_params_equal(pt, ps)


def test_wire_none_leaves_step_untouched_and_int8_differs():
    jm, tm = model_pair("lenet5")
    params = params_from_numpy(jax_params(jm, 11))
    x, y = (torch.from_numpy(a) for a in batch(jm, 8, 12))
    sched = Schedule("cloud", "edge", "device", 2, 3, 2, 4, 2)
    a, la = ths.hybrid_step_from_schedule(tm, params, x, y, sched, 0.05)
    b, lb = ths.hybrid_step_from_schedule(tm, params, x, y, sched, 0.05,
                                          wire="none")
    c, lc = ths.hybrid_step_from_schedule(tm, params, x, y, sched, 0.05,
                                          wire="int8")
    assert torch.equal(la, lb)
    assert_params_equal(a, b)
    assert not torch.equal(la, lc)


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_traffic_matches_jax(wire):
    jm, tm = model_pair("lenet5")
    for args in (("cloud", "device", "edge", 2, 3, 4, 3, 3),
                 ("edge", "cloud", "device", 0, 4, 2, 0, 6)):
        a = ths.traffic(tm, Schedule(*args), 3076.0, wire=wire)
        b = jhs.traffic(jm, jcm.Schedule(*args), 3076.0, wire=wire)
        assert (a.input_bytes, a.activation_bytes, a.weightgrad_bytes) == \
            (b.input_bytes, b.activation_bytes, b.weightgrad_bytes)


def test_split_batch_rejects_wrong_batch():
    x, y = torch.zeros(5, 8), torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        ths.split_batch(x, y, Schedule("cloud", "edge", "device", 1, 1, 1,
                                       1, 1))
    with pytest.raises(ValueError):
        ths.multi_split_batch(x, y, MultiSchedule(**STAR))


def _flat_leaves(params, n):
    return [{k: v.detach().requires_grad_(True) for k, v in p.items()}
            for p in params[:n]]


def _flat_grads(loss, copies):
    flat = [(c, i, k) for c, cp in enumerate(copies)
            for i, p in enumerate(cp) for k in p]
    gs = torch.autograd.grad(loss, [copies[c][i][k] for c, i, k in flat],
                             allow_unused=True)
    out = [[{} for _ in cp] for cp in copies]
    for (c, i, k), g in zip(flat, gs):
        out[c][i][k] = torch.zeros_like(copies[c][i][k]) if g is None else g
    return out


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("topology", ["triple", "star"])
def test_nested_walk_keeps_flat_results_bitwise(topology, wire, monkeypatch):
    """The engine as it was for flat ``{"w", "b"}`` dicts (its leaf,
    gradient, sum and update walks, verbatim) against the nested walk."""
    jm, tm = model_pair("alexnet_narrow")
    params = params_from_numpy(jax_params(jm, 14))
    x, y = (torch.from_numpy(a) for a in batch(jm, 12, 15))
    if topology == "triple":
        sched = Schedule(*TRIPLE["args"])
        run = ths.hybrid_step_from_schedule
    else:
        sched = MultiSchedule(**STAR)
        run = ths.multi_hybrid_step_from_schedule
    nested, nl = run(tm, params, x, y, sched, 0.05, wire=wire)
    ref_nested, rl = ths.reference_sgd_step(tm, params, x, y, 0.05)
    monkeypatch.setattr(ths, "_leaves", _flat_leaves)
    monkeypatch.setattr(ths, "_grads", _flat_grads)
    monkeypatch.setattr(ths, "_add", lambda g, o: {k: g[k] + o[k] for k in g})
    monkeypatch.setattr(ths, "_update", lambda p, g, i, lr, B: {
        k: p[i][k] - lr * (g[k] / B) for k in p[i]})
    monkeypatch.setattr(ths, "_map", lambda fn, t, *r: {
        k: fn(v, *(q[k] for q in r)) for k, v in t.items()})
    flat, fl = run(tm, params, x, y, sched, 0.05, wire=wire)
    ref_flat, rfl = ths.reference_sgd_step(tm, params, x, y, 0.05)
    assert torch.equal(nl, fl) and torch.equal(rl, rfl)
    assert_params_equal(nested, flat)
    assert_params_equal(ref_nested, ref_flat)
