"""The port's ``Plan.train`` against ``repro.api.Plan.train``: the int8
wire and the LM stack, from the same initial weights (the port stack's
``init`` returns the JAX init, a test-only monkeypatch).

* ``wire="int8"`` on alexnet_narrow (M=1 triple and M=4 star): schedules
  and walls ``==``, each step's loss within ``E2E_LOSS_GAP`` = 0.02
  (measured over 5 steps: at most 1.9e-6 on either fleet).
* The LM stack (oracle-zamba, T=32, ``Fleet.lm_default(m=2)``) with a
  straggler that moves the schedule: in f32 each loss and the final
  params at the end-to-end tolerances of tests/test_torch_lm.py; with
  bf16 params, schedules and walls ``==`` and each loss within one bf16
  rounding (2^-8 relative; measured at most 1.8e-4 over 3 steps, 7.3e-5
  at the first step, before any update).  bf16 params are not held per
  element: after four steps at lr 1e-3 they differ from JAX's by up to
  7 bf16 ulps at a leaf's scale (the frameworks round the bf16 gradient
  sums differently, and an update under half an ulp vanishes in one and
  not the other).  A bf16 kill/resume in the port is bitwise.
* ``measure_profile`` takes the LM's integer token input.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.models.lm.layerstack import lm_layerstack as jax_lm_layerstack
from repro_torch.core.profiler import measure_profile
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.train import loop
from tests.test_kernel_oracle import (E2E_LOSS_RTOL, E2E_PARAM_ATOL,
                                      E2E_PARAM_RTOL)
from tests.test_torch_lm import flat, stacks
from tests.test_torch_train_loop import (B, assert_params_close,
                                         assert_plans_equal, changes,
                                         data_pair, fleets, jax_init, models,
                                         port_plan, same_params, slowdown)
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

E2E_LOSS_GAP = 0.02          # int8 loss budget (tests/test_wire.py)
BF16_LOSS_RTOL = 2.0 ** -8   # one bf16 rounding of the loss


@pytest.mark.parametrize("m", [1, 4])
def test_int8_train_matches_jax_within_the_budget(monkeypatch, m):
    jm, tm = models("alexnet_narrow")
    jfleet, tfleet = fleets("alexnet_narrow", m, "int8")
    jp = japi.plan(jm, jfleet, B)
    tp = port_plan(monkeypatch, tapi.plan(tm, tfleet, B),
                   jax_init("alexnet_narrow", 5))
    s = tp.multi_schedule
    assert any(c > 0 and b > 0 for c, b in zip(s.m_s, s.b_s)), \
        "the plan must cross the int8 wire"
    jdata, tdata = data_pair(tm)
    kw = dict(steps=5, lr=0.01, seed=5)
    want = jp.train(jdata, **kw)
    got = tp.train(tdata, device="cpu", **kw)
    assert_plans_equal(got, want)
    gaps = [abs(a["loss"] - b["loss"])
            for a, b in zip(got["history"], want["history"])]
    assert all(np.isfinite(h["loss"]) for h in got["history"])
    assert max(gaps) <= E2E_LOSS_GAP, gaps


class TokenData:
    """A token stream in the loop's ``{"x", "labels"}`` shape."""

    def __init__(self, stream):
        self.stream = stream

    def batch(self, step):
        b = self.stream.batch(step)
        return {"x": b["tokens"], "labels": b["targets"]}


def _lm_runs(monkeypatch, dtype: str):
    js, ts = stacks("cuda", dtype)
    js = jax_lm_layerstack(js.cfg.variant(use_flash=False,
                                          use_gla_kernel=False), 32, "ref")
    init = jax.tree.map(np.asarray, js.init(jax.random.PRNGKey(3)))
    jp = japi.plan(js, japi.Fleet.lm_default(m=2), 8)
    tp = port_plan(monkeypatch, tapi.plan(ts, tapi.Fleet.lm_default(m=2), 8),
                   init)
    kw = dict(steps=3, lr=1e-3, resched_every=1, ema=0.8, seed=3,
              worker_slowdown=slowdown(tp.schedule.worker_o, window=(1, 3)))
    want = jp.train(TokenData(JTokens(512, 32, 8, 0)), **kw)
    got = tp.train(TokenData(SyntheticTokens(512, 32, 8, 0)), device="cpu",
                   **kw)
    return tp, kw, got, want


def test_lm_f32_train_matches_jax(monkeypatch):
    _, _, got, want = _lm_runs(monkeypatch, "float32")
    assert changes(got) >= 1
    assert_plans_equal(got, want)
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=E2E_LOSS_RTOL)
    assert_params_close(got["params"], want["params"], atol=E2E_PARAM_ATOL,
                        rtol=E2E_PARAM_RTOL)


def test_lm_bf16_train_matches_jax_and_resumes_bitwise(monkeypatch,
                                                       tmp_path):
    tp, kw, got, want = _lm_runs(monkeypatch, "bfloat16")
    assert changes(got) >= 1
    assert_plans_equal(got, want)
    assert any(t.dtype == torch.bfloat16 for q in got["params"]
               for t in flat(q))
    losses = [h["loss"] for h in got["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=BF16_LOSS_RTOL)
    data = TokenData(SyntheticTokens(512, 32, 8, 0))
    with pytest.raises(loop.InjectedFailure):
        tp.train(data, ckpt_dir=str(tmp_path), ckpt_every=1, fail_at=2,
                 device="cpu", **kw)
    out = tp.train(data, ckpt_dir=str(tmp_path), ckpt_every=1,
                   device="cpu", **kw)
    assert out["resumed_from"] == 2
    assert same_params(got["params"], out["params"])
    assert [h["loss"] for h in out["history"]] == losses[2:]


def test_measure_profile_takes_the_lm_token_input():
    """The LM embed cut's input is integer token ids: its backward is the
    params gradient alone."""
    _, ts = stacks("cuda", "float32")
    prof = measure_profile(ts, batch=2, repeats=1, device="cpu")
    assert len(prof.layer_names) == ts.num_layers
    assert np.isfinite(prof.L_b).all() and (prof.L_b > 0).all()
