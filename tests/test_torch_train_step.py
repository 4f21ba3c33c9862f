"""The port's single-process train step and generic loop against the JAX
package's ``make_train_step`` / ``run_train_loop``.

* ``make_train_step`` (``hier_sync=False``) for 3 steps on ``build_model``
  of the reference's tiny f32 dense, moe and xlstm configs
  (tests/test_lm_layerstack.py:30-58, depth cut to 2 layers to keep
  JAX's compile short; the xlstm's are an mLSTM and an sLSTM block, at
  T=48 as in tests/test_torch_lm_families.py), with ``microbatches`` 1
  and 2, from the same init (the port's, as numpy) and the same token
  batches: each step's
  loss to ``E2E_LOSS_RTOL`` and the params to the end-to-end tolerances
  of the oracle suite.
* ``run_train_loop`` as in tests/test_train_loop.py: a run killed after
  step 7 and resumed from its step-5 checkpoint ends bitwise equal to an
  uninterrupted one, the loss falls, and the logged losses equal the
  JAX loop's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data.pipeline import make_lm_batch_fn as jax_batch_fn
from repro.models.lm.model import build_model as jax_build_model
from repro.optim import get_optimizer as jax_get_optimizer
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import run_train_loop as jax_run_train_loop
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import model_params_to_numpy
from repro_torch.data.pipeline import SyntheticTokens, make_lm_batch_fn
from repro_torch.models.lm.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.tree import leaves as _leaves
from repro_torch.train import (InjectedFailure, LoopConfig, init_state,
                               make_train_step, run_train_loop)
from tests.test_kernel_oracle import (E2E_LOSS_RTOL, E2E_PARAM_ATOL,
                                      E2E_PARAM_RTOL)
from tests.test_lm_layerstack import CFGS as JAX_TINY
from tests.test_torch_lm import to_torch_config
from tests.test_torch_serve import one_thread  # noqa: F401  (fixture)
from tests.test_train_loop import CFG as JAX_LOOP_CFG

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

SEQS = {"attention": 16, "moe": 16, "xlstm": 48}
# AdamW's first update is about lr * sign(g), so a gradient element
# within the libraries' rounding of zero can move its param by up to
# 2 lr (measured on the dense config: 1.8e-4 at one of 4,096 entries of
# w_up after 3 steps at lr 1e-2).  Its arithmetic is held to JAX's on the
# same gradients in tests/test_torch_optim.py; here, where the gradients
# come from each library, the dense and moe steps run SGD with momentum.
OPTS = {"attention": ("sgdm", dict(lr=0.05, weight_decay=0.01)),
        "moe": ("sgdm", dict(lr=0.05, weight_decay=0.01)),
        "xlstm": ("adamw", dict(lr=1e-2, weight_decay=0.1))}
B = 8


def assert_tree_close(got, want, **tol):
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("family", sorted(SEQS))
def test_train_step_matches_jax(family, microbatches, one_thread):
    jcfg = JAX_TINY[family].variant(n_layers=2)
    jm, tm = jax_build_model(jcfg), build_model(to_torch_config(jcfg))
    name, kw = OPTS[family]
    jopt, topt = jax_get_optimizer(name, **kw), get_optimizer(name, **kw)
    state = init_state(tm, topt, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(jnp.asarray,
                           model_params_to_numpy(state["params"]))
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    jstep = jax.jit(jax_make_train_step(jm, jopt,
                                        microbatches=microbatches))
    step = make_train_step(tm, topt, microbatches=microbatches)
    data = SyntheticTokens(jcfg.vocab, SEQS[family], B, seed=1)
    for i in range(3):
        b = data.batch(i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                      b.items()}, jax.random.PRNGKey(i))
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, i)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=E2E_LOSS_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
        assert int(met["step"]) == int(jmet["step"]) == i + 1
    assert_tree_close(state["params"], jstate["params"],
                      atol=E2E_PARAM_ATOL, rtol=E2E_PARAM_RTOL)
    assert_tree_close(state["opt"]["m"], jstate["opt"]["m"],
                      atol=E2E_PARAM_ATOL, rtol=E2E_PARAM_RTOL)


def test_microbatches_average_the_slices():
    """Two microbatches give the mean of the two half-batch gradients,
    accumulated in f32."""
    cfg = to_torch_config(JAX_LOOP_CFG)
    model = build_model(cfg)
    opt = get_optimizer("sgdm", lr=0.1, momentum=0.0, clip_norm=0.0)
    state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v)
         for k, v in SyntheticTokens(cfg.vocab, 32, 4, 0).batch(0).items()}
    two, m2 = make_train_step(model, opt, microbatches=2)(state, b, 0)
    halves = [make_train_step(model, opt)(state, {k: v[i:i + 2] for k, v
                                                  in b.items()}, 0)
              for i in (0, 2)]
    np.testing.assert_allclose(
        float(m2["loss"]), 0.5 * sum(float(m["loss"]) for _, m in halves),
        rtol=1e-6)
    for p0, p2, a, c in zip(_leaves(state["params"]),
                            _leaves(two["params"]),
                            _leaves(halves[0][0]["params"]),
                            _leaves(halves[1][0]["params"])):
        # p - lr * (g_a + g_c) / 2 = (p_a + p_c) / 2
        np.testing.assert_allclose(p2.numpy(), 0.5 * (a + c).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_hier_sync_names_the_roadmap():
    """``hier_sync=True`` runs only with a mesh whose ``pod`` axis is in
    scope; without one (or with a mesh lacking the axis) the step raises a
    ``ValueError`` that names it.  The multi-process step itself is held
    to JAX's in tests/test_torch_distrib.py."""
    from repro_torch.distrib import MeshShape, compat
    model = build_model(to_torch_config(JAX_LOOP_CFG))
    opt = get_optimizer("adamw")
    state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    b = {k: torch.from_numpy(v) for k, v in SyntheticTokens(
        JAX_LOOP_CFG.vocab, 16, 2, 0).batch(0).items()}
    step = make_train_step(model, opt, hier_sync=True)
    with pytest.raises(ValueError, match="'pod'"):
        step(state, b, 0)
    with compat.set_mesh(MeshShape((2, 2), ("data", "model"))), \
            pytest.raises(ValueError, match="'pod'"):
        step(state, b, 0)


def test_init_state_runs_on_the_card_unless_asked():
    model = build_model(to_torch_config(JAX_LOOP_CFG))
    opt = get_optimizer("adamw")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(model, opt, torch.Generator())
    state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    assert all(t.device.type == "cpu" for t in _leaves(state))
    assert state["opt"]["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# run_train_loop (tests/test_train_loop.py's cases)
# ---------------------------------------------------------------------------

CFG = to_torch_config(JAX_LOOP_CFG)


def _setup():
    model = build_model(CFG)
    opt = get_optimizer("adamw", lr=1e-3, weight_decay=0.0)
    state = init_state(model, opt, torch.Generator().manual_seed(0), "cpu")
    batch_fn = make_lm_batch_fn(CFG, ShapeSpec("t", 32, 4, "train"), seed=0)
    return state, make_train_step(model, opt), batch_fn


def test_failure_restart_bit_identical(tmp_path):
    total = 12
    state, step, batch_fn = _setup()
    ref = run_train_loop(LoopConfig(total, log_every=0), state, step,
                         batch_fn, log=None)["state"]

    # a run that dies at step 7, then restarts from the step-5 checkpoint
    state, step2, batch_fn = _setup()
    cfg = LoopConfig(total, ckpt_every=5, ckpt_dir=str(tmp_path),
                     log_every=0, fail_at=7)
    with pytest.raises(InjectedFailure):
        run_train_loop(cfg, state, step2, batch_fn, log=None)
    state, step3, batch_fn = _setup()     # a fresh process
    cfg2 = LoopConfig(total, ckpt_every=5, ckpt_dir=str(tmp_path),
                      log_every=0)
    out = run_train_loop(cfg2, state, step3, batch_fn, log=None)
    assert out["resumed_from"] == 5
    got, want = _leaves(out["state"]), _leaves(ref)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, want))


def test_loss_decreases_and_matches_the_jax_loop():
    state, step, batch_fn = _setup()
    out = run_train_loop(LoopConfig(30, log_every=5), state, step,
                         batch_fn, log=None)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert [h["at"] for h in out["history"]] == [5, 10, 15, 20, 25, 30]

    jm = jax_build_model(JAX_LOOP_CFG)
    jopt = jax_get_optimizer("adamw", lr=1e-3, weight_decay=0.0)
    state, _, _ = _setup()
    jparams = jax.tree.map(jnp.asarray,
                           model_params_to_numpy(state["params"]))
    jstate = {"params": jparams, "opt": jopt.init(jparams)}
    got = run_train_loop(LoopConfig(10, log_every=5), state, step, batch_fn,
                         log=None)["history"]
    want = jax_run_train_loop(
        JLoopConfig(10, log_every=5), jstate,
        jax.jit(jax_make_train_step(jm, jopt)),
        jax_batch_fn(JAX_LOOP_CFG, JShapeSpec("t", 32, 4, "train"), seed=0),
        log=None)["history"]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=E2E_LOSS_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-4)
        assert a["step"] == b["step"]
