"""The int8 wire's loss gap: the port against the JAX package, step for
step, on fleet-xlstm and on the rehearsal's toy fleet-moe twin.

``chip_smoke.py`` holds each fleet stack's int8-vs-none per-token loss
gap on the card to ``E2E_LOSS_GAP``, and fleet-xlstm's to the larger of
that and its precision floor (``chip_smoke.GAP_FLOOR_STACKS``).  This is
the witness for the exception: at the smoke's lr the reference's own
int8 wire moves this stack past ``E2E_LOSS_GAP`` after one update, and
the port's moves it as far.

fleet-xlstm is cut to its first 4 blocks (3 mLSTM, 1 sLSTM) at its
published widths, T=64 (the sLSTM compares at T >= 48,
tests/test_torch_xlstm.py), B=8, f32, from the port's bf16 init widened
exactly, on the card's M=4 plan shape: worker o keeps 3 sequences and
TASK L's 5 cross the int8 wire after the embed, as 26 and 38 of 64 do on
the card.  ``tests/int8_gap_probe.py`` runs the same measurement over
more steps, in bf16 and f32, with the precision floor.

The toy fleet-moe twin of tests/test_torch_smoke_training.py (d_model
64, vocab 512, T=32, B=16) at fleet-moe's groups of two sequences flips
routes under the wire: its gap passes ``E2E_LOSS_GAP`` in both packages
alike.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from benchmarks.fig_lm_fleet import CONFIGS as JAX_FLEET_CONFIGS
from repro.core import cost_model as jcm
from repro.core import hybrid_step as jhs
from repro.models.lm.layerstack import lm_layerstack as jax_lm_layerstack
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import hybrid_step as ths
from repro_torch.core.cost_model import MultiSchedule
from repro_torch.models.lm.layerstack import lm_layerstack
from tests.test_kernel_oracle import E2E_LOSS_RTOL
from tests.test_torch_hybrid_step import INT8_LOSS
from tests.test_torch_lm import to_torch_config
from tests.test_torch_serve import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def card_plan_shape(B: int) -> dict:
    """The M=4 plan's shape at batch ``B``: no TASK-S stream carries
    samples, TASK L's stream crosses after the embed with 38/64 of the
    batch."""
    b_l = B * 38 // 64
    return dict(worker_o="cloud", worker_l="edge", s_workers=("device_0",),
                m_s=(0,), m_l=1, b_o=B - b_l, b_s=(0,), b_l=b_l)


class GapRun:
    """One fleet stack cut to ``n_layers`` blocks at ``T`` and ``B``:
    shared params and batch, and each package's per-token losses over
    steps of the multi-stream hybrid step."""

    def __init__(self, family: str, n_layers: int, T: int, B: int,
                 lr: float, **cfg_kw):
        self.base = JAX_FLEET_CONFIGS[family].variant(n_layers=n_layers,
                                                      **cfg_kw)
        self.T, self.lr = T, lr
        self.sched = card_plan_shape(B)
        stack = lm_layerstack(to_torch_config(self.base), T, "cuda")
        self.params = params_to_numpy(
            stack.init(torch.Generator().manual_seed(chip_smoke.SEED)))
        self.x, self.y = stack.dummy_batch(
            torch.Generator().manual_seed(chip_smoke.BATCH_SEED), B)

    def losses(self, package: str, dtype: str, wire: str, steps: int):
        jcfg = self.base.variant(dtype=DTYPES[dtype])
        js = jax_lm_layerstack(jcfg, self.T, "ref")
        # each leaf in its init dtype (the port's init layout is JAX's,
        # tests/test_torch_lm_families.py); bf16 values are exact
        p = jax.tree.map(lambda a, s: np.asarray(a).astype(s.dtype),
                         self.params,
                         jax.eval_shape(js.init, jax.random.PRNGKey(0)))
        if package == "jax":
            p = jax.tree.map(jnp.asarray, p)
            sched = jcm.MultiSchedule(**self.sched)
            step = jax.jit(lambda q, a, b: jhs.multi_hybrid_step_from_schedule(
                js, q, a, b, sched, self.lr, wire=wire))
            x = jnp.asarray(self.x.numpy().astype(np.int32))
            y = jnp.asarray(self.y.numpy().astype(np.int32))
        else:
            ts = lm_layerstack(to_torch_config(jcfg), self.T, "cuda")
            p = params_from_numpy(p)
            sched = MultiSchedule(**self.sched)

            def step(q, a, b):
                return ths.multi_hybrid_step_from_schedule(
                    ts, q, a, b, sched, self.lr, wire=wire)
            x, y = self.x, self.y
        out = []
        for _ in range(steps):
            p, loss = step(p, x, y)
            out.append(float(loss) / self.T)
        return out


def test_port_int8_gap_follows_jax_past_the_budget(one_thread):
    run = GapRun("xlstm", 4, 64, 8, chip_smoke.LM_LR)
    got = {(pkg, wire): run.losses(pkg, "f32", wire, 2)
           for pkg in ("jax", "torch") for wire in ("none", "int8")}
    for k in range(2):
        np.testing.assert_allclose(got["torch", "none"][k],
                                   got["jax", "none"][k], rtol=E2E_LOSS_RTOL)
        np.testing.assert_allclose(got["torch", "int8"][k],
                                   got["jax", "int8"][k], rtol=INT8_LOSS)
    gap = {pkg: [abs(a - b) for a, b in zip(got[pkg, "int8"],
                                            got[pkg, "none"])]
           for pkg in ("jax", "torch")}
    # the forward's quantization alone, then one quantized update
    assert gap["jax"][0] < chip_smoke.E2E_LOSS_GAP < gap["jax"][1]
    bound = 2 * INT8_LOSS * got["jax", "int8"][1]
    for k in range(2):
        assert abs(gap["torch"][k] - gap["jax"][k]) <= bound


def test_toy_moe_twin_gap_follows_jax_past_the_budget(one_thread):
    T = 32
    moe = JAX_FLEET_CONFIGS["moe"].moe
    run = GapRun("moe", 4, T, 16, chip_smoke.LM_LR, d_model=64, n_heads=4,
                 n_kv_heads=4, d_ff=128, vocab=512,
                 moe=dataclasses.replace(moe, d_ff_expert=64,
                                         group_size=2 * T))
    steps = chip_smoke.LM_STEPS
    got = {(pkg, wire): run.losses(pkg, "f32", wire, steps)
           for pkg in ("jax", "torch") for wire in ("none", "int8")}
    gap = {pkg: [abs(a - b) for a, b in zip(got[pkg, "int8"],
                                            got[pkg, "none"])]
           for pkg in ("jax", "torch")}
    assert max(gap["jax"]) > chip_smoke.E2E_LOSS_GAP
    for k in range(steps):
        bound = 2 * INT8_LOSS * got["jax", "int8"][k]
        assert abs(gap["torch"][k] - gap["jax"][k]) <= bound
