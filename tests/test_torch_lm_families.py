"""The port's LM layer stack for the moe and xlstm families against the
JAX package's, on the same inputs.

The configs are the reference's tiny f32 ones (tests/test_lm_layerstack.py:
30-58): tiny-moe (3 blocks, 4 experts top-2, lossless capacity) at T=32
and tiny-xlstm (mLSTM, sLSTM, mLSTM, sLSTM) at T=48, since at T=32 the
two libraries' f32 ``exp`` had moved the sLSTM's ``n`` carry by 1.1e-5
(tests/test_torch_xlstm.py).  Params and tokens cross the boundary as
numpy arrays (``np_params``, ``tokens``), and the tolerances are those of
tests/test_torch_lm.py: the end-to-end ones of the oracle suite with
``wire="none"``, and with the int8 wire the loss to ``INT8_LOSS`` and
each leaf's update to ``INT8_UPDATE_RTOL`` of JAX's largest.

MoE exactness: the hybrid step is batch-B SGD when no token is dropped,
or when every dispatch group the split runs is one of the whole batch's,
so that which tokens an expert drops does not depend on the split: every
group is one sequence (``group_size == T``), or a group spans sequences
and every MoE block runs on a merge of the streams (which keeps the
batch's order) whose sub-batches hold whole groups.  fleet-moe's M=4
plan on the card is of the second kind; the tests here hold both to
vanilla SGD on a tiny config that drops tokens.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch.api as tapi
from benchmarks.fig_lm_fleet import CONFIGS as JAX_FLEET_CONFIGS
from repro.configs import qwen2_moe_a2_7b as jqwen
from repro.configs import xlstm_350m as jxlstm
from repro.core import cost_model as jcm
from repro.core import hybrid_step as jhs
from repro.models.lm.layerstack import lm_layerstack as jax_lm_layerstack
from repro_torch.configs import qwen2_moe_a2_7b as tqwen
from repro_torch.configs import xlstm_350m as txlstm
from repro_torch.convert import params_from_numpy
from repro_torch.core import hybrid_step as ths
from repro_torch.core.cost_model import MultiSchedule, Schedule
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.models.lm import moe as moe_mod
from repro_torch.models.lm.fleet_configs import FLEET_MOE, FLEET_XLSTM
from repro_torch.models.lm.layerstack import FAMILY_LABELS, lm_layerstack
from tests.test_kernel_oracle import E2E_LOSS_RTOL
from tests.test_lm_layerstack import CFGS as JAX_TINY
from tests.test_torch_hybrid_step import INT8_LOSS
from tests.test_torch_lm import (E2E, INT8_UPDATE_RTOL, JAX_BACKEND,
                                 assert_params_close, assert_updates_close,
                                 flat, np_params, schedules, to_jax,
                                 to_torch_config, tokens)
from tests.test_torch_serve import one_thread  # noqa: F401  (fixture)
from tests.test_torch_train_int8_lm import TokenData

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ("moe", "xlstm")
SEQS = {"moe": 32, "xlstm": 48}


def stacks(family: str, backend: str = "cuda", **cfg_kw):
    """(JAX stack, port stack) of the reference's tiny ``family`` config
    at its T here, with ``cfg_kw`` replaced."""
    jcfg = JAX_TINY[family].variant(**cfg_kw)
    T = SEQS[family]
    return (jax_lm_layerstack(jcfg, T, JAX_BACKEND[backend]),
            lm_layerstack(to_torch_config(jcfg), T, backend))


# ---------------------------------------------------------------------------
# Configs and cut meta
# ---------------------------------------------------------------------------


def test_fleet_config_copies_equal_jax():
    assert FLEET_MOE == to_torch_config(JAX_FLEET_CONFIGS["moe"])
    assert FLEET_XLSTM == to_torch_config(JAX_FLEET_CONFIGS["xlstm"])
    assert FLEET_MOE.moe.group_size == 1024
    assert FLEET_MOE.moe.capacity_factor == 1.25
    assert FLEET_XLSTM.xlstm.chunk == 128


CUT_CONFIGS = {
    "fleet-moe": (JAX_FLEET_CONFIGS["moe"], FLEET_MOE),
    "fleet-xlstm": (JAX_FLEET_CONFIGS["xlstm"], FLEET_XLSTM),
    "qwen2-moe-a2.7b": (jqwen.FULL.variant(n_layers=2),
                        tqwen.FULL.variant(n_layers=2)),
    "xlstm-350m": (jxlstm.FULL.variant(n_layers=8),
                   txlstm.FULL.variant(n_layers=8)),
}


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("name", sorted(CUT_CONFIGS))
def test_cut_meta_equals_jax(name, backend):
    jcfg, tcfg = CUT_CONFIGS[name]
    T = 2048 if name in ("qwen2-moe-a2.7b", "xlstm-350m") else 512
    js = jax_lm_layerstack(jcfg, T, JAX_BACKEND[backend])
    ts = lm_layerstack(tcfg, T, backend)
    assert [dataclasses.asdict(m) for m in ts.cut_meta()] == \
        [dataclasses.asdict(m) for m in js.cut_meta()]
    assert ts.name == js.name and ts.family == js.family
    assert ts.num_layers == js.num_layers
    assert ts.cfg.use_flash == ts.cfg.use_gla_kernel == (backend == "cuda")


def test_block_plans():
    moe = lm_layerstack(FLEET_MOE, 512).block_kinds
    assert moe == ("embed",) + ("moe",) * 10 + ("head",)
    xl = lm_layerstack(txlstm.FULL.variant(n_layers=8), 2048).block_kinds
    assert xl == ("embed",) + ("mlstm",) * 7 + ("slstm", "head")
    fx = lm_layerstack(FLEET_XLSTM, 512).block_kinds
    assert fx == ("embed",) + (("mlstm",) * 3 + ("slstm",)) * 3 + ("head",)


def test_card_plan_runs_fleet_moe_on_whole_groups():
    """fleet-moe's M=4 plan at B=64 (as ``chip_smoke.py`` plans it) keeps
    the embed alone below the crossing, so each MoE block runs once a
    step, on the merged batch of 64 sequences: 32 whole groups of 1,024
    tokens at T=512."""
    stack = lm_layerstack(FLEET_MOE, 512, "cuda")
    sched = tapi.plan(stack, tapi.Fleet.lm_default(m=4, wire="int8"),
                      64).multi_schedule
    assert sched.m_l <= 1 and max(sched.m_s) <= 1
    assert chip_smoke.expected_lm_launches(stack, sched, "int8")[
        "flash_attention"] == FLEET_MOE.n_layers
    assert 64 * 512 % FLEET_MOE.moe.group_size == 0


@pytest.mark.parametrize("family", ["encdec", "vlm"])
def test_unschedulable_configs_raise(family):
    cfg = to_torch_config(JAX_TINY["attention"])
    cfg = cfg.variant(family="encdec", encoder_layers=2) \
        if family == "encdec" else cfg.variant(n_frontend_tokens=4)
    with pytest.raises(ValueError):
        lm_layerstack(cfg, 16)


def paths(tree, prefix=()):
    """Key paths of a nested dict's leaves in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("family", FAMILIES)
def test_params_match_meta_and_jax_layout(family):
    js, ts = stacks(family)
    shapes = jax.eval_shape(js.init, jax.random.PRNGKey(0))
    params = ts.init(torch.Generator().manual_seed(4))
    assert [m.param_count for m in ts.cut_meta()] == \
        [sum(t.numel() for t in flat(p)) for p in params]
    assert ts.family == FAMILY_LABELS[family]
    assert len(params) == len(shapes) == ts.num_layers
    for pt, pj in zip(params, shapes):
        assert list(paths(pt)) == list(paths(pj))
        for x, s in zip(flat(pt), flat(pj)):
            assert tuple(x.shape) == s.shape
            assert str(x.dtype).split(".")[-1] == s.dtype.name
            assert torch.isfinite(x).all()


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("family", FAMILIES)
def test_apply_segment_and_sum_loss_match_jax(family, backend, one_thread):
    js, ts = stacks(family, backend)
    p = np_params(js, 5)
    x, y = tokens(ts, 3, 6, SEQS[family])
    tp, jp = params_from_numpy(p), to_jax(p)
    h, jh = torch.from_numpy(x), jnp.asarray(x)
    N = ts.num_layers
    jseg = jax.jit(js.apply_segment, static_argnums=(2, 3))
    for a, b in ((0, 2), (2, N - 1), (N - 1, N)):      # chained segments
        h = ts.apply_segment(tp, h, a, b)
        jh = jseg(jp, jh, a, b)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **E2E)
    loss = ts.sum_loss(h, torch.from_numpy(y))
    jloss = js.sum_loss(jh, jnp.asarray(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=E2E_LOSS_RTOL)


# ---------------------------------------------------------------------------
# The hybrid step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("family", FAMILIES)
def test_hybrid_step_matches_jax(family, wire, one_thread):
    """Port ``backend="cuda"`` against JAX ``backend="ref"``, on the
    triple and on a two-stream star, at cuts (2, 3) of the tiny config
    cut to two blocks (moe, moe; mlstm, slstm), which halves JAX's
    compile."""
    js, ts = stacks(family, "ref", n_layers=2)
    ts = lm_layerstack(ts.cfg, ts.seq_len, "cuda")
    p = np_params(js, 7)
    x, y = tokens(ts, 9, 8, SEQS[family])
    tri, star = schedules(2, 3)
    runs = ((jcm.Schedule(*tri), Schedule(*tri),
             jhs.hybrid_step_from_schedule, ths.hybrid_step_from_schedule),
            (jcm.MultiSchedule(**star), MultiSchedule(**star),
             jhs.multi_hybrid_step_from_schedule,
             ths.multi_hybrid_step_from_schedule))
    for jsched, tsched, jrun, trun in runs:
        jp, jl = jax.jit(lambda q, a, b: jrun(js, q, a, b, jsched, 0.05,
                                              wire=wire))(
            to_jax(p), jnp.asarray(x), jnp.asarray(y))
        tp, tl = trun(ts, params_from_numpy(p), torch.from_numpy(x),
                      torch.from_numpy(y), tsched, 0.05, wire=wire)
        if wire == "none":
            np.testing.assert_allclose(float(tl), float(jl),
                                       rtol=E2E_LOSS_RTOL)
            assert_params_close(tp, jp, **E2E)
        else:
            assert abs(float(tl) - float(jl)) <= INT8_LOSS * abs(float(jl))
            assert_updates_close(p, tp, jp, INT8_UPDATE_RTOL)


def assert_sgd_equal(ts, params, x, y, sched, run):
    ref, rl = ths.reference_sgd_step(ts, params, x, y, 0.05)
    hyb, hl = run(ts, params, x, y, sched, 0.05)
    np.testing.assert_allclose(float(hl), float(rl), rtol=E2E_LOSS_RTOL)
    for a, b in zip(hyb, ref):
        for u, v in zip(flat(a), flat(b)):
            np.testing.assert_allclose(u.numpy(), v.numpy(), **E2E)


@pytest.mark.parametrize("family", FAMILIES)
def test_hybrid_step_equals_reference_sgd(family, one_thread):
    js, ts = stacks(family)
    p = params_from_numpy(np_params(js, 9))
    x, y = (torch.from_numpy(a) for a in tokens(ts, 9, 10, SEQS[family]))
    tri, star = schedules(1, ts.num_layers - 1)
    assert_sgd_equal(ts, p, x, y, Schedule(*tri),
                     ths.hybrid_step_from_schedule)
    assert_sgd_equal(ts, p, x, y, MultiSchedule(**star),
                     ths.multi_hybrid_step_from_schedule)


def merged_pairs_star():
    """A star whose streams merge after the embed, every split even."""
    return dict(worker_o="cloud", worker_l="device_1",
                s_workers=("device_0", "edge"), m_s=(1, 1), m_l=1, b_o=2,
                b_s=(2, 4), b_l=2)


@pytest.mark.parametrize("seqs", [1, 2])
def test_moe_whole_groups_equal_sgd_though_tokens_drop(seqs, one_thread):
    """Capacity 1.25 with groups the split keeps whole: the hybrid split
    drops the tokens the whole batch drops.  One sequence a group on the
    triple and the star, whose streams split mid-stack (B=9); two a
    group on a star that merges after the embed (B=10)."""
    T = SEQS["moe"]
    moe = dataclasses.replace(JAX_TINY["moe"].moe, group_size=seqs * T,
                              capacity_factor=1.25)
    js, ts = stacks("moe", moe=moe)
    p = params_from_numpy(np_params(js, 11))
    x, y = (torch.from_numpy(a) for a in tokens(ts, 8 + seqs, 12, T))
    C = moe_mod.capacity(ts.cfg.moe, seqs * T)
    dropped = []

    def count(idx):                     # [b, T, K]: seqs rows a group
        per_expert = torch.nn.functional.one_hot(
            idx.reshape(idx.shape[0] // seqs, -1),
            ts.cfg.moe.n_experts).sum(1)
        dropped.append(int((per_expert - C).clamp(min=0).sum()))
        return idx

    with moe_mod.routing(count):
        ths.reference_sgd_step(ts, p, x, y, 0.05)
    assert sum(dropped) > 0, "the config must drop tokens"
    if seqs == 1:
        tri, star = schedules(2, 3)
        assert_sgd_equal(ts, p, x, y, Schedule(*tri),
                         ths.hybrid_step_from_schedule)
    else:
        star = merged_pairs_star()
    assert_sgd_equal(ts, p, x, y, MultiSchedule(**star),
                     ths.multi_hybrid_step_from_schedule)


@pytest.mark.parametrize("family", FAMILIES)
def test_plan_train_takes_two_steps(family, one_thread):
    _, ts = stacks(family)
    p = tapi.plan(ts, tapi.Fleet.lm_default(m=2), 8)
    data = TokenData(SyntheticTokens(ts.cfg.vocab, ts.seq_len, 8, 0))
    out = p.train(data, steps=2, lr=1e-3, device="cpu")
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert len(out["params"]) == ts.num_layers
