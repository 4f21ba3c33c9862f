"""The port's LM layer stack (dense and zamba) against the JAX package's
(the moe and xlstm families: tests/test_torch_lm_families.py),
on the same inputs.

Params have the shapes of the JAX ``init`` and values drawn with numpy
from a seed; they cross the package boundary as numpy arrays, as do the
token batches.  The small config is ``oracle-zamba`` of
tests/test_kernel_oracle.py:210-224 (f32, 2 Mamba2 + 2 attention blocks,
T=32), whose end-to-end tolerances (``E2E_*``, :205-207) the stack and
step comparisons use; ``backend="cuda"`` runs the kernels' plain
versions here and is compared with JAX's ``backend="pallas"`` (Pallas in
interpret mode) or ``"ref"``.

With the int8 wire a last-bit difference between the frameworks can flip
one rounding at a crossing, which moves that activation element by one
scale step and every update upstream of it.  So the int8 step holds each
leaf's update ``p_new - p`` to ``INT8_UPDATE_RTOL`` = 1e-2 of the largest
entry of JAX's update (a dropped or doubled worker gradient moves it by
about ``b_worker / B``, tens of percent) and the loss to ``INT8_LOSS``
(relative).  Measured on these inputs: one flip at cuts (2, 4), 4.4e-3 of
the largest update and a loss 2.1e-6 apart; no flip at the other cuts
(1.2e-5 and 0).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.fig_lm_fleet import CONFIGS as JAX_FLEET_CONFIGS
from repro.configs import zamba2_7b as jzamba
from repro.core import cost_model as jcm
from repro.core import hybrid_step as jhs
from repro.models.lm import attention as jattn
from repro.models.lm import ssm as jssm
from repro.models.lm.layerstack import lm_layerstack as jax_lm_layerstack
from repro.models.lm.model import LMConfig as JaxLMConfig
from repro.models.lm.ssm import SSMConfig as JaxSSMConfig
from repro_torch.configs import zamba2_7b as tzamba
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import hybrid_step as ths
from repro_torch.core.cost_model import MultiSchedule, Schedule
from repro_torch.models.lm import attention as tattn
from repro_torch.models.lm import ssm as tssm
from repro_torch.models.lm.fleet_configs import FLEET_ATTN, FLEET_GLA
from repro_torch.models.lm.layerstack import lm_layerstack
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.ssm import SSMConfig
from repro_torch.models.lm.xlstm import XLSTMConfig
from tests.test_kernel_oracle import (E2E_LOSS_RTOL, E2E_PARAM_ATOL,
                                      E2E_PARAM_RTOL)
from tests.test_torch_hybrid_step import INT8_LOSS
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

JAX_BACKEND = {"ref": "ref", "cuda": "pallas"}
INT8_UPDATE_RTOL = 1e-2


def to_torch_config(cfg: JaxLMConfig) -> LMConfig:
    """The port's config with every field of ``cfg`` (dtype mapped)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dtype"] = getattr(torch, jnp.dtype(cfg.dtype).name)
    for name, cls in (("ssm", SSMConfig), ("moe", MoEConfig),
                      ("xlstm", XLSTMConfig)):
        if getattr(cfg, name) is not None:
            kw[name] = cls(**dataclasses.asdict(getattr(cfg, name)))
    return LMConfig(**kw)


def oracle_zamba(mod_cfg, mod_ssm, dtype):
    return mod_cfg(name="oracle-zamba", family="zamba", n_layers=2,
                   d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                   ssm=mod_ssm(d_state=16, head_dim=16, expand=2, chunk=32),
                   shared_attn_every=1, dtype=dtype)


SEQ = 32


def stacks(backend: str = "cuda", dtype: str = "float32"):
    """(JAX stack, port stack) of ``oracle-zamba`` at T=32."""
    jcfg = oracle_zamba(JaxLMConfig, JaxSSMConfig, getattr(jnp, dtype))
    tcfg = oracle_zamba(LMConfig, SSMConfig, getattr(torch, dtype))
    return (jax_lm_layerstack(jcfg, SEQ, JAX_BACKEND[backend]),
            lm_layerstack(tcfg, SEQ, backend))


def np_params(jstack, seed: int):
    """Params in the shapes and dtypes of the JAX ``init``, as numpy:
    weights N(0, 1/fan_in), SSM constants near their init values, small
    nonzero norm weights and biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jstack.init, jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if len(shape) >= 2:
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif name == "A_log":
            v = rng.uniform(-0.5, 0.5, shape)
        elif name == "dt_bias":
            v = -2.0 + 0.3 * rng.standard_normal(shape)
        elif name == "D_skip":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, dtype=np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def tokens(stack, B: int, seed: int, seq: int = SEQ):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, stack.cfg.vocab, (B, seq), dtype=np.int32)
    y = rng.integers(0, stack.cfg.vocab, (B, seq), dtype=np.int32)
    return x, y


def to_jax(p_np):
    return jax.tree.map(jnp.asarray, p_np)


def flat(tree):
    """Leaves of a nested dict in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat(tree[k])
        else:
            yield tree[k]


def assert_updates_close(start, got, want, rtol: float):
    """Each leaf's update ``got - start`` within ``rtol`` of the largest
    entry of ``want - start``."""
    for p0, pt, pj in zip(start, got, want):
        for a, b, c in zip(flat(p0), flat(pt), flat(pj)):
            u_t = b.detach().numpy() - a
            u_j = np.asarray(c) - a
            top = max(float(np.abs(u_j).max()), 1e-30)
            assert float(np.abs(u_t - u_j).max()) <= rtol * top


def assert_params_close(got, want, **tol):
    for pt, pj in zip(got, want):
        for a, b in zip(flat(pt), flat(pj)):
            np.testing.assert_allclose(a.detach().float().numpy(),
                                       np.asarray(b, np.float32), **tol)


E2E = dict(atol=E2E_PARAM_ATOL, rtol=E2E_PARAM_RTOL)


# ---------------------------------------------------------------------------
# Configs and cut meta
# ---------------------------------------------------------------------------


def test_config_copies_equal_jax():
    assert FLEET_GLA == to_torch_config(JAX_FLEET_CONFIGS["gla"])
    assert FLEET_ATTN == to_torch_config(JAX_FLEET_CONFIGS["attention"])
    assert tzamba.FULL == to_torch_config(jzamba.FULL)
    assert FLEET_GLA.dtype == tzamba.FULL.dtype == torch.bfloat16


ZAMBA_CUT = dict(n_layers=6, shared_attn_every=6)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("name", ["fleet-gla", "fleet-attn", "zamba2-7b"])
def test_cut_meta_equals_jax(name, backend):
    jcfg, tcfg = {"fleet-gla": (JAX_FLEET_CONFIGS["gla"], FLEET_GLA),
                  "fleet-attn": (JAX_FLEET_CONFIGS["attention"], FLEET_ATTN),
                  "zamba2-7b": (jzamba.FULL.variant(**ZAMBA_CUT),
                                tzamba.FULL.variant(**ZAMBA_CUT))}[name]
    js = jax_lm_layerstack(jcfg, 512, JAX_BACKEND[backend])
    ts = lm_layerstack(tcfg, 512, backend)
    assert [dataclasses.asdict(m) for m in ts.cut_meta()] == \
        [dataclasses.asdict(m) for m in js.cut_meta()]
    assert ts.name == js.name and ts.family == js.family
    assert ts.num_layers == js.num_layers
    assert ts.default_sample_bytes() == js.default_sample_bytes()
    assert ts.cfg.use_flash == ts.cfg.use_gla_kernel == (backend == "cuda")


def test_zamba2_7b_cut_runs_both_kernels_once_per_group():
    kinds = lm_layerstack(tzamba.FULL.variant(**ZAMBA_CUT), 512).block_kinds
    assert kinds == ("embed",) + ("mamba2",) * 6 + ("attn", "head")


def test_backend_validation():
    with pytest.raises(ValueError, match="backend"):
        lm_layerstack(FLEET_ATTN, 16, backend="pallas")


def test_init_matches_jax_layout_and_is_seeded():
    js, ts = stacks()
    shapes = jax.eval_shape(js.init, jax.random.PRNGKey(0))
    a = ts.init(torch.Generator().manual_seed(4))
    b = ts.init(torch.Generator().manual_seed(4))
    assert len(a) == len(shapes)
    for pt, pj, pb in zip(a, shapes, b):
        got = jax.tree_util.tree_structure({k: 0 for k in pt})
        assert got == jax.tree_util.tree_structure({k: 0 for k in pj})
        for x, s, y in zip(flat(pt), flat(pj), flat(pb)):
            assert tuple(x.shape) == s.shape
            assert str(x.dtype).split(".")[-1] == s.dtype.name
            assert torch.equal(x, y) and torch.isfinite(x).all()
    x, y = ts.dummy_batch(torch.Generator().manual_seed(1), 3)
    assert x.shape == y.shape == (3, SEQ) and int(x.max()) < 512


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


BLOCK_TOL = dict(rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_blocks_match_jax(backend):
    js, ts = stacks(backend)
    p = np_params(js, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, SEQ, 64)).astype(np.float32)
    use = backend == "cuda"
    cfg = ts.cfg
    kw = dict(n_heads=4, n_kv_heads=4, head_dim=16, causal=True,
              rope_theta=cfg.rope_theta)
    # cut-points: embed, mamba2, attn, mamba2, attn, head
    pa, pm = p[2]["attn"], p[1]["m"]
    ta = tattn.self_attention(params_from_numpy([pa])[0], torch.from_numpy(x),
                              use_flash=use, **kw)
    ja = jattn.self_attention(to_jax(pa), jnp.asarray(x), use_flash=use,
                              **kw)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **BLOCK_TOL)
    tm = tssm.apply_mamba2(params_from_numpy([pm])[0], torch.from_numpy(x),
                           cfg.ssm, use_kernel=use)
    jm = jssm.apply_mamba2(to_jax(pm), jnp.asarray(x), js.cfg.ssm,
                           use_kernel=use)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **BLOCK_TOL)


def test_windowed_gqa_block_matches_jax():
    """A dense block with GQA (rep 2) and a sliding window."""
    jcfg = JaxLMConfig(name="w", family="dense", n_layers=1, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=96, vocab=64,
                       sliding_window=8, dtype=jnp.float32)
    js = jax_lm_layerstack(jcfg, SEQ, "pallas")
    ts = lm_layerstack(to_torch_config(jcfg), SEQ, "cuda")
    p = np_params(js, 3)
    x, _ = tokens(ts, 2, 4)
    got = ts.apply_segment(params_from_numpy(p), torch.from_numpy(x), 0, 2)
    want = js.apply_segment(to_jax(p), jnp.asarray(x), 0, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


# ---------------------------------------------------------------------------
# The stack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_apply_segment_and_sum_loss_match_jax(backend):
    js, ts = stacks(backend)
    p = np_params(js, 5)
    x, y = tokens(ts, 3, 6)
    tp, jp = params_from_numpy(p), to_jax(p)
    h = torch.from_numpy(x)
    jh = jnp.asarray(x)
    for a, b in ((0, 2), (2, 4), (4, 6)):         # chained segments
        h = ts.apply_segment(tp, h, a, b)
        jh = js.apply_segment(jp, jh, a, b)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), **E2E)
    loss = ts.sum_loss(h, torch.from_numpy(y))
    jloss = js.sum_loss(jh, jnp.asarray(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=E2E_LOSS_RTOL)


# ---------------------------------------------------------------------------
# The hybrid step
# ---------------------------------------------------------------------------

CUTS = [(1, 2), (2, 4), (3, 5)]


def schedules(m_s: int, m_l: int):
    tri = ("cloud", "edge", "device", m_s, m_l, 3, 3, 3)
    star = dict(worker_o="cloud", worker_l="device_1",
                s_workers=("device_0", "edge"), m_s=(m_s, m_s - 1), m_l=m_l,
                b_o=3, b_s=(2, 2), b_l=2)
    return tri, star


@pytest.mark.parametrize("wire", ["none", "int8"])
@pytest.mark.parametrize("m_s,m_l", CUTS)
def test_hybrid_step_matches_jax(m_s, m_l, wire):
    """Port ``backend="cuda"`` against JAX ``backend="ref"``, on the
    triple and on a two-stream star."""
    js, ts = stacks("cuda")
    js = jax_lm_layerstack(js.cfg.variant(use_flash=False,
                                          use_gla_kernel=False), SEQ, "ref")
    p = np_params(js, 7)
    x, y = tokens(ts, 9, 8)
    tri, star = schedules(m_s, m_l)
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


@pytest.mark.parametrize("m_s,m_l", CUTS)
def test_hybrid_step_equals_reference_sgd(m_s, m_l):
    _, ts = stacks("cuda")
    p = params_from_numpy(np_params(_jax_stack(), 9))
    x, y = (torch.from_numpy(a) for a in tokens(ts, 9, 10))
    ref, rl = ths.reference_sgd_step(ts, p, x, y, 0.05)
    hyb, hl = ths.hybrid_step_from_schedule(
        ts, p, x, y, Schedule("cloud", "edge", "device", m_s, m_l, 3, 3, 3),
        0.05)
    np.testing.assert_allclose(float(hl), float(rl), rtol=E2E_LOSS_RTOL)
    for a, b in zip(hyb, ref):
        for u, v in zip(flat(a), flat(b)):
            np.testing.assert_allclose(u.numpy(), v.numpy(), **E2E)


def _jax_stack():
    return stacks("cuda")[0]


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_m1_star_equals_triple_bitwise(wire):
    _, ts = stacks("cuda")
    p = params_from_numpy(np_params(_jax_stack(), 11))
    x, y = (torch.from_numpy(a) for a in tokens(ts, 10, 12))
    for m_s, m_l, b_o, b_s, b_l in ((1, 3, 3, 4, 3), (2, 2, 4, 6, 0),
                                    (0, 5, 6, 0, 4)):
        tri = Schedule("cloud", "edge", "device", m_s, m_l, b_o, b_s, b_l)
        pt, lt = ths.hybrid_step_from_schedule(ts, p, x, y, tri, 0.05,
                                               wire=wire)
        ps, ls = ths.multi_hybrid_step_from_schedule(
            ts, p, x, y, MultiSchedule.from_schedule(tri), 0.05, wire=wire)
        assert torch.equal(lt, ls)
        assert all(torch.equal(a, b) for q, r in zip(pt, ps)
                   for a, b in zip(flat(q), flat(r)))


# ---------------------------------------------------------------------------
# Params across the boundary
# ---------------------------------------------------------------------------


def test_bf16_nested_params_round_trip_bitwise():
    js, ts = stacks("ref", "bfloat16")
    jp = js.init(jax.random.PRNGKey(3))
    np_p = jax.tree.map(np.asarray, jp)
    leaf = np_p[1]["m"]["in_proj"]
    assert leaf.dtype.name == "bfloat16"
    tp = params_from_numpy(np_p)
    back = params_to_numpy(tp)
    for q, r, s in zip(np_p, tp, back):
        for a, b, c in zip(flat(q), flat(r), flat(s)):
            assert str(b.dtype).split(".")[-1] == a.dtype.name
            if a.dtype.name == "bfloat16":
                assert np.array_equal(b.view(torch.int16).numpy(),
                                      a.view(np.int16))
                assert c.dtype == np.float32
                assert np.array_equal(
                    np.asarray(jnp.asarray(c, jnp.bfloat16)).view(np.int16),
                    a.view(np.int16))
            else:
                assert np.array_equal(c.view(np.int32), a.view(np.int32))
            assert np.array_equal(c.astype(np.float32).view(np.int32),
                                  a.astype(np.float32).view(np.int32))
