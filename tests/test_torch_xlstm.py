"""The port's xLSTM blocks (``models/lm/xlstm.py``) against the JAX
package's, block by block, on the same params (the JAX ``init``, carried
over leaf by leaf) and inputs (numpy, from a seed), in f32: the mLSTM's
forward, prefill (its cache: conv state, S and n) and decode steps on
both GLA routes, and the sLSTM's (a loop over steps where the reference
scans), at xlstm-350m's head widths (mLSTM 512, sLSTM 256) and at
narrow ones.  Each leaf within 1e-5 of its largest magnitude; on the
kernel route the mLSTM output at the f32 ``gla_y`` budget against JAX's
Pallas GLA in interpret mode.

And a wide-head xLSTM model (one mLSTM head of 512: d_model 256, expand
2, and sLSTM heads of 256, as xlstm-350m has), T=64, against JAX through
``build_model`` on both routes (the Pallas GLA at dk = 512 in interpret
mode included), with tests/test_torch_serve.py's checks.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import xlstm as jx
from repro.models.lm.model import build_model as jax_build_model
from repro_torch.convert import model_params_from_numpy
from repro_torch.models.lm import model as tmodel
from repro_torch.models.lm import xlstm as tx
from tests import test_torch_serve as ts
from tests.test_torch_serve import (assert_plain_close,  # noqa: F401
                                    one_thread)
from tests.test_torch_serve_families import forward_close
from tests.test_torch_serve_kernels import budget_close

jax.config.update("jax_platform_name", "cpu")
pytestmark = pytest.mark.usefixtures("one_thread")

B, T, N_DEC = 2, 48, 3
# (d_model, heads): mLSTM head width 2 d_model / heads, sLSTM d_model / heads
WIDTHS = [pytest.param(256, 1, id="mlstm512_slstm256"),
          pytest.param(64, 2, id="mlstm64_slstm32")]


def setup(d_model: int, heads: int, init, seed: int = 0):
    jcfg = jx.XLSTMConfig(n_heads=heads, slstm_every=2, chunk=16)
    tcfg = tx.XLSTMConfig(n_heads=heads, slstm_every=2, chunk=16)
    jp = init(jax.random.PRNGKey(seed), d_model, jcfg, jnp.float32)
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((B, T + N_DEC, d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def close_trees(got, want, what: str) -> None:
    got = jax.tree.map(lambda t: t.numpy(), got,
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    for name in want:
        assert_plain_close(got[name], want[name], f"{what} {name}")


@pytest.mark.parametrize("d_model,heads", WIDTHS)
def test_mlstm_prefill_and_decode_match_jax(d_model, heads):
    jcfg, tcfg, jp, tp, x = setup(d_model, heads, jx.init_mlstm)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    with torch.no_grad():
        y, cache = tx.prefill_mlstm(tp, xt[:, :T], tcfg)
        jy, jcache = jx.prefill_mlstm(jp, xj[:, :T], jcfg)
        assert_plain_close(y.numpy(), jy, "mLSTM prefill y")
        close_trees(cache, jcache, "mLSTM prefill cache")
        assert cache["S"].shape == (B, heads, 2 * d_model // heads,
                                    2 * d_model // heads)
        assert_plain_close(tx.apply_mlstm(tp, xt[:, :T], tcfg).numpy(), jy,
                           "mLSTM forward")
        for i in range(N_DEC):
            step = slice(T + i, T + i + 1)
            y, cache = tx.decode_mlstm(tp, xt[:, step], cache, tcfg)
            jy, jcache = jx.decode_mlstm(jp, xj[:, step], jcache, jcfg)
            assert_plain_close(y.numpy(), jy, f"mLSTM decode {i}")
            close_trees(cache, jcache, f"mLSTM decode {i} cache")


@pytest.mark.parametrize("d_model,heads", WIDTHS)
def test_mlstm_kernel_route_matches_jax_interpret(d_model, heads):
    jcfg, tcfg, jp, tp, x = setup(d_model, heads, jx.init_mlstm, seed=3)
    close = budget_close("gla_y")
    with torch.no_grad():
        y, cache = tx.prefill_mlstm(tp, torch.from_numpy(x[:, :T]), tcfg,
                                    use_kernel=True)
    jy, jcache = jx.prefill_mlstm(jp, jnp.asarray(x[:, :T]), jcfg,
                                  use_kernel=True)
    close(y.numpy(), jy, "mLSTM kernel-route prefill y")
    for name in ("S", "n"):
        close(cache[name].numpy(), jcache[name], f"mLSTM kernel-route {name}")


@pytest.mark.parametrize("d_model,heads", WIDTHS)
def test_slstm_prefill_and_decode_match_jax(d_model, heads):
    jcfg, tcfg, jp, tp, x = setup(d_model, heads, jx.init_slstm, seed=5)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    with torch.no_grad():
        y, cache = tx.prefill_slstm(tp, xt[:, :T], tcfg)
        jy, jcache = jx.prefill_slstm(jp, xj[:, :T], jcfg)
        assert_plain_close(y.numpy(), jy, "sLSTM prefill y")
        close_trees(cache, jcache, "sLSTM prefill carry")
        assert_plain_close(tx.apply_slstm(tp, xt[:, :T], tcfg).numpy(), jy,
                           "sLSTM forward")
        for i in range(N_DEC):
            step = slice(T + i, T + i + 1)
            y, cache = tx.decode_slstm(tp, xt[:, step], cache, tcfg)
            jy, jcache = jx.decode_slstm(jp, xj[:, step], jcache, jcfg)
            assert_plain_close(y.numpy(), jy, f"sLSTM decode {i}")
            close_trees(cache, jcache, f"sLSTM decode {i} carry")


@pytest.mark.parametrize("init_name", ("init_mlstm", "init_slstm"))
def test_init_matches_the_jax_layout(init_name):
    jcfg = jx.XLSTMConfig(n_heads=2)
    tcfg = tx.XLSTMConfig(n_heads=2)
    want = jax.eval_shape(
        lambda k: getattr(jx, init_name)(k, 64, jcfg, jnp.bfloat16),
        jax.random.PRNGKey(0))
    got = getattr(tx, init_name)(torch.Generator().manual_seed(0), 64, tcfg,
                                 torch.bfloat16)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), got,
                        is_leaf=lambda t: isinstance(t, torch.Tensor)) == \
        jax.tree.map(lambda s: (tuple(s.shape),
                                f"torch.{jnp.dtype(s.dtype).name}"), want)


# ---------------------------------------------------------------------------
# a wide-head xLSTM: the GLA at dk = dv = 512
# ---------------------------------------------------------------------------

WIDE_T = 64


def wide_configs(kernels: bool):
    """(JAX, port) configs: xlstm-350m's head widths (mLSTM 512, sLSTM
    256) at d_model 256 with one head, an mLSTM and an sLSTM block."""
    out = []
    for pkg, xcls in ((jax_build_model, jx.XLSTMConfig),
                      (tmodel.build_model, tx.XLSTMConfig)):
        smoke = ts.smoke_configs("xlstm-350m")[pkg is tmodel.build_model]
        out.append(smoke.variant(
            name="xlstm-wide", d_model=256, n_layers=2,
            xlstm=xcls(n_heads=1, expand=2, d_conv=4, slstm_every=2,
                       chunk=32),
            use_flash=kernels, use_gla_kernel=kernels))
    return tuple(out)


@contextlib.contextmanager
def wide_prompts():
    """tests/test_torch_serve.py's helpers at ``WIDE_T`` prompt tokens."""
    old, ts.T = ts.T, WIDE_T
    try:
        yield
    finally:
        ts.T = old


@functools.lru_cache(maxsize=None)
def wide_run(kernels: bool) -> dict:
    with wide_prompts():
        return ts.run_configs(*wide_configs(kernels))


@pytest.mark.parametrize("kernels", (False, True), ids=("plain", "kernels"))
def test_wide_head_xlstm_matches_jax(kernels):
    jcfg, tcfg = wide_configs(kernels)
    assert jcfg.d_model * jcfg.xlstm.expand // jcfg.xlstm.n_heads == 512
    out = wide_run(kernels)
    close = budget_close("gla_y") if kernels else None
    ts.check("xlstm-wide", kernels, range(ts.N_DEC + 1), close, out=out)
    # the mLSTM's recurrent state S: [B, 1, 512, 512]
    assert any(a.shape[-2:] == (512, 512) for a in out["port"]["caches"][0])
    np.testing.assert_array_equal(out["port"]["tokens"],
                                  out["jax"]["tokens"])


def wide_hidden_close(got, want, what: str) -> None:
    """The plain rule at twice 1e-5 for the wide xLSTM's residual stream
    (``hidden_fn`` at every position, before the final norm): there each
    package's f32 rounding of 512-term sums, through the sLSTM's
    exponential gates, reaches about 1e-5 of the largest magnitude on its
    own, and the two packages' add."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"{what}: {err / top:.3e} of the largest magnitude (allowed "
          f"{2 * ts.PLAIN_RTOL:.0e})")
    assert err <= 2 * ts.PLAIN_RTOL * top, f"{what}: {err:.3e} of {top:.3e}"


@pytest.mark.parametrize("kernels", (False, True), ids=("plain", "kernels"))
def test_wide_head_xlstm_hidden_and_loss_match_jax(kernels):
    jcfg, tcfg = wide_configs(kernels)
    close = forward_close(tcfg) if kernels else wide_hidden_close
    with wide_prompts():
        ts.hidden_and_loss_match(jcfg, tcfg, "xlstm-wide", close)


def test_chip_smoke_splits_the_prefill_at_the_slstm_step_loop(monkeypatch):
    """``chip_smoke.split_prefill`` (phase 9's xlstm-350m prefill split)
    on the CPU, profiling host activity only: every sLSTM step of one
    prefill of the wide-head model lands in its profiler range, the cell
    is put back after, and the device split is all zeros here."""
    import chip_smoke
    from torch.profiler import ProfilerActivity
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []
    cell = tx._slstm_cell

    def counted(*args):
        calls.append(1)
        return cell(*args)

    monkeypatch.setattr(tx, "_slstm_cell", counted)
    cfg = wide_configs(False)[1]
    model = tmodel.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (B, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = chip_smoke.split_prefill(
            torch, tx, lambda: model.prefill(params, {"tokens": tokens}, 16),
            "xlstm-wide", activities=[ProfilerActivity.CPU])
    assert tx._slstm_cell is counted
    assert out["slstm_steps"] == len(calls) == 16   # one sLSTM layer
    assert out["slstm_loop_host_ms"] > 0
    assert out["device_busy_ms"] == out["gla_ms"] == out["slstm_loop_ms"] \
        == out["rest_ms"] == 0
