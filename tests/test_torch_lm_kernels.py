"""The port's flash-attention and GLA kernels' plain versions, and their
autograd wrappers, against the JAX package's on the same inputs.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
CUDA kernels are held against those versions on the card by
``chip_smoke.py``.  The JAX side runs its Pallas kernels in interpret
mode and its jnp oracles, as tests/test_kernel_oracle.py does.

Forward values are held to the ``TOL`` rule of
tests/test_kernel_oracle.py (``atol + ulps * ulp`` in the storage dtype;
f32 here, where the point is the algorithm).  Gradients of the model-
layout ops are held against ``jax.grad`` through ``repro.kernels.ops`` at
rtol 1e-4 / atol 2e-5 of the largest gradient: both sides are f32 chains
of a few reductions, and the GLA backward differentiates the chunked
form here but the step recurrence in JAX (measured: at most 2.6e-6 of
the largest gradient).  ``torch.autograd.gradcheck`` holds the plain
versions in float64.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import gla_scan as jgs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gs
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.models.lm.gla import chunked_gla
from tests.test_kernel_oracle import assert_oracle_close
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-5


def randn(rng, *shape, scale: float = 1.0) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def log_decay(rng, *shape) -> np.ndarray:
    """Mamba2-like log-decays: -softplus(N(0, 1) - 2), in (-inf, 0)."""
    return (-np.logaddexp(0.0, rng.standard_normal(shape) - 2.0)).astype(
        np.float32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        g = np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        top = max(float(np.max(np.abs(w))), 1e-30)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * top)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 16)])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("hd,T", [(16, 80), (112, 40), (256, 48)])
def test_flash_plain_matches_jax(hd, T, rep, causal, window):
    rng = np.random.default_rng(hd * 1000 + T + rep)
    bkv = 2
    q = randn(rng, bkv * rep, T, hd)
    k = randn(rng, bkv, T, hd)
    v = randn(rng, bkv, T, hd)
    # both routes read the same tensors: fresh copies for each put the
    # inputs at other addresses, and MKL's sgemm (the einsums' bmm) may
    # take another code path for another alignment
    tq, tk, tv = t(q), t(k), t(v)
    o, lse = ref.ref_flash_attention(tq, tk, tv, causal=causal,
                                     window=window)
    wo, wl = fa.flash_attention_fwd(tq, tk, tv, causal, window)
    assert torch.equal(o, wo) and torch.equal(lse, wl)   # CPU: the plain
    assert o.dtype == torch.float32 and lse.shape == (bkv * rep, T)
    jo, jl = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window, block_q=T // 2,
                                     block_k=T // 2, interpret=True)
    ro, rl = jref.ref_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      window=window)
    for want_o, want_l in ((jo, jl), (ro, rl)):
        assert_oracle_close("flash_o", o.numpy(), want_o, jnp.float32)
        assert_oracle_close("flash_lse", lse.numpy(), want_l, jnp.float32)


def test_flash_plain_bf16_keeps_q_dtype():
    rng = np.random.default_rng(1)
    q, k, v = (t(randn(rng, 2, 24, 16)).to(torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, True, 0)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 8),
                                           (False, 12)])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
def test_flash_grads_match_jax(H, KV, causal, window):
    rng = np.random.default_rng(H * 10 + KV + window)
    B, T, hd = 2, 24, 16
    q, k, v = randn(rng, B, T, H, hd), randn(rng, B, T, KV, hd), \
        randn(rng, B, T, KV, hd)
    ct = randn(rng, B, T, H, hd)
    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    out = kops.flash_attention(tq, tk, tv, causal=causal, window=window)
    out.backward(t(ct))

    def f(q, k, v):
        o = jops.flash_attention(q, k, v, causal=causal, window=window,
                                 interpret=True)
        return jnp.sum(o * jnp.asarray(ct))
    jg = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    jout = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                window=window, interpret=True)
    assert_oracle_close("flash_o", out.detach().numpy(), jout, jnp.float32)
    assert_grads_close([tq.grad, tk.grad, tv.grad], jg)


def test_flash_backward_is_the_plain_gradient():
    """The chunked backward (several K blocks: S = 1,100 > 512) equals
    autograd through the plain version."""
    rng = np.random.default_rng(3)
    B, T, H, KV, hd = 1, 1100, 2, 1, 16
    q, k, v = randn(rng, B, T, H, hd), randn(rng, B, T, KV, hd), \
        randn(rng, B, T, KV, hd)
    ct = t(randn(rng, B, T, H, hd))
    a = [t(x).requires_grad_(True) for x in (q, k, v)]
    kops.flash_attention(*a, causal=True, window=300).backward(ct)
    b = [t(x).requires_grad_(True) for x in (q, k, v)]

    def plain(q, k, v):
        qh = q.transpose(1, 2).reshape(B * H, T, hd)
        kh = k.transpose(1, 2).reshape(B * KV, T, hd)
        vh = v.transpose(1, 2).reshape(B * KV, T, hd)
        o, _ = ref.ref_flash_attention(qh, kh, vh, causal=True, window=300)
        return o.reshape(B, H, T, hd).transpose(1, 2)
    plain(*b).backward(ct)
    assert_grads_close([x.grad for x in a], [x.grad for x in b])


def test_flash_plain_gradcheck_float64():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 6, 4, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    kk, vv = k[:2].detach().requires_grad_(True), \
        v[:2].detach().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ref.ref_flash_attention(q, k, v, causal=True,
                                                window=3), (q, kk, vv))


# ---------------------------------------------------------------------------
# GLA scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("T", [32, 96])
def test_gla_plain_matches_jax(T, normalize):
    rng = np.random.default_rng(T + normalize)
    BH, dk, dv, W = 3, 16, 24, 32
    q, k = randn(rng, BH, T, dk), randn(rng, BH, T, dk, scale=0.5)
    v, a = randn(rng, BH, T, dv), log_decay(rng, BH, T)
    y, S, n = ref.ref_gla(t(q), t(k), t(v), t(a), normalize=normalize)
    wy, wS, wn = gs.gla_scan_fwd(t(q), t(k), t(v), t(a), W, normalize)
    assert torch.equal(y, wy) and torch.equal(S, wS) and torch.equal(n, wn)
    cy, (cS, cn) = chunked_gla(t(q)[:, :, None], t(k)[:, :, None],
                               t(v)[:, :, None], t(a)[:, :, None], chunk=W,
                               normalize=normalize)
    jk = jgs.gla_scan_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(a), chunk=W, normalize=normalize,
                          interpret=True)
    jr = jref.ref_gla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(a), normalize=normalize)
    ours = [(y, S, n), (cy[:, :, 0], cS[:, 0], cn[:, 0])]
    for oy, oS, on in ours:
        for want in (jk, jr):
            assert_oracle_close("gla_y", oy.numpy(), want[0], jnp.float32)
            assert_oracle_close("gla_state", oS.numpy(), want[1],
                                jnp.float32)
            assert_oracle_close("gla_state", on.numpy(), want[2],
                                jnp.float32)


def test_chunked_gla_pads_ragged_t_and_takes_initial_state():
    """T = 40 at chunk 16 pads to 48; an initial state continues the
    recurrence: two halves chained equal the whole."""
    rng = np.random.default_rng(5)
    B, T, H, dk, dv = 2, 40, 2, 8, 8
    q, k, v = (t(randn(rng, B, T, H, d)) for d in (dk, dk, dv))
    a = t(log_decay(rng, B, T, H))
    y, (S, n) = chunked_gla(q, k, v, a, chunk=16)
    y1, st = chunked_gla(q[:, :24], k[:, :24], v[:, :24], a[:, :24],
                         chunk=16)
    y2, (S2, n2) = kops.gla_scan(q[:, 24:], k[:, 24:], v[:, 24:], a[:, 24:],
                                 chunk=16, initial_state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(S2.numpy(), S.numpy(), rtol=1e-5, atol=1e-5)
    yr, Sr, nr = ref.ref_gla(q[:, :, 0], k[:, :, 0], v[:, :, 0], a[:, :, 0])
    np.testing.assert_allclose(y[:, :, 0].numpy(), yr.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_grads_match_jax(normalize):
    rng = np.random.default_rng(7 + normalize)
    B, T, H, dk, dv = 2, 64, 2, 8, 12
    q, k = randn(rng, B, T, H, dk), randn(rng, B, T, H, dk, scale=0.5)
    v, a = randn(rng, B, T, H, dv), log_decay(rng, B, T, H)
    cy, cS = randn(rng, B, T, H, dv), randn(rng, B, H, dk, dv)
    tin = [t(x).requires_grad_(True) for x in (q, k, v, a)]
    y, (S, n) = kops.gla_scan(*tin, chunk=32, normalize=normalize)
    ((y * t(cy)).sum() + (S * t(cS)).sum()).backward()

    def f(q, k, v, a):
        y, (S, _) = jops.gla_scan(q, k, v, a, chunk=32, normalize=normalize,
                                  interpret=True)
        return jnp.sum(y * jnp.asarray(cy)) + jnp.sum(S * jnp.asarray(cS))
    jg = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(x)
                                             for x in (q, k, v, a)))
    assert_grads_close([x.grad for x in tin], jg)


@pytest.mark.parametrize("normalize", [False, True])
def test_gla_grads_match_jax_at_zamba2_chunk_and_strong_decays(normalize):
    """zamba2-7b's chunk (W=256) at -softplus(N + 2) log-decays, T=512:
    a chunk's decays sum to about -550, so the chunked form's masked
    exponents ca_i - ca_j (j > i) overflow exp.  The port differentiates
    the chunked form, JAX's op the step recurrence; both stay finite and
    within the f32 gradient budget (measured: q, k, v within 9.1e-6 and
    the log-decays within 2.3e-5 of the largest gradient; ``-s`` prints
    them)."""
    rng = np.random.default_rng(11 + normalize)
    B, T, H, dk, dv = 1, 512, 2, 8, 8
    q, k = randn(rng, B, T, H, dk), randn(rng, B, T, H, dk, scale=0.3)
    v = randn(rng, B, T, H, dv)
    a = (-np.logaddexp(0.0, rng.standard_normal((B, T, H)) + 2.0)).astype(
        np.float32)
    cy, cS = randn(rng, B, T, H, dv), randn(rng, B, H, dk, dv)
    assert np.cumsum(a[:, :256], axis=1).min() < -89.0   # exp(89) = inf
    tin = [t(x).requires_grad_(True) for x in (q, k, v, a)]
    y, (S, n) = kops.gla_scan(*tin, chunk=256, normalize=normalize)
    ((y * t(cy)).sum() + (S * t(cS)).sum()).backward()

    def f(q, k, v, a):
        y, (S, _) = jops.gla_scan(q, k, v, a, chunk=256, normalize=normalize,
                                  interpret=True)
        return jnp.sum(y * jnp.asarray(cy)) + jnp.sum(S * jnp.asarray(cS))
    jg = jax.grad(f, argnums=(0, 1, 2, 3))(*(jnp.asarray(x)
                                             for x in (q, k, v, a)))
    got = [x.grad for x in tin]
    assert all(torch.isfinite(g).all() for g in got)
    gaps = {name: float(np.max(np.abs(g.numpy() - np.asarray(w))) /
                        np.max(np.abs(np.asarray(w))))
            for name, g, w in zip("qkva", got, jg)}
    print(f"normalize={normalize} gradient gap / largest gradient: {gaps}")
    assert_grads_close(got, jg)


def test_gla_backward_takes_dropped_state_cotangents():
    """Mamba2 drops S and n: their cotangents arrive as None."""
    rng = np.random.default_rng(9)
    tin = [t(randn(rng, 1, 16, 2, 4)).requires_grad_(True)
           for _ in range(3)] + [t(log_decay(rng, 1, 16, 2))
                                 .requires_grad_(True)]
    y, _ = kops.gla_scan(*tin, chunk=8)
    y.sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in tin)


def test_gla_plain_gradcheck_float64():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 6, 3, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    a = (-torch.rand(2, 6, generator=g, dtype=torch.float64)
         ).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q, k, v, a: ref.ref_gla(q, k, v, a, normalize=True)[0],
        (q, k, v, a))
    assert torch.autograd.gradcheck(
        lambda q, k, v, a: chunked_gla(q[:, :, None], k[:, :, None],
                                       v[:, :, None], a[:, :, None],
                                       chunk=4, normalize=True)[0],
        (q, k, v, a))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def test_cpu_wrappers_do_not_count_launches():
    before = (fa.launches, gs.launches)
    x = torch.zeros(2, 8, 16)
    fa.flash_attention_fwd(x, x, x, True, 0)
    gs.gla_scan_fwd(x, x, x, torch.zeros(2, 8), 4, False)
    assert (fa.launches, gs.launches) == before == (0, 0)


@pytest.mark.parametrize("bad", ["rank", "dtype", "mixed", "strided",
                                 "heads", "decay_dtype"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    q = torch.zeros(4, 8, 16)
    k = torch.zeros(2, 8, 16)
    a = torch.zeros(4, 8)
    if bad == "rank":
        q = torch.zeros(4, 8, 2, 16)
    elif bad == "dtype":
        q = q.double()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "strided":
        q = torch.zeros(16, 8, 4).transpose(0, 2)
    elif bad == "heads":
        k = torch.zeros(3, 8, 16)
    else:
        a = a.double()
    with pytest.raises((ValueError, TypeError)):
        if bad == "decay_dtype":
            gs.gla_scan_fwd(q, q, q, a, 4, False)
        else:
            fa.flash_attention_fwd(q, k, k, True, 0)
    if bad in ("rank", "dtype", "strided"):
        with pytest.raises((ValueError, TypeError)):
            gs.gla_scan_fwd(q, q, q, a, 4, False)
