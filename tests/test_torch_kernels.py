"""The port's int8 quantizer against the JAX package's, on the same inputs.

On the CPU the wrapper runs the kernel's plain PyTorch version; the CUDA
kernel is held against that version on the card by ``chip_smoke.py``.
The JAX side runs the Pallas kernel in interpret mode and its jnp
oracle.  Codes are integer-exact; the f32 row scale is bitwise equal
to the jnp oracle and pinned at rtol 2.4e-7 (2 ulp) against the Pallas
kernel, as in tests/test_kernel_oracle.py (the interpret-mode scale can
differ from the oracle's in the last bit).  A dequantized value is
``q * scale`` with ``q`` exact, so against the Pallas path it may differ
by those 2 ulp plus half an ulp of rounding on each side: rtol 3.6e-7.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import int8_quant as jiq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.core.wire import wire_codec as jax_wire_codec
from repro_torch.core.wire import SCALE_BYTES, int8_wire_bytes, wire_codec
from repro_torch.kernels import int8_quant as iq
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ref_quantize_int8
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

QDQ_RTOL = 3.6e-7

KINDS = ("normal", "uniform", "heavy_tail", "constant", "zeros", "spikes")
SHAPES = ((1, 1), (3, 127), (8, 256))


def rows(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=shape).astype(np.float32)
    if kind == "uniform":
        return rng.uniform(-3.0, 3.0, size=shape).astype(np.float32)
    if kind == "heavy_tail":
        return (np.exp(2.0 * rng.normal(size=shape)) *
                np.sign(rng.normal(size=shape))).astype(np.float32)
    if kind == "constant":
        return np.full(shape, 0.73, np.float32)
    if kind == "spikes":
        x = 1e-3 * rng.normal(size=shape)
        x[:, 0] = 50.0
        return x.astype(np.float32)
    assert kind == "zeros"
    return np.zeros(shape, np.float32)


def both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounds identically on both sides: f32 -> bf16 to nearest even)."""
    jx = jnp.asarray(x)
    tx = torch.from_numpy(x.copy())
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx


def jax_wire_oracle(x: np.ndarray) -> np.ndarray:
    """The JAX wire round trip through its jnp oracle: per-sample rows,
    u = 0.5, dequantized back to ``x``'s shape."""
    flat = jnp.asarray(x).reshape(x.shape[0], -1)
    q, s = jref.ref_quantize_int8(flat, jnp.full(flat.shape, 0.5))
    return np.asarray(jiq.dequantize_int8(q, s)).reshape(x.shape)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_quantize_matches_jax(kind, dtype, stochastic):
    for i, shape in enumerate(SHAPES):
        x = rows(kind, shape, seed=i)
        u = np.random.default_rng(100 + i).uniform(size=shape).astype(
            np.float32) if stochastic else np.full(shape, 0.5, np.float32)
        jx, tx = both(x, dtype)
        jq, js = jiq.quantize_int8(jx, jnp.asarray(u), interpret=True)
        rq, rs = jref.ref_quantize_int8(jx, jnp.asarray(u))
        noise = torch.from_numpy(u) if stochastic else 0.5
        tq, ts = ref_quantize_int8(tx, noise)
        wq, ws = iq.quantize_int8(tx, noise)         # CPU wrapper
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert tuple(tq.shape) == shape and tuple(ts.shape) == shape[:1]
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.4e-7,
                                   atol=0.0)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        assert torch.equal(wq, tq) and torch.equal(ws, ts)


def test_constant_noise_equals_noise_tensor():
    """The constant-u mode (the wire's 0.5) is the tensor mode with every
    u equal to it."""
    x = torch.from_numpy(rows("normal", (7, 333), seed=1))
    a = ref_quantize_int8(x, 0.5)
    b = ref_quantize_int8(x, torch.full(x.shape, 0.5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_nan_row_propagates_to_scale():
    x = torch.from_numpy(rows("normal", (2, 16), seed=2))
    x[1, 3] = float("nan")
    q, s = ref_quantize_int8(x, 0.5)
    assert torch.isfinite(s[0]) and torch.isnan(s[1])
    assert torch.equal(q[1], torch.zeros(16, dtype=torch.int8))


@pytest.mark.parametrize("kind", ["normal", "heavy_tail", "spikes", "zeros"])
@pytest.mark.parametrize("b,n", [(1, 16), (4, 100), (7, 333)])
def test_wire_qdq_matches_jax_and_bound(kind, b, n):
    x = rows(kind, (b, n), seed=b * n)
    y = kops.wire_qdq_int8(torch.from_numpy(x))
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), jax_wire_oracle(x))
    jy = np.asarray(jops.wire_qdq_int8(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(y.numpy(), jy, rtol=QDQ_RTOL, atol=0.0)
    # per-row round-to-nearest bound of tests/test_wire.py
    absmax = np.max(np.abs(x), axis=1)
    bound = np.maximum(absmax, 1e-30) / 127.0 / 2.0
    err = np.max(np.abs(y.numpy() - x), axis=1)
    assert np.all(err <= bound * (1.0 + 1e-5) + 1e-12)


def test_wire_qdq_keeps_shape_and_dtype():
    x = torch.from_numpy(rows("normal", (4, 6, 5, 3), seed=3))
    for t in (x, x.to(torch.bfloat16), x.permute(0, 3, 1, 2)):
        y = kops.wire_qdq_int8(t)
        assert y.shape == t.shape and y.dtype == t.dtype
    np.testing.assert_array_equal(kops.wire_qdq_int8(x).numpy(),
                                  jax_wire_oracle(x.numpy()))


def test_codec_backward_quantizes_cotangent():
    """The codec pushes the cotangent through the same round trip (the MG
    wire), exactly as the JAX custom VJP does."""
    x = rows("normal", (3, 64), seed=4)
    ct = rows("normal", (3, 64), seed=5)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = wire_codec("int8")(tx)
    assert torch.equal(y.detach(), kops.wire_qdq_int8(torch.from_numpy(x)))
    y.backward(torch.from_numpy(ct))
    g = tx.grad
    assert torch.equal(g, kops.wire_qdq_int8(torch.from_numpy(ct)))
    assert not torch.equal(g, torch.from_numpy(ct))
    np.testing.assert_array_equal(g.numpy(), jax_wire_oracle(ct))
    _, vjp = jax.vjp(jax_wire_codec("int8"), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=QDQ_RTOL,
                               atol=0.0)
    assert wire_codec("none") is None


def test_measured_wire_bytes_match_accounting():
    """``elems + 4`` bytes/sample is the codec's measured payload: one
    int8 byte per element and one f32 row scale per sample."""
    b, elems = 6, 352
    x = torch.from_numpy(rows("normal", (b, elems), seed=6))
    q, scale = kops.quantize_int8(x, torch.Generator().manual_seed(1))
    assert tuple(q.shape) == (b, elems) and tuple(scale.shape) == (b,)
    measured = (q.numel() * q.element_size() +
                scale.numel() * scale.element_size()) / b
    assert measured == float(int8_wire_bytes(elems))
    assert SCALE_BYTES == scale.element_size()


def test_stochastic_quantize_seeded_and_unbiased():
    x = torch.from_numpy(rows("uniform", (4, 4096), seed=7))
    q1, s1 = kops.quantize_int8(x, torch.Generator().manual_seed(3))
    q2, s2 = kops.quantize_int8(x, torch.Generator().manual_seed(3))
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    deq = kops.dequantize_int8(q1, s1)
    # E[q * scale] = x: the mean error is far below one scale step
    assert float((deq - x).mean().abs()) < 0.05 * float(s1.max())
    assert float((deq - x).abs().max()) <= float(s1.max()) * (1 + 1e-6)


def test_cpu_wrapper_does_not_count_launches():
    before = iq.launches
    x = torch.from_numpy(rows("normal", (5, 64), seed=8))
    iq.quantize_int8(x, 0.5)
    kops.wire_qdq_int8(x)
    wire_codec("int8")(x)
    assert iq.launches == before == 0


@pytest.mark.parametrize("bad", ["1d", "int", "strided", "noise_shape",
                                 "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 8)
    noise = 0.5
    if bad == "1d":
        x = torch.zeros(8)
    elif bad == "int":
        x = torch.zeros(4, 8, dtype=torch.int32)
    elif bad == "strided":
        x = torch.zeros(8, 4).t()
    elif bad == "noise_shape":
        noise = torch.zeros(4, 7)
    else:
        x = torch.zeros(0, 8)
    with pytest.raises((ValueError, TypeError)):
        iq.quantize_int8(x, noise)
