"""The int8 wire's fused entry and the quantizer's row split, on the CPU.

``csrc/int8_quant.cu`` cannot run here; ``chip_smoke.py`` holds both of
its entries bitwise against their plain versions on the card.  Here:

* the wrapper's CPU route of ``wire_qdq_int8`` against the JAX package's
  wire round trip (``repro.kernels.ops.wire_qdq_int8``): bitwise against
  its jnp oracle, and at the stated rtol of tests/test_torch_kernels.py
  against the Pallas kernel in interpret mode (its row scale can be 2
  ulp off the oracle's), on ragged rows, zero, NaN and +-inf rows;
* ``ref_wire_qdq_int8`` bitwise against the composition it replaced;
* ``plan_slices`` and the kernel's split of a slice into scalar and
  16-byte vector segments (mirrored here from ``span`` in the source):
  every element exactly once, every vector segment on a 16-byte
  boundary;
* the ``_Int8Wire`` codec's forward and backward through the new entry
  against JAX's custom VJP, the cotangent also non-contiguous;
* the kernels' division (``quotient``: a reciprocal per row and two FMA
  corrections), emulated exactly, against the IEEE f32 division;
* ``chip_smoke.py``'s quantizer cases and its bitwise comparison.
"""
from __future__ import annotations

from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core.wire import wire_codec as jax_wire_codec
from repro.kernels import int8_quant as jiq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.wire import wire_codec
from repro_torch.kernels import int8_quant as iq
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant_variants
from repro_torch.kernels.ref import ref_quantize_int8, ref_wire_qdq_int8
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

QDQ_RTOL = 3.6e-7  # tests/test_torch_kernels.py: 2 ulp of scale + rounding
BF16_ULP = 2.0 ** -7    # relative spacing of bf16 values


def wire_rows(kind: str, shape, seed: int) -> np.ndarray:
    """f32 rows with one special row: all zero, a NaN, or +-inf."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=shape)).astype(np.float32)
    if kind == "zero_row":
        x[shape[0] // 2] = 0.0
    elif kind == "nan_row":
        x[0, shape[1] // 3] = np.nan
    elif kind == "inf_row":
        x[-1, 1] = np.inf
        x[-1, -1] = -np.inf
    return x


def jax_oracle(x: np.ndarray, dtype) -> np.ndarray:
    """The JAX wire round trip through its jnp oracle, in ``dtype``."""
    jx = jnp.asarray(x).astype(dtype)
    q, s = jref.ref_quantize_int8(jx, jnp.full(jx.shape, 0.5))
    return np.asarray(jiq.dequantize_int8(q, s).astype(dtype)
                      .astype(jnp.float32))


def assert_same(got: np.ndarray, want: np.ndarray) -> None:
    """Equal, NaN at the same places."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["normal", "zero_row", "nan_row", "inf_row"])
@pytest.mark.parametrize("shape", [(3, 12345), (2, 12343), (5, 64), (1, 7)])
def test_wire_entry_matches_jax(shape, kind, dtype):
    x = wire_rows(kind, shape, seed=shape[0] * shape[1])
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    tx = torch.from_numpy(x).to(tdt)
    y = iq.wire_qdq_int8(tx)
    assert y.dtype == tdt and y.shape == tx.shape
    got = y.float().numpy()
    assert_same(got, jax_oracle(x, jdt))
    jy = np.asarray(jops.wire_qdq_int8(jnp.asarray(x).astype(jdt),
                                       interpret=True).astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jy))
    keep = ~np.isnan(got)
    if dtype == "float32":
        np.testing.assert_allclose(got[keep], jy[keep], rtol=QDQ_RTOL,
                                   atol=0.0)
    else:
        # the f32 values agree to QDQ_RTOL; rounding them to bf16 can then
        # land one bf16 step apart, never more
        np.testing.assert_allclose(got[keep], jy[keep], rtol=BF16_ULP,
                                   atol=0.0)
    if kind in ("nan_row", "inf_row"):
        row = 0 if kind == "nan_row" else -1
        assert np.isnan(got[row]).all()
        assert not np.isnan(np.delete(got, row % shape[0], axis=0)).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ref_wire_is_the_old_composition(dtype):
    x = torch.from_numpy(wire_rows("nan_row", (4, 999), seed=1)).to(dtype)
    x[2] = 0.0
    q, s = ref_quantize_int8(x, 0.5)
    old = iq.dequantize_int8(q, s).to(dtype)
    new = ref_wire_qdq_int8(x)
    assert new.dtype == dtype
    assert chip_smoke.same_bits(torch, new, old)
    assert torch.isnan(new[0]).all() and not torch.isnan(new[1:]).any()


def segments(row: int, N: int, elem_bytes: int, s: int, slice_elems: int,
             vec_ok: bool):
    """``span`` of csrc/int8_quant.cu: slice ``s`` of ``row`` as
    ``(start, stop, vector)`` ranges, a scalar head up to the first flat
    index on a 16-byte boundary, whole vectors, a scalar tail; all
    scalar unless every base pointer is 16-byte aligned."""
    vec = iq.VECTOR_BYTES // elem_bytes
    j0 = s * slice_elems
    j1 = min(j0 + slice_elems, N)
    if vec_ok:
        mis = (row * N + j0) % vec
        jb = min(j0 + (vec - mis if mis else 0), j1)
    else:
        jb = j1
    je = jb + (j1 - jb) // vec * vec
    return [seg for seg in ((j0, jb, False), (jb, je, True), (je, j1, False))
            if seg[0] < seg[1]]


MAIN_SHAPES = [(m, 50176, 4) for m in (39, 33, 6, 5, 4)] + \
    [(m, 262144, 2) for m in (35, 38)]
# The other AlexNet rows of chip_smoke.py's paths, its loops' straggler
# windows and the fig_tree plans (tests/test_torch_facade.py pins them).
MORE_ALEXNET_SHAPES = [(m, 50176, 4)
                       for m in (38, 35, 34, 31, 14, 13, 12, 11, 8, 3, 2)]


@pytest.mark.parametrize("M,N,eb", MAIN_SHAPES + MORE_ALEXNET_SHAPES + [
    (1, 50176, 4), (1, 262144, 2), (1, 1, 4), (1, 1, 2), (7, 12345, 4),
    (5, 12343, 2), (3, 1000, 4), (64, 4096, 2), (2, 3, 2), (130, 17, 4)])
def test_plan_slices_tiles_each_row_on_16_byte_edges(M, N, eb):
    S, L = iq.plan_slices(M, N, eb)
    vec = iq.VECTOR_BYTES // eb
    assert S >= 1 and L % vec == 0
    assert (S - 1) * L < N <= S * L
    assert M * S <= 2 ** 31 - 1
    if S > 1:   # every thread of a block has a whole vector to load
        assert L >= iq.THREADS * vec
    rows = range(M) if M * N <= 2 ** 16 else (0, 1, M - 1)
    for vec_ok in (True, False):
        for r in rows:
            seen = np.zeros(N, np.int32)
            for s in range(S):
                for a, b, is_vec in segments(r, N, eb, s, L, vec_ok):
                    seen[a:b] += 1
                    if is_vec:
                        assert ((r * N + a) * eb) % 16 == 0
                        assert (b - a) % vec == 0
                    else:
                        assert b - a < vec or not vec_ok
            assert (seen == 1).all()


@pytest.mark.parametrize("target", sorted(quant_variants.PLANS.values()))
@pytest.mark.parametrize("M,N,eb", MAIN_SHAPES)
def test_plan_slices_tiles_rows_at_the_variants_block_targets(
        M, N, eb, target, monkeypatch):
    monkeypatch.setattr(iq, "TARGET_BLOCKS", target)
    S, L = iq.plan_slices(M, N, eb)
    vec = iq.VECTOR_BYTES // eb
    assert L % vec == 0 and (S - 1) * L < N <= S * L
    assert S == 1 or L >= iq.THREADS * vec
    monkeypatch.setattr(iq, "TARGET_BLOCKS", 2 * target)
    assert S <= iq.plan_slices(M, N, eb)[0]


@pytest.mark.parametrize("name", sorted(quant_variants.PATCHES))
def test_quant_variant_patches_apply_to_the_committed_source(name):
    """Each variant's patches find their text exactly once in
    ``csrc/int8_quant.cu``, so an edit of the source that moves an
    anchor fails here and not on the card."""
    base = (Path(iq.__file__).parent / "csrc" / "int8_quant.cu").read_text()
    src = quant_variants.patched_source(name)
    assert (src == base) == (name == "design")
    assert "extern \"C\" int int8_wire_qdq(" in src


@pytest.mark.parametrize("M,N,eb,want", [
    (39, 50176, 4, (14, 3584)), (35, 262144, 2, (16, 16384)),
    (38, 262144, 2, (14, 18728)), (4, 50176, 4, (49, 1024))])
def test_plan_slices_fills_the_card_at_the_main_shapes(M, N, eb, want):
    assert iq.plan_slices(M, N, eb) == want
    assert M * want[0] >= iq.TARGET_BLOCKS or want[1] == iq.THREADS * (
        iq.VECTOR_BYTES // eb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "permuted"])
def test_codec_through_the_wire_entry_matches_jax(dtype, layout):
    """Forward on the activation, backward on the cotangent, through the
    fused entry; the cotangent reaches the codec as autograd hands it
    (here also non-contiguous) and must give the same values."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = wire_rows("normal", (3, 4, 5, 6), seed=11)
    ct = wire_rows("normal", (3, 4, 5, 6), seed=12)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(True)
    tct = torch.from_numpy(ct).to(dtype)
    if layout == "permuted":
        tct = tct.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not tct.is_contiguous()
    y = wire_codec("int8")(tx)
    y.backward(tct)
    assert y.dtype == dtype and tx.grad.dtype == dtype
    assert torch.equal(y.detach(), kops.wire_qdq_int8(tx.detach()))
    fwd = jax_oracle(x.reshape(3, -1), jdt).reshape(x.shape)
    bwd = jax_oracle(ct.reshape(3, -1), jdt).reshape(ct.shape)
    np.testing.assert_array_equal(y.detach().float().numpy(), fwd)
    np.testing.assert_array_equal(tx.grad.float().numpy(), bwd)
    jy, vjp = jax.vjp(jax_wire_codec("int8"), jnp.asarray(x).astype(jdt))
    (jg,) = vjp(jnp.asarray(ct).astype(jdt))
    rtol = QDQ_RTOL if dtype == torch.float32 else BF16_ULP
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=rtol,
                               atol=0.0)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)), rtol=rtol,
                               atol=0.0)


@pytest.mark.parametrize("bad", ["1d", "int", "strided", "empty", "device"])
def test_wire_entry_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(4, 8)
    if bad == "1d":
        x = torch.zeros(8)
    elif bad == "int":
        x = torch.zeros(4, 8, dtype=torch.int32)
    elif bad == "strided":
        x = torch.zeros(8, 4).t()
    elif bad == "empty":
        x = torch.zeros(4, 0)
    else:
        x = torch.zeros(4, 8, device="meta")
    with pytest.raises((ValueError, TypeError)):
        iq.wire_qdq_int8(x)


def test_cpu_wire_entry_does_not_count_launches():
    before = iq.launches
    iq.wire_qdq_int8(torch.ones(2, 5))
    assert iq.launches == before == 0


def rn32(v: Fraction) -> np.float32:
    """``v`` rounded to the nearest f32, ties to even (subnormals too)."""
    if v == 0:
        return np.float32(0.0)
    sign, a = (-1, -v) if v < 0 else (1, v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    e = e - 1 if Fraction(2) ** e > a else e       # 2^e <= a < 2^(e+1)
    step = Fraction(2) ** max(e - 23, -149)
    m, rem = divmod(a / step, 1)
    m = int(m) + (rem > Fraction(1, 2) or (rem == Fraction(1, 2) and m % 2))
    return np.float32(sign * float(m * step))


def fma32(a, b, c) -> np.float32:
    return rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def quotient(x: np.float32, s: np.float32) -> np.float32:
    """``quotient`` of csrc/int8_quant.cu, op for op: y = RN(1/s) once;
    q = RN(x y), then twice q = RN(q + RN(x - q s) y) with exact FMAs;
    the IEEE division where |x| <= max(2^-100, s 2^-100), where s is not
    finite and where x is NaN."""
    tiny = np.float32(max(2.0 ** -100, float(s) * 2.0 ** -100)) \
        if np.isfinite(s) else np.float32(np.inf)
    if not abs(x) > tiny:
        return np.float32(x / s)
    y = np.float32(np.float32(1.0) / s)
    q = rn32(Fraction(float(x)) * Fraction(float(y)))
    for _ in range(2):
        q = fma32(fma32(-q, s, x), y, q)
    return q


def test_quotient_identity_is_the_ieee_division():
    """The kernels' division, emulated exactly, against numpy's f32
    division (IEEE): wire-like rows (|x| <= 127 s) at scales from the
    1e-30 floor to the largest finite absmax, significands of all ones,
    quotients just above the 2^-100 cut, and the guarded cases."""
    rng = np.random.default_rng(5)
    absmax = np.concatenate([
        np.float32([1e-30, 3.4028235e38, 1.0, 127.0, 0.75, 16777215.0]),
        rng.integers(0, 0x7F800000, 40, dtype=np.int64).astype(np.uint32)
        .view(np.float32)])
    s_all = (np.maximum(absmax, np.float32(1e-30)) / np.float32(127.0)
             ).astype(np.float32)
    with np.errstate(over="ignore", under="ignore", invalid="ignore"):
        for s in s_all:
            xs = np.concatenate([
                (s * rng.uniform(-127, 127, 60)).astype(np.float32),
                (np.float32(1.9999999) * s * np.float32(2.0) ** rng.integers(
                    -99, 7, 20)).astype(np.float32),
                np.float32([0.0, -0.0, np.nan])])
            for x in xs:
                got, want = quotient(x, s), np.float32(x / s)
                assert np.isnan(got) == np.isnan(want)
                if not np.isnan(want):
                    assert got.view(np.uint32) == want.view(np.uint32), \
                        (x, s, got, want)
        for s in np.float32([np.inf, np.nan]):
            assert np.isnan(quotient(np.float32(np.inf), s))
            got = quotient(np.float32(3.0), s)
            assert got.view(np.uint32) == np.float32(3.0 / s).view(np.uint32)


# ---------------------------------------------------------------------------
# chip_smoke.py's side of the check (its CPU-testable helpers)
# ---------------------------------------------------------------------------

def test_chip_smoke_quantizer_cases_reach_the_kernel_edges():
    cases = chip_smoke.quant_cases(torch, "cpu", torch.Generator()
                                   .manual_seed(0),
                                   [m for m, _, _ in MAIN_SHAPES[:5] +
                                    MORE_ALEXNET_SHAPES])
    names = [c[0] for c in cases]
    assert len(set(names)) == len(names)
    wire = {(x.shape[0], x.shape[1], x.dtype) for _, x, u in cases
            if not isinstance(u, torch.Tensor)}
    for m, n, eb in MAIN_SHAPES + MORE_ALEXNET_SHAPES:
        assert (m, n, torch.float32 if eb == 4 else torch.bfloat16) in wire
    xs = [x for _, x, _ in cases]
    assert any(torch.isnan(x).any() for x in xs)
    assert any(torch.isposinf(x).any() and torch.isneginf(x).any()
               for x in xs)
    assert any((x == 0).all(dim=1).any() for x in xs)
    assert any(x.dtype == torch.bfloat16 and x.shape[1] % 8 for x in xs)
    assert any(isinstance(u, torch.Tensor) for _, _, u in cases)
    for dt in (torch.float32, torch.bfloat16):
        assert any(x.dtype == dt and x.is_contiguous()
                   and x.data_ptr() % 16 for x in xs)
    for _, x, u in cases:       # every case runs through the CPU routes
        q, s = iq.quantize_int8(x, u)
        assert q.shape == x.shape and s.shape == x.shape[:1]
        if not isinstance(u, torch.Tensor):
            assert chip_smoke.same_bits(torch, iq.wire_qdq_int8(x),
                                        ref_wire_qdq_int8(x))


def test_chip_smoke_same_bits_is_bitwise_and_nan_aware():
    a = torch.tensor([1.0, float("nan"), 0.0])
    assert chip_smoke.same_bits(torch, a, a.clone())
    assert not torch.equal(a, a.clone())
    assert not chip_smoke.same_bits(torch, a, torch.tensor([1.0, 2.0, 0.0]))
    assert not chip_smoke.same_bits(torch, a, torch.tensor(
        [1.0, float("nan"), -0.0]))
    assert not chip_smoke.same_bits(torch, a, a.to(torch.bfloat16))
    assert chip_smoke.max_err(torch, a, torch.tensor([1.5, 0.0, 0.0])) == 0.5


def test_chip_smoke_wire_bound_counts_its_bytes():
    M, N = 35, 262144
    q_ms, q_by = chip_smoke.quant_bound(M, N, 2, False, False)
    w_ms, w_by = chip_smoke.quant_bound(M, N, 2, False, True)
    assert q_by == w_by == "bytes"
    want_q = (M * N * 3 + 4 * M) / chip_smoke.H100_BYTES_PER_S
    want_w = (M * N * 4) / chip_smoke.H100_BYTES_PER_S
    assert q_ms == pytest.approx(want_q * 1e3, rel=1e-12)
    assert w_ms == pytest.approx(want_w * 1e3, rel=1e-12)


def test_chip_smoke_divisors_are_wire_scales():
    s = chip_smoke.quant_divisors(torch, "cpu", torch.Generator()
                                  .manual_seed(0))
    assert s.dtype == torch.float32 and s.dim() == 1 and s.numel() == 256
    assert torch.isfinite(s).all() and (s > 0).all()
    assert float(s.min()) == pytest.approx(1e-30 / 127.0, rel=1e-6)
    assert float(s.max()) == pytest.approx(3.4028235e38 / 127.0, rel=1e-6)
