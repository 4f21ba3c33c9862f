"""Rounding points of the bf16 tensor-core GLA kernels, checked on the CPU.

``csrc/gla_scan.cu``'s ``gla_fwd_bf16`` (heads up to 128) and
``gla_fwd_wide_bf16`` (wider heads) cannot run here, so this file
emulates where they round and holds the result against the JAX package's
reference (``repro.kernels.ref.ref_gla``, the step recurrence) at the
bf16 ``gla_y`` / ``gla_state`` rule of tests/test_kernel_oracle.py
(``atol + ulps * ulp_bf16(|want|)``), the rule ``chip_smoke.py`` holds
the kernel to on the card.  The emulation (a test helper, not a plain
version of the port) follows the kernel:

* chunks of W steps, each cut into 64-row sub-tiles; a ragged last chunk
  and the rows of the last sub-tile past W hold zero q, k, v and a;
* ``ca``, the inclusive cumsum of ``a`` over the chunk, and
  ``tot = ca[W - 1]``, in f32;
* the inter-chunk term ``e^{ca_i} (q_i . S_in)``, with S_in rounded as
  the B operand of its product, f32 accumulation; ``q_i . n_in`` in f32;
* scores in f32 from bf16 q and k (each product is exact in f32), times
  ``e^{ca_i - ca_j}`` in f32, zero for ``j > i``; the row sums of these
  f32 scores feed ``den``; P rounded as the A operand of ``P V``;
* the state update ``e^{tot} S_in + (K o w)^T V`` with
  ``w_j = e^{tot - ca_j}``, ``K o w`` rounded as the A operand, f32
  accumulation; ``n`` from the f32 ``K o w``;
* ``y = acc / max(|den|, 1)`` (when normalizing) rounded to bf16.

``DESIGN`` is ``gla_fwd_bf16``'s choice of rounding for each product
(each f32 operand split into two bf16 parts, ``bf16x2``), ``WIDE``
``gla_fwd_wide_bf16``'s (every TF32 operand split into two TF32 parts,
``tf32x2``: on the mLSTM's draws one TF32 rounding misses the bf16 y
allowance at the wide heads).  Each case records its worst error as a
fraction of the allowance, for the design and with each product's
rounding switched to one bf16 rounding (``-s`` prints them).  With every
rounding switched off and f32 inputs, the same emulation must meet the
f32 rule, which checks its tiling, masking and padding apart from the
rounding.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import gla_scan as jgs
from repro.kernels import ref as jref
from repro_torch.kernels import _build, gla_variants
from tests.test_kernel_oracle import TOL, _ulp, assert_oracle_close
from tests.test_torch_flash_numerics import round_bf16, round_tf32
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

TILE = 64


def round_tf32x2(x: torch.Tensor) -> torch.Tensor:
    """x as the sum of two TF32 parts (``split_tf32`` in csrc/gla_scan.cu):
    hi = x rounded to TF32, lo = the rest as the tensor core reads it,
    truncated to TF32; hi + lo is exact in f32."""
    hi = round_tf32(x)
    lo = (x - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi + lo.view(torch.float32)


def truncate_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32, rounded toward zero (the low 16 bits cleared)."""
    return (x.contiguous().view(torch.int32) & ~0xFFFF).view(torch.float32)


def round_split_rz(x: torch.Tensor) -> torch.Tensor:
    """``hi + lo`` with ``hi`` = x truncated to bf16 and ``lo`` = ``x - hi``
    (exact) truncated to bf16 (``split_pair`` in csrc/gla_scan.cu): what
    two bf16 products with A = hi and A = lo add up to.  Like
    ``round_split`` (flash's round-to-nearest split) but with masks in
    place of conversions; it misses x by less than 2^-15 |x|."""
    hi = truncate_bf16(x)
    return hi + truncate_bf16(x - hi)


ROUND = {"bf16": round_bf16, "bf16x2": round_split_rz, "tf32": round_tf32,
         "tf32x2": round_tf32x2, "f32": lambda x: x}
# gla_fwd_bf16's operand rounding: P, S_in and K o w are each split into
# hi = bf16(x) and lo = bf16(x - hi), both truncated (``bf16x2``), the A
# (P, K o w) or B (S_in) operands of two bf16 wgmma products
# (``split_pair``); q, k and V are bf16 already.  Rounding both to
# nearest (flash's ``round_split``) would need conversion instructions,
# which share the pipe of the decays' exponentials.  One bf16 rounding
# would halve each product's tensor time, but misses the bf16 y
# allowance or comes near it (test_bf16_operands_miss_...); TF32, the
# earlier mma.sync kernel's rounding, keeps 11 significant bits to the
# split's 16.
DESIGN = {"p": "bf16x2", "s_in": "bf16x2", "kw": "bf16x2"}
TF32 = {"p": "tf32", "s_in": "tf32", "kw": "tf32"}
# gla_fwd_wide_bf16's: each of them as two TF32 parts, two m16n8k8
# products (test_one_tf32_rounding_misses_the_tolerance_at_wide_mlstm).
WIDE = {"p": "tf32x2", "s_in": "tf32x2", "kw": "tf32x2"}
OTHER = {"bf16x2": "bf16"}
F32 = {"p": "f32", "s_in": "f32", "kw": "f32"}


def kernel_design(dtype: torch.dtype, dk: int, dv: int) -> dict:
    """The rounding of the kernel that ``dispatch`` in csrc/gla_scan.cu
    picks for a call (``chip_smoke.gla_kernel``): ``DESIGN`` for
    ``gla_fwd_bf16``, ``WIDE`` for ``gla_fwd_wide_bf16``, none for the
    CUDA-core ``gla_fwd`` (f32 and bf16 widths that are not multiples of
    16), whose products are f32 FMAs."""
    return {"gla_fwd_bf16": DESIGN, "gla_fwd_wide_bf16": WIDE,
            "gla_fwd": F32}[chip_smoke.gla_kernel(dtype == torch.bfloat16,
                                                  dk, dv)]


def emulate_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   a: torch.Tensor, chunk: int, normalize: bool,
                   design: dict):
    """The kernel's arithmetic: q, k ``[BH, T, dk]``, v ``[BH, T, dv]``
    (f32 tensors holding the kernel's input values), a f32 ``[BH, T]``.
    Returns ``(y f32 [BH, T, dv] before the final rounding, S, n)``."""
    p_round, s_round, kw_round = (ROUND[design[x]] for x in ("p", "s_in",
                                                             "kw"))
    BH, T, dk = q.shape
    dv = v.shape[-1]
    W = min(chunk, T)
    n_sub = -(-W // TILE)
    Wp = n_sub * TILE
    S = torch.zeros((BH, dk, dv))
    n = torch.zeros((BH, dk))
    y = torch.empty((BH, T, dv))
    keep = torch.ones((TILE, TILE), dtype=torch.bool).tril()
    for t0 in range(0, T, W):
        rows = min(W, T - t0)

        def pad(x):
            out = x.new_zeros((BH, Wp) + x.shape[2:])
            out[:, :rows] = x[:, t0:t0 + rows]
            return out

        qc, kc, vc, ac = pad(q), pad(k), pad(v), pad(a)
        ca = torch.cumsum(ac, dim=1)          # rows >= W: a = 0, ca = tot
        tot = ca[:, W - 1:W]
        for qs in range(n_sub):
            i = slice(qs * TILE, qs * TILE + TILE)
            qi, ci = qc[:, i], ca[:, i, None]
            g = torch.exp(ci)
            acc = (qi @ s_round(S)) * g
            den = (qi @ n[..., None]) * g
            for ks in range(qs + 1):
                j = slice(ks * TILE, ks * TILE + TILE)
                p = (qi @ kc[:, j].transpose(1, 2)) * \
                    torch.exp(ci - ca[:, None, j])
                if ks == qs:
                    p = torch.where(keep, p, torch.zeros_like(p))
                den = den + p.sum(-1, keepdim=True)
                acc = acc + p_round(p) @ vc[:, j]
            if normalize:
                acc = acc / den.abs().clamp_min(1.0)
            lo = qs * TILE
            hi = min(lo + TILE, rows)
            if hi > lo:
                y[:, t0 + lo:t0 + hi] = acc[:, :hi - lo]
        kw = kc * torch.exp(tot - ca)[..., None]
        S = torch.exp(tot)[..., None] * S + \
            kw_round(kw).transpose(1, 2) @ vc
        n = torch.exp(tot) * n + kw.sum(1)
    return y, S, n


def over_tol(kind: str, got, want, dtype) -> float:
    """Worst ``|got - want|`` as a fraction of the TOL allowance."""
    atol, ulps = TOL[(kind, jnp.dtype(dtype).name)]
    w = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - w)
    return float(np.max(err / (atol + ulps * _ulp(w, dtype))))


# (BH, T, dk, dv, chunk, normalize): the main paths' shapes (fleet-gla
# W=128, zamba2-7b W=256), then the edges chip_smoke.py drives in bf16.
CASES = [
    pytest.param(8, 512, 64, 64, 128, False, id="T512_W128_d64"),
    pytest.param(8, 512, 64, 64, 256, False, id="T512_W256_d64"),
    pytest.param(4, 512, 128, 128, 128, True, id="normalize_T512_W128_d128"),
    pytest.param(8, 300, 64, 64, 128, False, id="ragged_T300_W128_d64"),
    pytest.param(4, 512, 64, 64, 256, True, id="normalize_T512_W256_d64"),
    pytest.param(4, 256, 128, 64, 64, False, id="dk128_dv64_T256_W64"),
]
# Log-decays -softplus(N + shift): mild as check_gla draws them, strong.
DECAYS = [pytest.param(-2.0, id="mild"), pytest.param(2.0, id="strong")]


def inputs(BH, T, dk, dv, shift, seed, dtype=np.float32):
    """q, k, v as check_gla draws them; log-decays -softplus(N + shift),
    or with ``shift=None`` uniform in [-0.25, 0) as the oracle test of
    tests/test_kernel_oracle.py draws them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, T, dk)).astype(np.float32)
    k = (0.3 * rng.standard_normal((BH, T, dk))).astype(np.float32)
    v = rng.standard_normal((BH, T, dv)).astype(np.float32)
    if shift is None:
        a = -0.25 * rng.uniform(size=(BH, T)) - 1e-3
    else:
        a = -np.logaddexp(0.0, rng.standard_normal((BH, T)) + shift)
    q, k, v = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    return q, k, v, jnp.asarray(a.astype(np.float32))


def mlstm_inputs(BH, T, dk, dv, seed):
    """bf16 q, k, v and f32 log-decays drawn as ``chip_smoke.gla_inputs``
    draws them for the mLSTM: log-decays logsigmoid(N(3, 1)), k N /
    sqrt(dk) times exp(clip(2 N, -8, 8)) per step."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, T, dk)).astype(np.float32)
    k = rng.standard_normal((BH, T, dk)).astype(np.float32)
    v = rng.standard_normal((BH, T, dv)).astype(np.float32)
    a = rng.standard_normal((BH, T)).astype(np.float32)
    gate = np.clip(2.0 * rng.standard_normal((BH, T, 1)), -8.0, 8.0)
    k = k / np.sqrt(dk) * np.exp(gate).astype(np.float32)
    a = -np.logaddexp(0.0, -(a + 3.0))
    q, k, v = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    return q, k, v, jnp.asarray(a.astype(np.float32))


def to_torch(*xs):
    return [torch.from_numpy(np.array(x, np.float32)) for x in xs]


def fractions(tq, tk, tv, ta, chunk, normalize, design, want):
    """(y, S, n) worst errors as fractions of the bf16 allowances."""
    y, S, n = emulate_kernel(tq, tk, tv, ta, chunk, normalize, design)
    y = y.to(torch.bfloat16).float().numpy()
    return (over_tol("gla_y", y, want[0], jnp.bfloat16),
            over_tol("gla_state", S.numpy(), want[1], jnp.bfloat16),
            over_tol("gla_state", n.numpy(), want[2], jnp.bfloat16))


def case_fractions(BH, T, dk, dv, chunk, normalize, shift):
    """The design's fractions and, per product, the other choice's."""
    q, k, v, a = inputs(BH, T, dk, dv, shift, seed=T + chunk + dk + dv,
                        dtype=jnp.bfloat16)
    want = jref.ref_gla(q, k, v, a, normalize=normalize)
    args = to_torch(q, k, v, a) + [chunk, normalize]
    out = {"design": fractions(*args, DESIGN, want)}
    for prod, choice in DESIGN.items():
        other = dict(DESIGN, **{prod: OTHER[choice]})
        out[f"{prod}_{OTHER[choice]}"] = fractions(*args, other, want)
    return out


@pytest.mark.parametrize("shift", DECAYS)
@pytest.mark.parametrize("BH,T,dk,dv,chunk,normalize", CASES)
def test_bf16_design_meets_oracle_tol(BH, T, dk, dv, chunk, normalize,
                                      shift, record_property):
    q, k, v, a = inputs(BH, T, dk, dv, shift, seed=T + chunk + dk + dv,
                        dtype=jnp.bfloat16)
    want_y, want_S, want_n = jref.ref_gla(q, k, v, a, normalize=normalize)
    y, S, n = emulate_kernel(*to_torch(q, k, v, a), chunk, normalize,
                             DESIGN)
    y = y.to(torch.bfloat16).float().numpy()
    assert_oracle_close("gla_y", y, want_y, jnp.bfloat16)
    assert_oracle_close("gla_state", S.numpy(), want_S, jnp.bfloat16)
    assert_oracle_close("gla_state", n.numpy(), want_n, jnp.bfloat16)
    fr = case_fractions(BH, T, dk, dv, chunk, normalize, shift)
    for name, (fy, fs, fn) in fr.items():
        record_property(f"y_over_tol_{name}", fy)
        record_property(f"S_over_tol_{name}", fs)
        record_property(f"n_over_tol_{name}", fn)
    print(" ".join(f"{name}: y {fy:.4f} S {fs:.4f} n {fn:.4f};"
                   for name, (fy, fs, fn) in fr.items()))
    # The kernel's rule for its operand precision: within half of each
    # allowance in every case.
    assert max(fr["design"]) < 0.5, fr


@pytest.mark.parametrize("BH,T,dk,dv,chunk,normalize", CASES)
def test_emulated_tiling_meets_f32_tol(BH, T, dk, dv, chunk, normalize):
    """The oracle test's decays: with -softplus decays over 128- and
    256-step chunks, f32 ``ca_i - ca_j`` loses digits to cancellation
    (|ca| reaches hundreds) and the chunked form misses the f32 rule
    against the step recurrence whoever evaluates it, the TPU kernel in
    interpret mode included (up to 1.8x the allowance at W=256)."""
    q, k, v, a = inputs(BH, T, dk, dv, None, seed=T + chunk + dk + dv + 1)
    want_y, want_S, want_n = jref.ref_gla(q, k, v, a, normalize=normalize)
    y, S, n = emulate_kernel(*to_torch(q, k, v, a), chunk, normalize, F32)
    assert_oracle_close("gla_y", y.numpy(), want_y, jnp.float32)
    assert_oracle_close("gla_state", S.numpy(), want_S, jnp.float32)
    assert_oracle_close("gla_state", n.numpy(), want_n, jnp.float32)


def test_chunked_form_in_f32_misses_the_f32_tol_at_mamba2_decays():
    """Why the f32 tiling check draws the oracle test's decays: at
    -softplus(N + 2) decays over 256-step chunks the TPU kernel's own
    chunked form in f32 (interpret mode) misses the f32 y allowance
    against the step recurrence, and so does the emulation."""
    BH, T, dk, dv, chunk = 8, 512, 64, 64, 256
    q, k, v, a = inputs(BH, T, dk, dv, 2.0, seed=T + chunk + dk + dv + 1)
    want_y = jref.ref_gla(q, k, v, a)[0]
    y_tpu = jgs.gla_scan_fwd(q, k, v, a, chunk=chunk, interpret=True)[0]
    y_emu = emulate_kernel(*to_torch(q, k, v, a), chunk, False, F32)[0]
    frac = {"tpu": over_tol("gla_y", y_tpu, want_y, jnp.float32),
            "emulation": over_tol("gla_y", y_emu.numpy(), want_y,
                                  jnp.float32)}
    print(f"f32 y over the f32 tol: {frac}")
    assert min(frac.values()) > 1.0, frac


def test_bf16_operands_miss_the_tolerance_where_tf32_meets_it():
    """Why P, S_in and K o w are each split into two bf16 parts and not
    rounded to one: at fleet-gla's shape (T=512, W=128, dk=dv=64, mild
    decays), bf16 P or bf16 K o w (through the state into the next
    chunks' y) exceed the bf16 y allowance, and bf16 S_in is past half of
    it; TF32 (one rounding of 11 significant bits, the earlier mma.sync
    kernel's) meets it, and so does the split."""
    fr = case_fractions(8, 512, 64, 64, 128, False, -2.0)
    assert fr["p_bf16"][0] > 1.0, fr
    assert fr["kw_bf16"][0] > 1.0, fr
    assert fr["s_in_bf16"][0] > 0.5, fr
    assert max(fr["design"]) < 0.5, fr
    q, k, v, a = inputs(8, 512, 64, 64, -2.0, seed=512 + 128 + 64 + 64,
                        dtype=jnp.bfloat16)
    want = jref.ref_gla(q, k, v, a)
    assert max(fractions(*to_torch(q, k, v, a), 128, False, TF32,
                         want)) < 0.5


@pytest.mark.parametrize("shift", DECAYS)
@pytest.mark.parametrize("BH,T,dk,dv,chunk,normalize", CASES)
def test_split_bf16_meets_half_of_each_allowance(BH, T, dk, dv, chunk,
                                                 normalize, shift):
    """The kernel's split (hi and lo each truncated to bf16) meets the
    bf16 rule within half of each allowance in every case, and its y and
    S errors are no larger than one TF32 rounding's: the split keeps
    about 16 significant bits to TF32's 11."""
    q, k, v, a = inputs(BH, T, dk, dv, shift, seed=T + chunk + dk + dv,
                        dtype=jnp.bfloat16)
    want = jref.ref_gla(q, k, v, a, normalize=normalize)
    args = to_torch(q, k, v, a) + [chunk, normalize]
    split = fractions(*args, DESIGN, want)
    tf32 = fractions(*args, TF32, want)
    print(f"split y {split[0]:.4f} S {split[1]:.4f} n {split[2]:.4f}; "
          f"TF32 y {tf32[0]:.4f} S {tf32[1]:.4f}")
    assert max(split) < 0.5, split
    assert split[0] <= tf32[0] and split[1] <= tf32[1], (split, tf32)


# (BH, T, dk, dv, chunk): the wide kernel's heads, xLSTM's mLSTM at
# fleet-xlstm's dk = dv = 256 (W=128) and xlstm-350m's 512 (W=256).
WIDE_CASES = [pytest.param(2, 512, 256, 256, 128, id="mlstm_d256_W128"),
              pytest.param(2, 512, 512, 512, 256, id="mlstm_d512_W256")]


@pytest.mark.parametrize("BH,T,dk,dv,chunk", WIDE_CASES)
def test_wide_design_meets_oracle_tol(BH, T, dk, dv, chunk,
                                      record_property):
    """gla_fwd_wide_bf16's rounding on mLSTM draws, normalizing, at the
    bf16 TOL against the step recurrence; one TF32 rounding of each
    operand is printed beside it."""
    assert kernel_design(torch.bfloat16, dk, dv) == WIDE
    q, k, v, a = mlstm_inputs(BH, T, dk, dv, seed=T + chunk + dk + dv)
    want = jref.ref_gla(q, k, v, a, normalize=True)
    args = to_torch(q, k, v, a) + [chunk, True]
    y, S, n = emulate_kernel(*args, WIDE)
    assert_oracle_close("gla_y", y.to(torch.bfloat16).float().numpy(),
                        want[0], jnp.bfloat16)
    assert_oracle_close("gla_state", S.numpy(), want[1], jnp.bfloat16)
    assert_oracle_close("gla_state", n.numpy(), want[2], jnp.bfloat16)
    fr = {"wide": fractions(*args, WIDE, want),
          "tf32": fractions(*args, TF32, want)}
    for name, (fy, fs, fn) in fr.items():
        record_property(f"y_over_tol_{name}", fy)
        record_property(f"S_over_tol_{name}", fs)
        record_property(f"n_over_tol_{name}", fn)
    print(" ".join(f"{name}: y {fy:.4f} S {fs:.4f} n {fn:.4f};"
                   for name, (fy, fs, fn) in fr.items()))
    assert max(fr["wide"]) < 0.5, fr


def test_one_tf32_rounding_misses_the_tolerance_at_wide_mlstm():
    """Why the wide kernel splits P, S_in and K o w into two TF32 parts:
    on mLSTM draws at dk = dv = 256 (8 heads, W=128, normalizing), one
    TF32 rounding of all three reaches 2.6x the bf16 y allowance; with
    the other two split, S_in or K o w at one rounding still misses it
    and P at one rounding is past half of it (the kernels' rule for
    their operand precision); split, all three meet it with the margin
    of f32."""
    q, k, v, a = mlstm_inputs(8, 512, 256, 256, seed=0)
    want = jref.ref_gla(q, k, v, a, normalize=True)
    args = to_torch(q, k, v, a) + [128, True]
    fr = {"tf32": fractions(*args, TF32, want)[0],
          "wide": fractions(*args, WIDE, want)[0]}
    for keep in WIDE:   # one product left at one TF32 rounding
        fr[f"{keep}_tf32"] = fractions(*args, dict(WIDE, **{keep: "tf32"}),
                                       want)[0]
    print(f"y over the bf16 tol: {fr}")
    assert fr["tf32"] > 2.0, fr
    assert fr["s_in_tf32"] > 1.0 and fr["kw_tf32"] > 1.0, fr
    assert fr["p_tf32"] > 0.5, fr
    assert fr["wide"] < 0.25, fr


# ---------------------------------------------------------------------------
# chip_smoke.py's side of the check (its CPU-testable helpers)
# ---------------------------------------------------------------------------

def test_chip_smoke_bf16_gla_cases_reach_the_kernel_edges():
    """The bf16 tensor-core rows: a ragged last chunk, normalizing at
    W=256, dk != dv with the chunk one 64-row tile, and gla_fwd_bf16<64,
    128> with a chunk that is not a multiple of 64 rows (the rows of a
    TMA tile past W belong to the next chunk); and a bf16 row on the CUDA
    cores."""
    bf16 = [c for c in chip_smoke.GLA_CASES if c[6] == "bf16"]
    tc = [c for c in bf16 if chip_smoke.gla_tensor_cores(c[3], c[4])]
    assert any(T % chunk for _, _, T, _, _, chunk, *_ in tc)
    assert any(norm and chunk == 256 for *_, chunk, _, norm, _ in tc)
    assert any(dk != dv and chunk <= TILE
               for _, _, _, dk, dv, chunk, *_ in tc)
    assert any(dk == 64 and dv == 128 and chunk % TILE and T % chunk
               for _, _, T, dk, dv, chunk, *_ in tc)
    assert any(not chip_smoke.gla_tensor_cores(c[3], c[4]) for c in bf16)


def test_chip_smoke_gla_cases_reach_the_wide_kernel():
    """Wide heads (128 < dk <= 512): at xlstm-350m's prefill (bf16,
    normalize, mLSTM draws, W=256) and train step (T=512), at
    fleet-xlstm's training shape (B=64 x 4 mLSTM heads of 256, T=512,
    W=128, benchmarks/fig_lm_fleet.py:60-63) and ragged at dk = dv = 256
    in both dtypes.  Every bf16 row
    wider than 128 goes to gla_fwd_wide_bf16 (on mLSTM draws), f32 to the
    CUDA cores, and no narrower row to the wide kernel."""
    wide = [c for c in chip_smoke.GLA_CASES if c[3] > 128]
    assert any(dk == dv == 512 and chunk == 256 and dt == "bf16" and norm
               and draw == "mlstm"
               for _, _, _, dk, dv, chunk, dt, norm, draw in wide)
    for dtype in ("bf16", "f32"):
        assert any(dk == dv == 256 and T % chunk and dt == dtype
                   for _, _, T, dk, dv, chunk, dt, *_ in wide)
    assert all(c[-1] in ("mamba2", "mlstm") for c in chip_smoke.GLA_CASES)
    wide_bf16 = {c[0]: c for c in chip_smoke.GLA_CASES
                 if c[6] == "bf16" and max(c[3], c[4]) > 128}
    assert set(wide_bf16) == {"xlstm_350m_prefill_4x4_2048_512_W256",
                              "xlstm_350m_train_4x4_512_512_W256",
                              "bf16_dk256_ragged_8_300_256_W128",
                              "fleet_xlstm_64x4_512_256_W128"}
    assert wide_bf16["fleet_xlstm_64x4_512_256_W128"][1:6] == \
        (64 * 4, 512, 256, 256, 128)
    for _, _, _, dk, dv, _, dt, normalize, draw in wide_bf16.values():
        assert chip_smoke.gla_kernel(True, dk, dv) == "gla_fwd_wide_bf16"
        assert normalize and draw == "mlstm"
    for _, _, _, dk, dv, _, dt, *_ in chip_smoke.GLA_CASES:
        kernel = chip_smoke.gla_kernel(dt == "bf16", dk, dv)
        assert (kernel == "gla_fwd_wide_bf16") == \
            (dt == "bf16" and max(dk, dv) > 128 and dk % 16 == dv % 16 == 0)


def test_chip_smoke_mlstm_draws_follow_the_mlstm():
    """``gla_inputs``'s mLSTM draws: log-decays logsigmoid(N(3, 1)) and k
    scaled per step by exp(clip(2 N, -8, 8)) / sqrt(dk)."""
    g = torch.Generator().manual_seed(0)
    q, k, v, a = chip_smoke.gla_inputs(torch, g, 4, 512, 256, 256,
                                       torch.float32, "mlstm")
    assert float(a.max()) < 0 and abs(float(a.mean()) + 0.07) < 0.03
    scale = k.pow(2).mean(-1).sqrt() * 256 ** 0.5      # per step
    assert float(scale.max()) > 100 and float(scale.min()) < 1e-2
    g = torch.Generator().manual_seed(0)
    _, k2, _, a2 = chip_smoke.gla_inputs(torch, g, 4, 512, 256, 256,
                                         torch.float32, "mamba2")
    assert abs(float(k2.std()) - 0.3) < 0.01 and float(a2.mean()) < -0.1


@pytest.mark.parametrize("dk,dv,want", [
    (64, 64, True), (128, 64, True), (16, 128, True), (16, 40, False),
    (8, 64, False), (144, 64, True), (256, 256, True), (512, 512, True),
    (64, 256, True), (256, 40, False), (264, 256, False), (512, 8, False)])
def test_chip_smoke_gla_route_by_shape(dk, dv, want):
    """bf16 widths that are multiples of 16 take the tensor cores:
    gla_fwd_bf16 up to 128, gla_fwd_wide_bf16 wider (either width);
    every other width, and f32, the CUDA cores."""
    assert chip_smoke.gla_tensor_cores(dk, dv) is want
    kernel = chip_smoke.gla_kernel(True, dk, dv)
    wide = want and max(dk, dv) > 128
    assert kernel == ("gla_fwd" if not want else "gla_fwd_wide_bf16"
                      if wide else "gla_fwd_bf16")
    design = kernel_design(torch.bfloat16, dk, dv)
    assert design == (F32 if not want else WIDE if wide else DESIGN)
    assert kernel_design(torch.float32, dk, dv) == F32
    assert chip_smoke.gla_kernel(False, dk, dv) == "gla_fwd"


GLA_SASS = """
        Function : _ZN12_GLOBAL__N_112gla_fwd_bf16ILi64ELi64EEEv14CUtensorMap_stS1_S1_PKfP13__nv_bfloat16
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR8], R24 ;
        /*0030*/                   HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR8], R24 ;
        Function : _ZN12_GLOBAL__N_17gla_fwdI13__nv_bfloat16Li64EEEvPKT_
        /*0010*/                   FFMA R1, R2, R3, R1 ;
        Function : _ZN12_GLOBAL__N_17gla_fwdIfLi128EEEvPKT_S3_S3_PKfPS1_
        /*0010*/                   FFMA R1, R2, R3, R1 ;
"""
WIDE_SASS = """
        Function : _ZN12_GLOBAL__N_117gla_fwd_wide_bf16ILi64EEEvPK13__nv_bfloat16
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24 ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0030*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
"""
GLA_PTXAS = """ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in the function '_ZN12_GLOBAL__N_112gla_fwd_bf16ILi64ELi64EEEv14CUtensorMap_stS1_S1_PKfP13__nv_bfloat16'
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112gla_fwd_bf16ILi64ELi64EEEv14CUtensorMap_stS1_S1_PKfP13__nv_bfloat16' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117gla_fwd_wide_bf16ILi64EEEvPK13__nv_bfloat16' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 186 registers, used 1 barriers
"""


def test_chip_smoke_counts_hmma_per_gla_instantiation(monkeypatch):
    class Done:
        stdout = GLA_SASS + WIDE_SASS

    class Build:
        _nvcc = staticmethod(lambda: "/cuda/bin/nvcc")
        _target = staticmethod(lambda name: f"/build/lib{name}.so")

    calls = []
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or Done())
    rows = chip_smoke.tensor_core_use(Build, GLA_PTXAS, "gla_scan")
    assert calls == [["/cuda/bin/cuobjdump", "-sass",
                      "/build/libgla_scan.so"]]
    assert rows == {"gla_fwd_bf16<64, 64>": {"hmma": 0, "hgmma": 3,
                                             "registers": 168,
                                             "spill_bytes": 0, "notes": 1},
                    "gla_fwd_wide_bf16<64>": {"hmma": 1, "hgmma": 2,
                                              "registers": 186,
                                              "spill_bytes": 12},
                    "gla_fwd<bf16, 64>": {"hmma": 0, "hgmma": 0},
                    "gla_fwd<float, 128>": {"hmma": 0, "hgmma": 0}}
    # The CUDA-core bf16 instantiation needs none; a wgmma kernel fails
    # without HGMMA (the narrow one now holds no HMMA either), and HGMMA
    # alone is enough.
    Done.stdout = re.sub(r"HGMMA\S*", "FFMA", GLA_SASS) + WIDE_SASS
    with pytest.raises(SystemExit):
        chip_smoke.tensor_core_use(Build, GLA_PTXAS, "gla_scan")
    Done.stdout = GLA_SASS + re.sub(r"HMMA\S*", "FFMA", WIDE_SASS)
    rows = chip_smoke.tensor_core_use(Build, GLA_PTXAS, "gla_scan")
    assert rows["gla_fwd_wide_bf16<64>"]["hmma"] == 0
    Done.stdout = GLA_SASS + re.sub(r"H\w*MMA\S*", "FFMA", WIDE_SASS)
    with pytest.raises(SystemExit):
        chip_smoke.tensor_core_use(Build, GLA_PTXAS, "gla_scan")


@pytest.mark.parametrize("variant", sorted({**gla_variants.PATCHES,
                                            **gla_variants.ABLATIONS}))
def test_gla_variants_patch_the_committed_source(variant):
    """Each design alternative and ablation of kernels/gla_variants.py
    applies to csrc/gla_scan.cu (every anchor once) and changes it, so
    the card times what it names."""
    patches = {**gla_variants.PATCHES, **gla_variants.ABLATIONS}[variant]
    src = _build.patched_source("gla_scan", patches)
    assert (src == _build.patched_source("gla_scan", [])) == (not patches)
