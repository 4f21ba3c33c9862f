"""Rounding points of the bf16 tensor-core flash kernel, checked on the CPU.

``csrc/flash_attention.cu``'s ``flash_fwd_bf16`` cannot run here, so this
file emulates where it rounds and holds the result against the JAX
package's reference (``repro.kernels.ref.ref_flash_attention``) at the
bf16 ``flash_o`` / ``flash_lse`` rule of tests/test_kernel_oracle.py
(``atol + ulps * ulp_bf16(|want|)``), the rule ``chip_smoke.py`` holds
the kernel to on the card.  The emulation (a test helper, not a plain
version of the port) follows the kernel:

* 128-row query tiles and key tiles of 128 keys (64 at hd 256:
  :func:`block_k`), and the kernel's tile-skip rule;
* scores in f32 from bf16 inputs (each product is exact in f32), left
  unscaled: ``p = 2^((s - m) * scale * log2 e)`` and
  ``lse = m * scale + log l``, with ``m`` the running max of the
  unscaled scores and masked scores at -1e30;
* online max and sum in f32, ``l`` summing the f32 ``p``;
* ``p`` split into ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, the A
  operands of two bf16 ``P V`` products with f32 accumulation
  (:func:`round_split`): rounded to bf16 alone, it misses the bf16
  ``flash_o`` allowance at T=512 (by up to 1.5x here), which the last
  test pins, while the split and the TF32 rounding of the earlier
  ``mma.sync`` kernel meet it;
* ``o / max(l, 1e-30)`` rounded to bf16, ``lse`` in f32.

With ``p`` left in f32 and f32 inputs, the same emulation must meet the
f32 rule, which checks its tiling and masking apart from the rounding,
at the bf16 kernel's tiles and at the f32 kernel's 64 by 64.  Each case
records its worst error as a fraction of the allowance
(``o_err_over_tol``, ``lse_err_over_tol``, and ``o`` with ``p`` rounded
to bf16, TF32 or kept in f32 instead); ``-s`` prints them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_variants
from tests.test_kernel_oracle import TOL, _ulp, assert_oracle_close
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

BLOCK_Q = 128
NEG_INF = -1e30


def block_k(hd: int) -> int:
    """Keys per tile of ``flash_fwd_bf16`` (``bf16_block_k``)."""
    return 64 if hd == 256 else 128


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32, round to nearest even (``cvt.rn.bf16x2.f32``)."""
    return x.to(torch.bfloat16).float()


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 (10 mantissa bits), round to nearest with ties away
    from zero (``cvt.rna.tf32.f32``), for finite x of either sign (the
    carry rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def round_split(x: torch.Tensor) -> torch.Tensor:
    """``hi + lo`` with ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, both
    rounded to nearest even: what two bf16 products with A = hi and A = lo
    add up to (``hi + lo`` is exact in f32)."""
    hi = round_bf16(x)
    return hi + round_bf16(x - hi)


def emulate_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, window: int, p_round=round_split,
                   tiles=None):
    """The kernel's arithmetic: q ``[BH, T, hd]``, k/v ``[BKV, S, hd]``
    (f32 tensors holding the kernel's input values), ``p`` rounded by
    ``p_round`` (None: kept in f32) before ``P V``, over query and key
    tiles ``tiles = (rows, keys)`` (default the bf16 kernel's:
    ``(BLOCK_Q, block_k(hd))``).  Returns ``(o f32 [BH, T, hd] before
    the final rounding, lse f32 [BH, T])``."""
    BH, T, hd = q.shape
    bq, bk = tiles or (BLOCK_Q, block_k(hd))
    BKV, S, _ = k.shape
    rep = BH // BKV
    scale = 1.0 / (hd ** 0.5)
    c2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    kf = k.repeat_interleave(rep, 0)
    vf = v.repeat_interleave(rep, 0)
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32)
    for q0 in range(0, T, bq):
        q1 = min(q0 + bq, T)
        rows = torch.arange(q0, q1)
        lo, hi = 0, -(-S // bk)
        if T == S:
            if causal:
                hi = min(hi, (q1 - 1) // bk + 1)
            if window > 0:
                lo = max(0, q0 - window + 1) // bk
        m = torch.full((BH, q1 - q0), NEG_INF)
        l = torch.zeros((BH, q1 - q0))
        acc = torch.zeros((BH, q1 - q0, hd))
        for kt in range(lo, hi):
            k0, k1 = kt * bk, min(kt * bk + bk, S)
            s = q[:, q0:q1] @ kf[:, k0:k1].transpose(1, 2)
            keys = torch.arange(k0, k1)
            keep = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                keep &= rows[:, None] >= keys[None, :]
            if window > 0:
                keep &= keys[None, :] > rows[:, None] - window
            if not bool(keep.all()):
                s.masked_fill_(~keep, NEG_INF)
            mn = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - mn) * c2)
            p = s.sub_(mn[..., None]).mul_(c2).exp2_()   # in place: s is done
            l = alpha * l + p.sum(-1)
            if p_round is not None:
                p = p_round(p)
            acc.mul_(alpha[..., None]).add_(p @ vf[:, k0:k1])
            m = mn
        safe = l.clamp_min(1e-30)
        o[:, q0:q1] = acc / safe[..., None]
        lse[:, q0:q1] = torch.where(m == NEG_INF, m, m * scale) + \
            torch.log(safe)
    return o, lse


def over_tol(kind: str, got: np.ndarray, want, dtype) -> float:
    """Worst ``|got - want|`` as a fraction of the TOL allowance."""
    atol, ulps = TOL[(kind, jnp.dtype(dtype).name)]
    w = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - w)
    return float(np.max(err / (atol + ulps * _ulp(w, dtype))))


# (BH, BKV, T, S, hd, causal, window): the main paths' widths at T=512,
# then the edges chip_smoke.py drives in bf16 on the card.
CASES = [
    pytest.param(4, 4, 512, 512, 64, True, 0, id="causal_512_hd64"),
    pytest.param(4, 4, 512, 512, 112, True, 0, id="causal_512_hd112"),
    pytest.param(4, 2, 512, 512, 64, True, 0, id="gqa_causal_512_hd64"),
    pytest.param(2, 2, 512, 512, 128, True, 128, id="window128_512_hd128"),
    pytest.param(4, 2, 300, 300, 64, True, 0, id="ragged_300_hd64"),
    pytest.param(2, 2, 200, 200, 112, False, 64, id="noncausal_w64_hd112"),
    pytest.param(4, 2, 128, 384, 128, False, 0, id="cross_128x384_hd128"),
    # gemma3-12b's heads of 256 over half as many KV heads, windowed (five
    # layers in six; the window binds on half the rows, as 1,024 does at
    # the card's 2,048) and global
    pytest.param(2, 1, 512, 512, 256, True, 256, id="window256_512_hd256"),
    pytest.param(2, 1, 512, 512, 256, True, 0, id="causal_512_hd256"),
]


def inputs(BH, BKV, T, S, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, T, hd)).astype(np.float32),
            rng.standard_normal((BKV, S, hd)).astype(np.float32),
            rng.standard_normal((BKV, S, hd)).astype(np.float32))


@pytest.mark.parametrize("BH,BKV,T,S,hd,causal,window", CASES)
def test_bf16_design_meets_oracle_tol(BH, BKV, T, S, hd, causal, window,
                                      record_property):
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16)
               for a in inputs(BH, BKV, T, S, hd, seed=T + S + hd))
    want_o, want_l = jref.ref_flash_attention(q, k, v, causal=causal,
                                              window=window)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  for a in (q, k, v))
    o, lse = emulate_kernel(tq, tk, tv, causal, window)
    o = o.to(torch.bfloat16).float().numpy()
    assert_oracle_close("flash_o", o, want_o, jnp.bfloat16)
    assert_oracle_close("flash_lse", lse.numpy(), want_l, jnp.bfloat16)
    frac_o = over_tol("flash_o", o, want_o, jnp.bfloat16)
    frac_l = over_tol("flash_lse", lse.numpy(), want_l, jnp.bfloat16)
    record_property("o_err_over_tol", frac_o)
    record_property("lse_err_over_tol", frac_l)
    # The alternatives, for the record: p rounded to bf16 or TF32 (the
    # earlier mma.sync kernel's), p kept in f32.
    alt = {}
    for name, p_round in (("bf16_p", round_bf16), ("tf32_p", round_tf32),
                          ("f32_p", None)):
        o_alt, _ = emulate_kernel(tq, tk, tv, causal, window,
                                  p_round=p_round)
        alt[name] = over_tol("flash_o", o_alt.to(torch.bfloat16).float()
                             .numpy(), want_o, jnp.bfloat16)
        record_property(f"o_err_over_tol_{name}", alt[name])
    print(f"o {frac_o:.4f} of tol (bf16 p {alt['bf16_p']:.4f}, TF32 p "
          f"{alt['tf32_p']:.4f}, f32 p {alt['f32_p']:.4f}), lse "
          f"{frac_l:.4f} of tol")


@pytest.mark.parametrize("kernel", ["f32", "bf16"])
@pytest.mark.parametrize("BH,BKV,T,S,hd,causal,window", CASES)
def test_emulated_tiling_meets_f32_tol(BH, BKV, T, S, hd, causal, window,
                                       kernel):
    """The tiles of ``flash_fwd_f32`` (64 by 64) and of ``flash_fwd_bf16``
    (128 rows by :func:`block_k` keys), in f32."""
    q, k, v = inputs(BH, BKV, T, S, hd, seed=T + S + hd + 1)
    want_o, want_l = jref.ref_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window)
    tiles = (64, 64) if kernel == "f32" else (BLOCK_Q, block_k(hd))
    o, lse = emulate_kernel(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal, window,
                            p_round=None, tiles=tiles)
    assert_oracle_close("flash_o", o.numpy(), want_o, jnp.float32)
    assert_oracle_close("flash_lse", lse.numpy(), want_l, jnp.float32)


@pytest.mark.parametrize("p_round,meets", [
    pytest.param(round_bf16, False, id="bf16_misses"),
    pytest.param(round_split, True, id="split_meets"),
    pytest.param(round_tf32, True, id="tf32_meets")])
def test_bf16_p_misses_the_tolerance_where_tf32_p_meets_it(p_round, meets):
    """Why the kernel splits p: rounded to bf16 (8 significant bits) the
    bf16 ``flash_o`` allowance is exceeded at the main paths' T=512;
    split into two bf16 parts (about 16 bits), as the kernel runs it, or
    rounded to TF32 (11 bits), as the earlier ``mma.sync`` kernel did, it
    is met with room."""
    BH, BKV, T, S, hd = 4, 4, 512, 512, 112
    q, k, v = (jnp.asarray(a).astype(jnp.bfloat16)
               for a in inputs(BH, BKV, T, S, hd, seed=T + S + hd))
    want_o, _ = jref.ref_flash_attention(q, k, v, causal=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  for a in (q, k, v))
    o, _ = emulate_kernel(tq, tk, tv, True, 0, p_round=p_round)
    frac = over_tol("flash_o", o.to(torch.bfloat16).float().numpy(), want_o,
                    jnp.bfloat16)
    assert (frac < 0.5) if meets else (frac > 1.0), frac


# ---------------------------------------------------------------------------
# chip_smoke.py's side of the check (its CPU-testable helpers)
# ---------------------------------------------------------------------------

def test_chip_smoke_holds_kernels_to_the_oracle_tol():
    assert chip_smoke.TOL == TOL


def test_chip_smoke_bf16_cases_reach_the_kernel_edges():
    """The bf16 rows drive a ragged last query tile at every head width
    (causal at some), a non-causal window, T != S, and GQA up to MQA."""
    bf16 = [c for c in chip_smoke.FLASH_CASES if c[6] == "bf16"]
    assert any(T % BLOCK_Q and causal
               for _, _, _, T, _, _, _, causal, _ in bf16)
    for width in fa.HEAD_DIMS:
        assert any(T % BLOCK_Q for _, _, _, T, _, hd, *_ in bf16
                   if hd == width), width
    # granite-20b's MQA: 48 query heads a KV head
    assert max(BH // BKV for _, BH, BKV, *_ in bf16) == 48
    assert any(not causal and window > 0
               for *_, causal, window in bf16)
    assert any(T != S and not causal and window == 0
               for _, _, _, T, S, _, _, causal, window in bf16)
    assert {hd for *_, hd, _, _, _ in bf16} == {64, 112, 128, 256}
    assert {hd for *_, hd, _, _, _ in chip_smoke.FLASH_CASES} == \
        set(fa.HEAD_DIMS)


def test_chip_smoke_times_sdpa_with_the_kernels_window():
    """The library call of a windowed row: SDPA with the mask the kernel
    applies (``kpos > qpos - window``, and causal), as a boolean [T, S]."""
    T, window = 9, 3
    for causal in (True, False):
        keep = chip_smoke.window_mask(torch, T, T, causal, window, "cpu")
        q, k = np.arange(T)[:, None], np.arange(T)[None, :]
        want = (k > q - window) & ((k <= q) if causal else True)
        np.testing.assert_array_equal(keep.numpy(), want)
        assert int(keep.sum()) == chip_smoke.attention_pairs(T, T, causal,
                                                              window)


@pytest.mark.parametrize("name", sorted(flash_variants.PATCHES))
def test_flash_variants_patch_the_committed_source(name):
    """Each hd-256 variant's anchors occur once in csrc/flash_attention.cu
    (a moved anchor fails here, not on the card)."""
    src = flash_variants.patched_source(name)
    assert (src == (fa._build.CSRC / "flash_attention.cu").read_text()) == \
        (name == "design")


def test_flash_variants_read_the_hd256_kernels_registers():
    """``ptxas_line`` reads registers, spills and injected-warpgroup notes
    of every ``flash_fwd_bf16`` instantiation (hd 256 among them), and
    nothing of the f32 kernel's."""
    wide = PTXAS.replace("ILi64E", "ILi256E").replace("128 registers",
                                                      "255 registers")
    assert flash_variants.ptxas_line(PTXAS + wide) == (
        "<64> 4 bytes spill stores, 8 bytes spill loads, Used 128 "
        "registers, 1 injected notes; <256> 4 bytes spill stores, 8 bytes "
        "spill loads, Used 255 registers, 1 injected notes")
    f32 = PTXAS.replace("flash_fwd_bf16", "flash_fwd_f32")
    assert flash_variants.ptxas_line(f32) == ""


@pytest.mark.parametrize("T,S,causal,window,want", [
    (4, 4, True, 0, 10), (128, 384, False, 0, 128 * 384),
    (6, 6, False, 2, 26), (6, 6, True, 3, 15)])
def test_chip_smoke_counts_unmasked_pairs(T, S, causal, window, want):
    assert chip_smoke.attention_pairs(T, S, causal, window) == want


SASS = """
        Function : _ZN12_GLOBAL__N_114flash_fwd_bf16ILi64EEEvPK13__nv_bfloat16
        /*0010*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R88, R8, gdesc[UR8], R88 ;
        /*0030*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        Function : _ZN12_GLOBAL__N_113flash_fwd_f32ILi64EEEvPKfS2_S2_PfS3_
        /*0010*/                   FFMA R1, R2, R3, R1 ;
"""
PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114flash_fwd_bf16ILi64EEEvPK13__nv_bfloat16' for 'sm_90a'
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : (C7519) warpgroup.arrive is injected in around line 12 by compiler to allow use of registers in GMMA in function '_ZN12_GLOBAL__N_114flash_fwd_bf16ILi64EEEvPK13__nv_bfloat16'
"""


def test_chip_smoke_counts_hmma_per_instantiation(monkeypatch):
    """HMMA and HGMMA per kernel instantiation from the SASS, registers,
    spills and injected-warpgroup notes from ``ptxas -v``; a bf16 kernel
    without tensor-core instructions fails, and so does a wgmma kernel
    (``flash_fwd_bf16``) without HGMMA."""
    class Done:
        stdout = SASS

    class Build:
        _nvcc = staticmethod(lambda: "/cuda/bin/nvcc")
        _target = staticmethod(lambda name: f"/build/lib{name}.so")

    calls = []
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or Done())
    rows = chip_smoke.tensor_core_use(Build, PTXAS)
    assert calls == [["/cuda/bin/cuobjdump", "-sass",
                      "/build/libflash_attention.so"]]
    assert rows == {"flash_fwd_bf16<64>": {"hmma": 1, "hgmma": 2,
                                           "notes": 1, "registers": 128,
                                           "spill_bytes": 12},
                    "flash_fwd_f32<64>": {"hmma": 0, "hgmma": 0}}
    Done.stdout = SASS.replace("HGMMA", "FFMA")   # mma.sync alone
    with pytest.raises(SystemExit):
        chip_smoke.tensor_core_use(Build, PTXAS)
    Done.stdout = SASS.replace("HGMMA", "FFMA").replace("HMMA", "FFMA")
    with pytest.raises(SystemExit):
        chip_smoke.tensor_core_use(Build, PTXAS)
