"""The port's serving path on its kernel routes (``use_flash``,
``use_gla_kernel``), on the CPU.

* Against the JAX package: each smoke config's prefill, decode steps and
  greedy ``generate`` with the JAX side's Pallas kernels in interpret
  mode and the port's kernels' plain versions (CPU tensors).  Each leaf
  (logits, cache) is held to the f32 ``flash_o`` (dense) or ``gla_y``
  (zamba2) budget of tests/test_kernel_oracle.py, taken at the leaf's
  largest magnitude: ``max|got - want| <= atol + ulps * ulp(max|want|)``.
  (Elementwise, a budget sized for one kernel call does not bound logits
  two layers on: measured up to 1.6x of it at the smallest logits.)
  Greedy tokens are equal.
* The tolerances of ``chip_smoke.py``'s serving phase: its checks (a)
  kernel prefill vs plain prefill and (b) decode steps vs the kernel
  forward, run here in bf16 with the bf16 kernels' rounding emulated
  (tests/test_torch_flash_numerics.py and tests/test_torch_gla_numerics.py)
  at each served arch's full depth, head and state widths, with d_model,
  d_ff and vocab cut, B=2, T=512.  ``chip_smoke.SERVE_TOL`` must be at
  least twice what they measure (``-s`` prints it).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
import tests.test_torch_flash_numerics as flash_num
import tests.test_torch_gla_numerics as gla_num
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gs
from repro_torch.models.lm import model as tmodel
from tests.test_kernel_oracle import TOL
from tests.test_torch_serve import ARCHS, N_DEC, check, run


def budget_close(kind: str):
    """The f32 ``kind`` budget at the leaf's largest magnitude."""
    atol, ulps = TOL[(kind, "float32")]

    def close(got, want, what: str) -> None:
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert got.shape == want.shape, (what, got.shape, want.shape)
        top = np.float32(max(float(np.abs(want).max()),
                             np.finfo(np.float32).tiny))
        allowed = atol + ulps * float(np.spacing(top))
        err = float(np.abs(got - want).max())
        assert err <= allowed, f"{what}: {err:.3e} > {allowed:.3e} ({kind})"
    return close


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_paths_match_jax_interpret(arch):
    kind = "gla_y" if arch == "zamba2-7b" else "flash_o"
    check(arch, True, range(N_DEC + 1), budget_close(kind))


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_path_generate_greedy_tokens_equal_jax(arch):
    out = run(arch, True)
    np.testing.assert_array_equal(out["port"]["tokens"],
                                  out["jax"]["tokens"])


# ---------------------------------------------------------------------------
# chip_smoke.py's serving tolerances
# ---------------------------------------------------------------------------

# d_model, d_ff and vocab cut; depth, heads, head and state widths kept.
CUT = {"qwen2.5-3b": dict(d_model=512, d_ff=1376, vocab=8192),
       "zamba2-7b": dict(d_model=448, n_heads=4, n_kv_heads=4, d_ff=1792,
                         vocab=8192)}
MARGIN = 2.0
B, T = 2, 512


@pytest.fixture
def emulated_kernels(monkeypatch):
    """The wrappers run the bf16 kernels' rounding emulations on CPU
    tensors (in place of their plain versions)."""
    def flash(q, k, v, causal, window=0):
        o, lse = flash_num.emulate_kernel(q.float(), k.float(), v.float(),
                                          causal, window)
        return o.to(q.dtype), lse

    def gla(q, k, v, a, chunk=128, normalize=False):
        y, S, n = gla_num.emulate_kernel(q.float(), k.float(), v.float(),
                                         a, chunk, normalize, gla_num.DESIGN)
        return y.to(v.dtype), S, n
    monkeypatch.setattr(fa, "flash_attention_fwd", flash)
    monkeypatch.setattr(gs, "gla_scan_fwd", gla)


def serve_errors(cfg, n_steps: int) -> tuple:
    """chip_smoke.run_serve's (a) and (b) on ``cfg`` at B, T."""
    kern = tmodel.build_model(cfg.variant(use_flash=True,
                                          use_gla_kernel=True))
    plain = tmodel.build_model(cfg.variant(use_flash=False,
                                           use_gla_kernel=False))
    params = kern.init(torch.Generator().manual_seed(chip_smoke.SEED))
    g = torch.Generator().manual_seed(chip_smoke.BATCH_SEED)
    toks = torch.randint(0, cfg.vocab, (B, T + n_steps), generator=g)
    batch = {"tokens": toks[:, :T]}
    with torch.inference_mode():
        logits, cache = kern.prefill(params, batch, T + n_steps)
        plain_logits, _ = plain.prefill(params, batch, T + n_steps)
        err_a = chip_smoke.rel_err(logits, plain_logits)
        h = kern.hidden_fn(params, {"tokens": toks})
        h = tmodel._apply_norm(cfg, params["final_norm"], h[:, T - 1:])
        full = (h @ params["lm_head"]).float()
        errs_b = [chip_smoke.rel_err(logits, full[:, 0])]
        for i in range(n_steps):
            step, cache = kern.decode_step(params, toks[:, T + i:T + i + 1],
                                           cache, T + i)
            errs_b.append(chip_smoke.rel_err(step, full[:, 1 + i]))
    return err_a, max(errs_b)


@pytest.mark.parametrize("arch", chip_smoke.SERVE_ARCHS)
def test_chip_serving_tolerances_hold_twice_the_emulated_bf16_error(
        arch, emulated_kernels):
    cfg = get_arch(arch).lm.variant(**CUT[arch])
    assert cfg.dtype == torch.bfloat16
    err_a, err_b = serve_errors(cfg, chip_smoke.SERVE_TF)
    tol_a, tol_b = chip_smoke.SERVE_TOL[arch]
    print(f"{arch}: (a) {err_a:.6f} (tol {tol_a}), (b) {err_b:.6f} "
          f"(tol {tol_b}) of the largest |logit|")
    assert tol_a >= MARGIN * err_a and tol_b >= MARGIN * err_b
