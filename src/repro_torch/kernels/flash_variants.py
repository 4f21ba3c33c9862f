"""Designs of the bf16 flash kernel at head width 256, timed beside the
committed ``csrc/flash_attention.cu`` on the card.

A variant is the committed source with text patches (:data:`PATCHES`),
built like the committed one.  The variants are the alternatives the
hd-256 design was chosen over:

- ``design``: the committed source (128 query rows and 8 warps per
  block, Q's fragments read from shared memory at each k-step);
- ``bq64``: 64 query rows and 4 warps per block, Q read as in the design;
- ``qreg``: 64 query rows, Q's fragments held in registers for the whole
  loop, as at hd 64 to 128 (224 registers of fragments, accumulator and
  scores: ptxas spills).

Each variant runs through the package's own wrapper at every shape of
:data:`SHAPES` (gemma3-12b's prefill, B=4 x 16 query heads over 8 KV
heads, T = S = 2,048: global and windowed at 1,024, and a ragged
windowed one), is held against the plain version at the bf16 ``flash_o``
/ ``flash_lse`` rule of tests/test_kernel_oracle.py, and is timed as
``chip_smoke.py`` times a kernel (``quant_variants.graph_ms``: 10 calls
in one CUDA graph, the median of 25 replays).  Two rounds, the second in
reverse order.  The exit code is non-zero when any variant misses the
rule.  Needs the card and ``nvcc``::

    PYTHONPATH=src python -m repro_torch.kernels.flash_variants
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, flash_attention as fa, ref
from repro_torch.kernels.quant_variants import graph_ms

# (name, BH, BKV, T, S, causal, window), all bf16 at hd 256
SHAPES = (("global_4x16_2048", 64, 32, 2048, 2048, True, 0),
          ("local_4x16_2048_w1024", 64, 32, 2048, 2048, True, 1024),
          ("ragged_w64_8x4_300", 8, 4, 300, 300, True, 64))
HD = 256
# bf16 flash_o and flash_lse: |got - want| <= atol + ulps * ulp_bf16(|want|)
TOL = {"o": (1e-3, 4.0), "lse": (2e-5, 64.0)}

_BLOCK_Q = "  return HD == 256 ? 128 : 64;\n"
_Q_IN_REGS = "  return HD <= 128;\n"

PATCHES: Dict[str, List[Tuple[str, str]]] = {
    "design": [],
    "bq64": [(_BLOCK_Q, "  return 64;\n")],
    "qreg": [(_BLOCK_Q, "  return 64;\n"), (_Q_IN_REGS, "  return true;\n")],
}


def patched_source(name: str) -> str:
    """The committed source with variant ``name``'s patches; each patch's
    text must occur exactly once."""
    return _build.patched_source("flash_attention", PATCHES[name])


def ptxas_line(log: str) -> str:
    """Registers and spill bytes ``ptxas -v`` reported for
    ``flash_fwd_bf16<256>`` (mangled ``flash_fwd_bf16ILi256E``)."""
    found, parts = False, []
    for line in log.splitlines():
        if "entry function" in line:
            found = "flash_fwd_bf16ILi256E" in line
        elif found:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads|Used (\d+) registers", line)
            if m:
                parts.append(m.group(0))
    return "; ".join(parts)


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The package's wrapper, launching ``lib``'s entry."""
    kernel, fn = fa._kernel, fa.bind(lib)
    fa._kernel = lambda: fn
    try:
        yield
    finally:
        fa._kernel = kernel


def over_tol(kind: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst ``|got - want|`` as a fraction of the bf16 allowance."""
    atol, ulps = TOL[kind]
    w = want.float()
    mag = w.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    err = (got.float() - w).abs()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((err / (atol + ulps * ulp)).max())


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = _build.build_variants(
        "flash_attention", {n: patched_source(n) for n in PATCHES})
    for name, (_, log) in libs.items():
        print(f"{name:8s} flash_fwd_bf16<256>: {ptxas_line(log)}")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, BH, BKV, T, S, causal, window in SHAPES:
        q, k, v = (torch.randn(n, L, HD, generator=g, device="cuda")
                   .to(torch.bfloat16) for n, L in ((BH, T), (BKV, S),
                                                    (BKV, S)))
        want = ref.ref_flash_attention(q, k, v, causal=causal, window=window)
        cases.append((name, q, k, v, causal, window, want))
    times: Dict[str, Dict[str, list]] = {}
    missed = []
    names = list(PATCHES)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            parts = []
            with using(libs[name][0]):
                for case, q, k, v, causal, window, (o_r, lse_r) in cases:
                    o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
                    torch.cuda.synchronize()
                    worst = max(over_tol("o", o, o_r),
                                over_tol("lse", lse, lse_r))
                    if worst > 1.0:
                        missed.append(f"{name} {case}")
                    ms = graph_ms(lambda: fa.flash_attention_fwd(
                        q, k, v, causal, window))
                    times.setdefault(name, {}).setdefault(case, []).append(ms)
                    parts.append(f"{case} {worst:.3f} of tol {ms:.5f} ms")
            print(f"{rnd} {name:8s} " + " | ".join(parts), flush=True)
    print("variants " + json.dumps(times))
    for f in missed:
        print(f"misses the bf16 rule: {f}", file=sys.stderr)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
