"""Designs of the bf16 flash kernel, timed beside the committed
``csrc/flash_attention.cu`` on the card, and optionally beside another
tree's source (the parent commit's, to time a change against it in one
call).

A variant is the committed source with text patches (:data:`PATCHES`),
built like the committed one.  The variants are the alternatives the
design was chosen over:

- ``design``: the committed source (two consumer warpgroups of 64 query
  rows, key tiles of 128 keys up to hd 128 and 64 at hd 256; each
  warpgroup issues tile i's Q K^T beside tile i - 1's P V and runs tile
  i's softmax under that P V, and the two take turns at issuing their
  products: ping-pong, by named barriers);
- ``plain``: neither overlap: each warpgroup waits for tile i's Q K^T,
  runs its softmax, then issues and waits for its P V, and the two
  warpgroups issue as they come;
- ``no_pingpong``: the design without the turns;
- ``no_overlap``: the design without the overlap within a warpgroup;
- ``bk64``: key tiles of 64 keys at every head width;
- ``stages3``: three stages of K and V up to hd 128 (two at hd 256);
- ``pv128``: at hd 112, P V 128 wide over the second box's zero columns
  (the design runs it 112 wide);
- ``one_wg``: one consumer warpgroup (64 query rows a block), without
  moving registers between the warpgroups.

``--parent PATH`` adds PATH (a ``flash_attention.cu`` of another tree) as
the variant ``parent``.  Each variant runs through the package's own
wrapper at every shape of :data:`SHAPES` (fleet-gla's training shape and
the bf16 prefills of ``chip_smoke.py``'s ``FLASH_CASES``), is held against
the plain version at the bf16 ``flash_o`` / ``flash_lse`` rule of
tests/test_kernel_oracle.py, and is timed as ``chip_smoke.py`` times a
kernel (``quant_variants.graph_ms``: 10 calls in one CUDA graph, the
median of 25 replays).  Two rounds, the second in reverse order, so with
``--parent`` the parent runs first and last; then each shape's best time
per variant.  The exit code is non-zero when any variant misses the
rule.  Needs the card and ``nvcc``::

    PYTHONPATH=src python -m repro_torch.kernels.flash_variants \\
        [--parent OTHER_TREE/src/repro_torch/kernels/csrc/flash_attention.cu]
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, flash_attention as fa, ref
from repro_torch.kernels.quant_variants import graph_ms

# (name, BH, BKV, T, S, hd, causal, window), all bf16
SHAPES = (
    ("fleet_gla_64x8_512_64", 512, 512, 512, 512, 64, True, 0),
    ("whisper_base_encoder_4x8_1500_64", 32, 32, 1500, 1500, 64, False, 0),
    ("zamba2_7b_prefill_4x32_2048_112", 128, 128, 2048, 2048, 112, True, 0),
    ("qwen2_5_3b_prefill_4x16_2048_128_gqa8", 64, 8, 2048, 2048, 128, True,
     0),
    ("qwen2_moe_prefill_4x16_2048_128", 64, 64, 2048, 2048, 128, True, 0),
    ("grok1_prefill_4x48_2048_128_gqa6", 192, 32, 2048, 2048, 128, True, 0),
    ("phi3_medium_prefill_4x40_2048_128_gqa4", 160, 40, 2048, 2048, 128,
     True, 0),
    ("granite_20b_prefill_4x48_2048_128_mqa", 192, 4, 2048, 2048, 128, True,
     0),
    ("pixtral_12b_prefill_4x32_2048_128_gqa4", 128, 32, 2048, 2048, 128,
     True, 0),
    ("gemma3_12b_global_4x16_2048_256_gqa2", 64, 32, 2048, 2048, 256, True,
     0),
    ("gemma3_12b_local_4x16_2048_256_w1024", 64, 32, 2048, 2048, 256, True,
     1024),
)
# bf16 flash_o and flash_lse: |got - want| <= atol + ulps * ulp_bf16(|want|)
TOL = {"o": (1e-3, 4.0), "lse": (2e-5, 64.0)}

_BLOCK_K = "  return HD == 256 ? 64 : 128;\n"
_STAGES = "constexpr int bf16_stages() {\n  return 2;\n"
_PVN = "  static constexpr int PVN = HD;"
_OVERLAP = "constexpr bool kOverlap = true;\n"
_PINGPONG = "constexpr bool kPingPong = true;\n"
_CONSUMERS = "constexpr int kConsumers = 2;\n"
_REGS_DEC = '    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n" ::: "memory");\n'
_REGS_INC = '    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n" ::: "memory");\n'

PATCHES: Dict[str, List[Tuple[str, str]]] = {
    "design": [],
    "plain": [(_OVERLAP, _OVERLAP.replace("true", "false")),
              (_PINGPONG, _PINGPONG.replace("true", "false"))],
    "no_pingpong": [(_PINGPONG, _PINGPONG.replace("true", "false"))],
    "no_overlap": [(_OVERLAP, _OVERLAP.replace("true", "false"))],
    "bk64": [(_BLOCK_K, "  return 64;\n")],
    "stages3": [(_STAGES, _STAGES.replace("2;", "HD == 256 ? 2 : 3;"))],
    "pv128": [(_PVN, "  static constexpr int PVN = 64 * NB;")],
    "one_wg": [(_CONSUMERS, _CONSUMERS.replace("2", "1")),
               (_PINGPONG, _PINGPONG.replace("true", "false")),
               (_REGS_DEC, ""), (_REGS_INC, "")],
}


def patched_source(name: str) -> str:
    """The committed source with variant ``name``'s patches; each patch's
    text must occur exactly once."""
    return _build.patched_source("flash_attention", PATCHES[name])


def ptxas_line(log: str) -> str:
    """Registers, spill bytes and injected-warpgroup notes (``C75xx``)
    ``ptxas -v`` reported for each ``flash_fwd_bf16`` instantiation."""
    name, parts, notes = None, {}, {}
    for line in log.splitlines():
        m = re.search(r"\(C75\d\d\).* in function '\S*flash_fwd_bf16I"
                      r"Li(\d+)E", line)
        if m:
            notes[m.group(1)] = notes.get(m.group(1), 0) + 1
            continue
        if "entry function" in line:
            m = re.search(r"flash_fwd_bf16ILi(\d+)E", line)
            name = m.group(1) if m else None
        elif name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads|Used (\d+) registers", line)
            if m:
                parts.setdefault(name, []).append(m.group(0))
    return "; ".join(f"<{hd}> " + ", ".join(p) +
                     (f", {notes[hd]} injected notes" if hd in notes else "")
                     for hd, p in sorted(parts.items(), key=lambda x:
                                         int(x[0])))


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's csrc/flash_attention.cu, timed as "
                         "'parent'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_variants needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sources = {n: patched_source(n) for n in PATCHES}
    if args.parent is not None:
        sources = {"parent": args.parent.read_text(), **sources}
    libs = _build.build_variants("flash_attention", sources)
    for name, (_, log) in libs.items():
        print(f"{name:10s} flash_fwd_bf16 {ptxas_line(log)}")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, BH, BKV, T, S, hd, causal, window in SHAPES:
        q, k, v = (torch.randn(n, L, hd, generator=g, device="cuda")
                   .to(torch.bfloat16) for n, L in ((BH, T), (BKV, S),
                                                    (BKV, S)))
        want = ref.ref_flash_attention(q, k, v, causal=causal, window=window)
        cases.append((name, q, k, v, causal, window, want))
    times: Dict[str, Dict[str, list]] = {}
    missed = []
    names = list(sources)
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
            print(f"{rnd} {name:10s} " + " | ".join(parts), flush=True)
    for case, *_ in cases:
        print(f"{case}: " + ", ".join(f"{n} {min(t[case]):.5f}"
                                      for n, t in times.items()))
    print("variants " + json.dumps(times))
    for f in missed:
        print(f"misses the bf16 rule: {f}", file=sys.stderr)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
