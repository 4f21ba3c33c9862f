"""Designs of the bf16 GLA kernels (``gla_fwd_bf16`` up to 128 wide,
``gla_fwd_wide_bf16`` wider), timed beside the committed
``csrc/gla_scan.cu`` on the card, and optionally beside another tree's
source (the parent commit's, to time a change against it in one call).

A variant is the committed source with text patches (:data:`PATCHES`),
built like the committed one; ``design`` is the committed source.  The
narrow kernel's alternatives: two K / V stages at every width
(``stages2``), the two consumer warpgroups' decays at once rather than
in turns (``no_pingpong``), a block per head rather than a persistent
grid (``per_head``), and hi and lo rounded to nearest by conversion
instructions (``rn_split``, flash's split).

``--ablations`` adds :data:`ABLATIONS`, timed but not held (their
outputs are wrong by construction).  The narrow kernel (``narrow_*``)
without the decays (P = the raw scores), without the scores' wgmma,
without P V, without the state update, without q S_in, and with none of
those products.  The wide kernel without Q S_in, without the state
update, without P V, without the scores' wgmma, and with none of them
(the copies, barriers and the rest of the step); without the proxy fence
after the copies; and without the copies of the Q and K pieces.

``--parent PATH`` adds PATH (a ``gla_scan.cu`` of another tree) as the
variant ``parent``.  Each variant runs through the package's own wrapper
at every shape of :data:`SHAPES` (the bf16 rows of ``chip_smoke.py``'s
``GLA_CASES`` on the main paths -- fleet-gla, zamba2-7b's training group
and its prefill -- and those wider than 128, each on its draw), is held
against the plain version at the bf16 ``gla_y`` / ``gla_state`` rule of
tests/test_kernel_oracle.py,
and is timed as ``chip_smoke.py`` times a kernel (10 calls in one CUDA
graph, the median of 25 replays).  Two rounds, the second in reverse
order, so with ``--parent`` the parent runs first and last.  The exit
code is non-zero when any variant misses the rule.  Needs the card and
``nvcc``::

    PYTHONPATH=src python -m repro_torch.kernels.gla_variants \
        [--parent OTHER_TREE/src/repro_torch/kernels/csrc/gla_scan.cu]
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, gla_scan as gs, ref
from repro_torch.kernels.quant_variants import graph_ms

# (name, BH, T, dk, dv, chunk, normalize, draw), bf16: the narrow kernel
# at fleet-gla's training shape, zamba2-7b's training group (B=8 x 112
# SSM heads) and its prefill (B=4 x 112), on Mamba2 draws; the wide one on
# mLSTM draws.
SHAPES = (("fleet_gla_64x16_512_64_W128", 1024, 512, 64, 64, 128, False,
           "mamba2"),
          ("zamba2_7b_8x112_512_64_W256", 896, 512, 64, 64, 256, False,
           "mamba2"),
          ("zamba2_7b_prefill_4x112_2048_64_W256", 448, 2048, 64, 64, 256,
           False, "mamba2"),
          ("xlstm_350m_prefill_4x4_2048_512_W256", 16, 2048, 512, 512, 256,
           True, "mlstm"),
          ("bf16_dk256_ragged_8_300_256_W128", 8, 300, 256, 256, 128, True,
           "mlstm"),
          ("fleet_xlstm_64x4_512_256_W128", 256, 512, 256, 256, 128, True,
           "mlstm"))
# bf16 gla_y and gla_state: |got - want| <= atol + ulps * ulp_bf16(|want|)
TOL = {"y": (2e-2, 8.0), "state": (1e-2, 64.0)}

_STAGES = "  return DK == 64 ? (DV == 64 ? 4 : 3) : 2;"
_PINGPONG = "constexpr bool kNarrowPingPong = true;"
_GRID = "gla_fwd_bf16<DK, DV><<<min(bh, n_sm), L::THREADS,"
_SPLIT = """  const uint32_t xb = __float_as_uint(x), yb = __float_as_uint(y);
  hi = __byte_perm(xb, yb, 0x7632);
  lo = __byte_perm(__float_as_uint(x - __uint_as_float(xb & 0xffff0000u)),
                   __float_as_uint(y - __uint_as_float(yb & 0xffff0000u)),
                   0x7632);
"""
_SPLIT_RN = """  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
"""
PATCHES: Dict[str, List[Tuple[str, str]]] = {
    "design": [],
    "stages2": [(_STAGES, "  return 2;")],
    "no_pingpong": [(_PINGPONG, _PINGPONG.replace("true", "false"))],
    "per_head": [(_GRID, _GRID.replace("min(bh, n_sm)", "bh"))],
    "rn_split": [(_SPLIT, _SPLIT_RN)],
}

# Timing only (``--ablations``): the design with one part of its step
# taken out, so its outputs are wrong by construction and not held.
_QS = "    if (inter) {\n      // q_i S_in over this piece's rows"
_STATE = "    if (last) {\n      // This piece's 64 rows of the state"
_PV = ("        wgmma_64x64x8_tf32(acc, ph[j], vt_desc(vt_s, j));\n"
       "        wgmma_64x64x8_tf32(acc, pl[j], vt_desc(vt_s, j));\n")
_WGMMA = ("      wgmma_64x64x16(sc, sw128_desc(q_s + 32 * kk), "
          "sw128_desc(k_s + 32 * kk));\n")
_CUTS = {"q_s_in": (_QS, _QS.replace("inter", "false", 1)),
         "state": (_STATE, _STATE.replace("last", "false", 1)),
         "p_v": (_PV, ""),
         "wgmma": (_WGMMA, "")}
_FENCE = "    fence_proxy_async();\n    __syncthreads();\n    const int c = cur.c"
_NO_FENCE = (_FENCE, _FENCE.replace("    fence_proxy_async();\n", "", 1))
_COPY = "    cp_async16(dst + swz(r, ch), in ? src + t * ld + col : src, in ? 16 : 0);\n"
# the narrow kernel's parts
_N_DECAY = "                      ex2(ca_r[e >> 1] - ((e & 1) ? cj.y : cj.x));"
_N_QK = """              wgmma_64x64x16(sc, sw128_desc(qt_s + (kk >> 2) * L::Q_BOX +
                                            (kk & 3) * 32),
                             sw128_desc(kt_s + (kk >> 2) * L::KV_BOX +
                                        (kk & 3) * 32), kk > 0);
"""
_N_PV = """              if constexpr (Y) {
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                  wgmma_rs<DV>(acc, ph[kk],"""
_N_STATE = "          const bool sw = qt == n_qt - 1 && owner;"
_N_QS = """#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss_t<DV>(acc, sw128_desc(qt_s + (kk >> 2) * L::Q_BOX +
                                           (kk & 3) * 32),
                           desc_mn_major(sh_s + kk * 2048, L::S_BOX), kk > 0);
#pragma unroll
          for (int kk = 0; kk < DK / 16; ++kk)
            wgmma_ss_t<DV>(acc, sw128_desc(qt_s + (kk >> 2) * L::Q_BOX +
                                           (kk & 3) * 32),
                           desc_mn_major(sl_s + kk * 2048, L::S_BOX), 1);
"""
_N_CUTS = {"decay": (_N_DECAY, "                      1.0f;"),
           "qk": (_N_QK, "              (void)kk;\n"),
           "pv": (_N_PV, _N_PV.replace("(Y)", "(false)", 1)),
           "state": (_N_STATE, _N_STATE.replace("qt == n_qt - 1 && owner",
                                                "false")),
           "q_s_in": (_N_QS, "")}
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    **{f"narrow_no_{name}": [cut] for name, cut in _N_CUTS.items()},
    "narrow_no_products": [_N_CUTS[n] for n in ("qk", "pv", "state",
                                                "q_s_in")],
    **{f"no_{name}": [cut] for name, cut in _CUTS.items()},
    "copies_only": list(_CUTS.values()),
    "no_proxy_fence": [_NO_FENCE],
    "no_qk_copies": [(_COPY, "")],
}


def ptxas_lines(log: str) -> str:
    """Registers and spill bytes ``ptxas -v`` reported for each
    ``gla_fwd_bf16`` and ``gla_fwd_wide_bf16`` instantiation."""
    name, parts = None, []
    for line in log.splitlines():
        m = re.search(r"entry function '\S*(gla_fwd(?:_wide)?_bf16)I(\S*?)EE",
                      line)
        if "entry function" in line:
            name = f"{m.group(1)}<{m.group(2)}>" if m else None
        elif name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads|Used (\d+) registers", line)
            if m:
                parts.append(f"{name} {m.group(0)}")
    return "; ".join(parts) or "no tensor-core GLA kernel"


def bind(lib: ctypes.CDLL):
    fn = lib.gla_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """The package's wrapper, launching ``lib``'s entry."""
    kernel, fn = gs._kernel, bind(lib)
    gs._kernel = lambda: fn
    try:
        yield
    finally:
        gs._kernel = kernel


def inputs(g, BH, T, dk, dv, draw):
    """bf16 q, k, v and f32 log-decays as ``chip_smoke.gla_inputs`` draws
    them for Mamba2 (``"mamba2"``) or the mLSTM (``"mlstm"``)."""
    q, k, v = (torch.randn(BH, T, d, generator=g, device="cuda")
               for d in (dk, dk, dv))
    a = torch.randn(BH, T, generator=g, device="cuda")
    if draw == "mlstm":
        gate = (2.0 * torch.randn(BH, T, 1, generator=g,
                                  device="cuda")).clamp(-8.0, 8.0)
        k = k / math.sqrt(dk) * torch.exp(gate)
        a = torch.nn.functional.logsigmoid(a + 3.0)
    else:
        k = 0.3 * k
        a = -torch.nn.functional.softplus(a - 2.0)
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), a


def over_tol(kind: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst ``|got - want|`` as a fraction of the bf16 allowance."""
    atol, ulps = TOL[kind]
    w = want.float()
    mag = w.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float(((got.float() - w).abs() / (atol + ulps * ulp)).max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another tree's csrc/gla_scan.cu, timed as "
                         "'parent'")
    ap.add_argument("--ablations", action="store_true",
                    help="also time ABLATIONS (not held to the rule)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gla_variants needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    variants = dict(PATCHES, **(ABLATIONS if args.ablations else {}))
    sources = {n: _build.patched_source("gla_scan", p)
               for n, p in variants.items()}
    if args.parent is not None:
        sources = {"parent": args.parent.read_text(), **sources}
    libs = _build.build_variants("gla_scan", sources)
    for name, (_, log) in libs.items():
        print(f"{name:9s} {ptxas_lines(log)}")
    g = torch.Generator(device="cuda").manual_seed(2)
    cases = []
    for name, BH, T, dk, dv, W, norm, draw in SHAPES:
        q, k, v, a = inputs(g, BH, T, dk, dv, draw)
        want = ref.ref_gla(q, k, v, a, normalize=norm)
        cases.append((name, q, k, v, a, W, norm, want))
    times: Dict[str, Dict[str, list]] = {}
    missed = []
    names = list(sources)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            parts = []
            with using(libs[name][0]):
                for case, q, k, v, a, W, norm, (y_r, S_r, n_r) in cases:
                    y, S, n = gs.gla_scan_fwd(q, k, v, a, W, norm)
                    torch.cuda.synchronize()
                    worst = max(over_tol("y", y, y_r),
                                over_tol("state", S, S_r),
                                over_tol("state", n, n_r))
                    if worst > 1.0 and name not in ABLATIONS:
                        missed.append(f"{name} {case}")
                    ms = graph_ms(lambda: gs.gla_scan_fwd(q, k, v, a, W,
                                                          norm))
                    times.setdefault(name, {}).setdefault(case, []).append(ms)
                    parts.append(f"{case} {worst:.3f} of tol {ms:.5f} ms")
            print(f"{rnd} {name:9s} " + " | ".join(parts), flush=True)
    print("variants " + json.dumps(times))
    for f in missed:
        print(f"misses the bf16 rule: {f}", file=sys.stderr)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
