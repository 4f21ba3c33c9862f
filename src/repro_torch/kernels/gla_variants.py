"""Designs of the wide bf16 GLA kernel, timed beside the committed
``csrc/gla_scan.cu`` on the card, and optionally beside another tree's
source (the parent commit's, to time a change against it in one call).

A variant is the committed source with text patches (:data:`PATCHES`),
built like the committed one; ``design`` is the committed source.

``--ablations`` adds :data:`ABLATIONS`, timed but not held (their
outputs are wrong by construction): the design without Q S_in, without
the state update, without P V, without the scores' wgmma, and with none
of them (the copies, barriers and the rest of the step); without the
proxy fence after the copies; and without the copies of the Q and K
pieces.

``--parent PATH`` adds PATH (a ``gla_scan.cu`` of another tree) as the
variant ``parent``.  Each variant runs through the package's own wrapper
at every shape of :data:`SHAPES` (the bf16 rows of ``chip_smoke.py``'s
``GLA_CASES`` wider than 128, on mLSTM draws), is held against the plain
version at the bf16 ``gla_y`` / ``gla_state`` rule of
tests/test_kernel_oracle.py, and is timed as ``chip_smoke.py`` times a
kernel (10 calls in one CUDA graph, the median of 25 replays).  Two
rounds, the second in reverse order, so with ``--parent`` the parent runs
first and last.  The exit code is non-zero when any variant misses the
rule.  Needs the card and ``nvcc``::

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

# (name, BH, T, dk, dv, chunk), bf16, normalizing, mLSTM draws
SHAPES = (("xlstm_350m_prefill_4x4_2048_512_W256", 16, 2048, 512, 512, 256),
          ("bf16_dk256_ragged_8_300_256_W128", 8, 300, 256, 256, 128),
          ("fleet_xlstm_64x4_512_256_W128", 256, 512, 256, 256, 128))
# bf16 gla_y and gla_state: |got - want| <= atol + ulps * ulp_bf16(|want|)
TOL = {"y": (2e-2, 8.0), "state": (1e-2, 64.0)}

PATCHES: Dict[str, List[Tuple[str, str]]] = {"design": []}

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
ABLATIONS: Dict[str, List[Tuple[str, str]]] = {
    **{f"no_{name}": [cut] for name, cut in _CUTS.items()},
    "copies_only": list(_CUTS.values()),
    "no_proxy_fence": [_NO_FENCE],
    "no_qk_copies": [(_COPY, "")],
}


def ptxas_lines(log: str) -> str:
    """Registers and spill bytes ``ptxas -v`` reported for each
    ``gla_fwd_wide_bf16`` instantiation (none in a parent without it)."""
    name, parts = None, []
    for line in log.splitlines():
        m = re.search(r"entry function '\S*gla_fwd_wide_bf16I(\S*?)EE", line)
        if "entry function" in line:
            name = m.group(1) if m else None
        elif name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads|Used (\d+) registers", line)
            if m:
                parts.append(f"<{name}> {m.group(0)}")
    return "; ".join(parts) or "no gla_fwd_wide_bf16"


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


def mlstm_inputs(g, BH, T, dk, dv):
    """bf16 q, k, v and f32 log-decays as ``chip_smoke.gla_inputs`` draws
    them for the mLSTM."""
    q, k, v = (torch.randn(BH, T, d, generator=g, device="cuda")
               for d in (dk, dk, dv))
    a = torch.randn(BH, T, generator=g, device="cuda")
    gate = (2.0 * torch.randn(BH, T, 1, generator=g, device="cuda")).clamp(
        -8.0, 8.0)
    k = k / math.sqrt(dk) * torch.exp(gate)
    a = torch.nn.functional.logsigmoid(a + 3.0)
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
    for name, BH, T, dk, dv, W in SHAPES:
        q, k, v, a = mlstm_inputs(g, BH, T, dk, dv)
        want = ref.ref_gla(q, k, v, a, normalize=True)
        cases.append((name, q, k, v, a, W, want))
    times: Dict[str, Dict[str, list]] = {}
    missed = []
    names = list(sources)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            parts = []
            with using(libs[name][0]):
                for case, q, k, v, a, W, (y_r, S_r, n_r) in cases:
                    y, S, n = gs.gla_scan_fwd(q, k, v, a, W, True)
                    torch.cuda.synchronize()
                    worst = max(over_tol("y", y, y_r),
                                over_tol("state", S, S_r),
                                over_tol("state", n, n_r))
                    if worst > 1.0 and name not in ABLATIONS:
                        missed.append(f"{name} {case}")
                    ms = graph_ms(lambda: gs.gla_scan_fwd(q, k, v, a, W,
                                                          True))
                    times.setdefault(name, {}).setdefault(case, []).append(ms)
                    parts.append(f"{case} {worst:.3f} of tol {ms:.5f} ms")
            print(f"{rnd} {name:9s} " + " | ".join(parts), flush=True)
    print("variants " + json.dumps(times))
    for f in missed:
        print(f"misses the bf16 rule: {f}", file=sys.stderr)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
