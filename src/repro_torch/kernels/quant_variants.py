"""Launch and tuning variants of the int8 quantizer, timed beside the
committed ``csrc/int8_quant.cu`` on the card.

A variant is the committed source with text patches (:data:`PATCHES`),
built like the committed one, or the committed library with another
slice plan (:data:`PLANS`).  The variants are the alternatives the
design was chosen over:

- ``pdl``: pass 2 launched as a programmatic dependent of pass 1, so its
  blocks are resident before pass 1 ends and wait on the card;
- ``coop``: one cooperative launch, both passes with a grid barrier
  between them;
- ``unroll2`` / ``unroll8``: 16-byte loads in flight per thread;
- ``regs128``: two resident blocks per SM asked of the compiler (up to
  128 registers) instead of four;
- ``blocks1`` ... ``blocks16``: about 1, 2, 8 or 16 blocks per SM
  instead of 4.

Each variant runs both entries (``quantize_int8`` with u = 0.5 and the
wire's ``wire_qdq_int8``) through the package's own wrappers at every
main-path wire shape, is held bitwise against the plain versions, and
is timed as the smoke times a kernel: ``REPS`` calls in one CUDA graph,
the median of ``TRIALS`` replays.  Two rounds, the second in reverse
order.  A launch the card refuses is reported as such; the exit code is
non-zero when any variant disagrees with the plain version.  Needs the
card and ``nvcc``::

    PYTHONPATH=src python -m repro_torch.kernels.quant_variants
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, int8_quant as iq, ref

REPS, TRIALS = 10, 25
SHAPES = ((39, 50176, torch.float32), (33, 50176, torch.float32),
          (6, 50176, torch.float32), (5, 50176, torch.float32),
          (4, 50176, torch.float32), (35, 262144, torch.bfloat16),
          (38, 262144, torch.bfloat16))

_APPLY_LAUNCH = """\
  if (u != nullptr) {
    quant_rows_apply<T, kWire, true><<<grid, kThreads, 0, st>>>(
        x, u, u_const, partial, q, scale, out, n, slice, S, vec_ok);
  } else {
    quant_rows_apply<T, kWire, false><<<grid, kThreads, 0, st>>>(
        x, u, u_const, partial, q, scale, out, n, slice, S, vec_ok);
  }
"""
_BOTH_LAUNCHES = """\
  quant_rows_absmax<T><<<grid, kThreads, 0, st>>>(x, n, slice, S, vec_ok,
                                                   partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
""" + _APPLY_LAUNCH
_ABSMAX_HEAD = """\
  const long long row = blockIdx.x / S;
  const int s = blockIdx.x % S;
  const T* xr = x + row * n;
"""
_APPLY_HEAD = """\
  float m = 0.0f;
  for (int i = threadIdx.x & 31; i < S; i += 32) {
"""

PATCHES: Dict[str, List[Tuple[str, str]]] = {
    "design": [],
    "pdl": [
        (_ABSMAX_HEAD,
         '  asm volatile("griddepcontrol.launch_dependents;");\n'
         + _ABSMAX_HEAD),
        (_APPLY_HEAD,
         '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
         + _APPLY_HEAD),
        (_APPLY_LAUNCH, """\
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* cpartial = partial;
  if (u != nullptr) {
    err = cudaLaunchKernelEx(&cfg, quant_rows_apply<T, kWire, true>, x, u,
                             u_const, cpartial, q, scale, out, n, slice, S,
                             vec_ok);
  } else {
    err = cudaLaunchKernelEx(&cfg, quant_rows_apply<T, kWire, false>, x, u,
                             u_const, cpartial, q, scale, out, n, slice, S,
                             vec_ok);
  }
  if (err != cudaSuccess) return int(err);
"""),
    ],
    "coop": [
        ("#include <stdint.h>\n",
         "#include <stdint.h>\n#include <cooperative_groups.h>\n"),
        ("__global__ void __launch_bounds__(kThreads, kMinBlocks)\n"
         "quant_rows_absmax(",
         "__device__ __forceinline__ void\nquant_rows_absmax("),
        ("__global__ void __launch_bounds__(kThreads, kMinBlocks)\n"
         "quant_rows_apply(",
         "__device__ __forceinline__ void\nquant_rows_apply("),
        # The partials are written by other blocks of the same grid: read
        # them through L2, not the non-coherent read-only path.
        ("    m = nan_max(m, partial[row * S + i]);\n",
         "    m = nan_max(m, __ldcg(partial + row * S + i));\n"),
        ("bool aligned16(const void* p) {\n", """\
template <typename T, bool kWire, bool kNoise>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quant_rows_coop(const T* __restrict__ x, const float* __restrict__ u,
                float u_const, float* partial, int8_t* __restrict__ q,
                float* __restrict__ scale, T* __restrict__ out, long long n,
                long long slice, int S, bool vec_ok) {
  quant_rows_absmax<T>(x, n, slice, S, vec_ok, partial);
  cooperative_groups::this_grid().sync();
  quant_rows_apply<T, kWire, kNoise>(x, u, u_const, partial, q, scale, out,
                                     n, slice, S, vec_ok);
}

bool aligned16(const void* p) {
"""),
        (_BOTH_LAUNCHES, """\
  void* args[] = {(void*)&x, (void*)&u, (void*)&u_const, (void*)&partial,
                  (void*)&q, (void*)&scale, (void*)&out, (void*)&n,
                  (void*)&slice, (void*)&S, (void*)&vec_ok};
  const void* k = u != nullptr ? (const void*)quant_rows_coop<T, kWire, true>
                               : (const void*)quant_rows_coop<T, kWire, false>;
  cudaError_t err = cudaLaunchCooperativeKernel(k, grid, dim3(kThreads),
                                                args, 0, st);
  if (err != cudaSuccess) return int(err);
"""),
    ],
    "unroll2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "regs128": [("constexpr int kMinBlocks = 4;",
                 "constexpr int kMinBlocks = 2;")],
}

# variant -> the grid target (blocks) the committed library is planned for
PLANS = {f"blocks{b}": b * 132 for b in (1, 2, 8, 16)}


def patched_source(name: str) -> str:
    """The committed source with variant ``name``'s patches; each patch's
    text must occur exactly once."""
    return _build.patched_source("int8_quant", PATCHES[name])


@contextlib.contextmanager
def using(lib: ctypes.CDLL, target_blocks: int = iq.TARGET_BLOCKS):
    """The package's wrappers, launching ``lib``'s entries with slices
    planned for ``target_blocks``."""
    kernels, target = iq._kernels, iq.TARGET_BLOCKS
    fns = iq.bind(lib)
    iq._kernels, iq.TARGET_BLOCKS = (lambda: fns), target_blocks
    try:
        yield
    finally:
        iq._kernels, iq.TARGET_BLOCKS = kernels, target


def graph_ms(fn) -> float:
    """Median device ms of one ``fn()``: ``REPS`` calls in one CUDA
    graph, replayed ``TRIALS`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TRIALS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / REPS)
    return statistics.median(times)


def measure(x: torch.Tensor) -> dict:
    """Both entries on ``x``: bitwise against the plain versions, and
    their times."""
    q, s = iq.quantize_int8(x, 0.5)
    qr, sr = ref.ref_quantize_int8(x, 0.5)
    w, wr = iq.wire_qdq_int8(x), ref.ref_wire_qdq_int8(x)
    torch.cuda.synchronize()
    ok = torch.equal(q, qr) and torch.equal(s, sr) and torch.equal(w, wr)
    return {"equal": ok, "q_ms": graph_ms(lambda: iq.quantize_int8(x, 0.5)),
            "w_ms": graph_ms(lambda: iq.wire_qdq_int8(x))}


def main() -> int:
    if not torch.cuda.is_available():
        print("quant_variants needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    libs = {n: lib for n, (lib, _) in _build.build_variants(
        "int8_quant", {n: patched_source(n) for n in PATCHES}).items()}
    runs = [(n, libs[n], iq.TARGET_BLOCKS) for n in PATCHES]
    runs += [(n, libs["design"], t) for n, t in PLANS.items()]
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(m, n, generator=g, device="cuda").to(dt)
          for m, n, dt in SHAPES]
    times: Dict[str, Dict[str, list]] = {}
    unequal = []
    for rnd, order in enumerate((runs, runs[::-1])):
        for name, lib, target in order:
            parts = []
            with using(lib, target):
                for x in xs:
                    key = f"{x.shape[0]}x{x.shape[1]}"
                    S = iq.plan_slices(*x.shape, x.element_size())[0]
                    try:
                        r = measure(x)
                    except RuntimeError as e:
                        # A launch the card refuses (a cooperative grid
                        # larger than fits at once) is a result.
                        parts.append(f"{key} S={S} refused ({e})")
                        continue
                    if not r["equal"]:
                        unequal.append(f"{name} {key}")
                    times.setdefault(name, {}).setdefault(key, []).append(
                        [r["q_ms"], r["w_ms"]])
                    parts.append(f"{key} S={S} ok={r['equal']} "
                                 f"q={r['q_ms'] * 1e3:.2f} "
                                 f"w={r['w_ms'] * 1e3:.2f}")
            print(f"{rnd} {name:8s} " + " | ".join(parts), flush=True)
    print("variants " + json.dumps(times))
    for f in unequal:
        print(f"not bitwise equal to the plain version: {f}",
              file=sys.stderr)
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
