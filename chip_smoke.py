"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Phases (every one that fails exits non-zero; there is no CPU path):

1. Card: ``nvidia-smi`` name and power limit; TF32 off for cuDNN and
   matmul, so f32 means f32.
2. Build: every CUDA source under ``src/repro_torch/kernels/csrc/`` with
   ``nvcc`` (one process per source, all at once); the tensor-core
   instructions (HMMA from ``mma.sync``, HGMMA from ``wgmma``) of each
   ``flash_fwd`` and ``gla_fwd`` instantiation, by ``cuobjdump -sass``
   (the three libraries' listings are kept for phase 15), beside its
   registers, spills and ``ptxas``'s injected-warpgroup notes: every
   tensor-core (``*_bf16``) one must have some, and every
   ``flash_fwd_bf16`` and ``gla_fwd_wide_bf16`` one HGMMA.
3. Kernels vs their plain versions, on the card, at the main paths'
   shapes and a few more (the quantizer's AlexNet rows are derived from
   the plans of phases 4, 5 and 8 and their loops' numpy replays): both
   int8 entries (``quantize_int8`` and the
   wire's fused ``wire_qdq_int8``, the latter also timed against the
   composition it replaced) bitwise, NaN, +-inf, ragged and misaligned
   rows included; flash attention and the GLA scan within the ``TOL``
   rule of tests/test_kernel_oracle.py (``atol + ulps * ulp`` in the
   storage dtype), at phase 9's prefill shapes too (the GLA at
   xlstm-350m's 512-wide heads on the wide tensor-core kernel, flash at
   gemma3-12b's 256-wide heads, global and windowed).  Times from CUDA
   events over CUDA-graph replays (device time, L2 warm); the library
   time is one PyTorch call computing the same function, where there is
   one (``scaled_dot_product_attention``; a window goes in as an explicit
   boolean mask).
4. AlexNet 224x224 at full width, B=64, int8 wire: ``Fleet.from_table2``
   -> ``plan`` -> ``Plan.init_params`` -> ``Plan.step_fn`` on the M=1
   triple and the M=4 star; ``wire="none"`` on the same cuts against
   the vanilla SGD step; the int8-vs-none loss gap.
5. The same AlexNet plans through ``Plan.train`` on ``SyntheticImages``
   (cuDNN held to deterministic algorithms), with a straggler that
   moves the schedule and lets it come back: finite, falling losses;
   schedules and simulated walls equal to the loop's numpy planning
   replayed with no step; a second run bitwise equal; a run killed
   after step 7 and resumed from its step-6 checkpoint bitwise equal;
   the ms of each part of a loop step (data batch, host-to-device copy,
   step, re-solve, checkpoint save and restore), the loop's device idle
   share from one profiled short run, and ``measure_profile(alexnet())``
   per cut on the card.
6. LM ``fleet-gla`` (zamba stack: 12 Mamba2 blocks, an attention block
   every 4, d_model 512, vocab 32,000), T=512, B=64, int8 wire:
   ``Fleet.lm_default(m)`` -> ``plan`` -> ``Plan.step_fn`` on M=1 and
   M=4 through all three kernels; an f32 ``wire="none"`` variant on the
   same cuts against ``reference_sgd_step``; the per-token int8 gap.
7. LM zamba2-7b at its published widths, depth cut to one group (6
   Mamba2 blocks + 1 attention block), T=512, B=8: ``plan`` ->
   ``step_fn``, 3 steps through flash attention and the GLA scan.
   After its checked steps each ``step_fn`` path (4, 6, 7, 8) runs one
   step under ``torch.profiler``: device busy time against wall time, and
   the kernels that took the most.
8. AlexNet on the fleets of benchmarks/fig_tree.py:29-31 (M=4, a 2 Mbps
   backhaul per edge, E = 1, 2, 4 edge servers), B=64, int8 wire:
   ``plan`` -> ``Plan.step_fn``, ten steps per plan with the quantizer's
   launches read after every step (2 per stream crossing that carries
   samples); ``wire="none"`` on the same cuts against vanilla SGD; the
   int8-vs-none loss gap; ``p.explain()`` and ``p.simulate()``.  At E=1
   the tree step and the star step, from the same params and batch under
   ``cudnn.deterministic``, must be bitwise equal.  Then phase 5's
   ``Plan.train`` checks on the E=2 tree, with its own straggler.
9. Serving zamba2-7b, qwen2.5-3b, qwen2-moe-a2.7b, xlstm-350m,
   whisper-base, gemma3-12b, phi3-medium-14b, granite-20b and pixtral-12b
   at their published configs, full depth, and grok-1-314b at its
   published widths cut to 2 of 64 layers (listed as reduced), bf16,
   ``use_flash`` and ``use_gla_kernel``: ``build_model`` -> ``init`` on
   the card -> ``generate`` (B=4 prompts of 2,048 positions: pixtral-12b's
   are 1,024 seeded bf16 patch embeddings, then 1,024 tokens, and its
   decode positions count them; whisper-base 64 tokens over 1,500 seeded
   frames, max_len 448; 32 greedy new tokens), twice, bitwise equal; (a)
   the kernel prefill's
   last logits against the same prefill on the plain paths, (b) eight
   teacher-forced decode steps against the kernel forward over the
   prompt and those tokens (MoE: on a no-drop variant), both within
   ``SERVE_TOL`` of the largest |logit| (MoE: with the routing of the
   kernel prefill, or of the forward, replayed on the other side, and
   the count of token choices that flip without it printed); every
   logit finite; prefill ms,
   decode ms per token, tokens/s, peak memory and the device busy share
   of one profiled decode step; for xlstm-350m one profiled prefill split
   by kernel into the GLA kernel, the sLSTM step loop's kernels and the
   rest (``split_prefill``).  Each arch's params and cache are freed
   before the next.
10. LM ``fleet-moe`` (10 MoE blocks, 8 experts top-2) and ``fleet-xlstm``
    (9 mLSTM blocks with heads of 256, 3 sLSTM blocks) of
    benchmarks/fig_lm_fleet.py:56-63, T=512, B=64, int8 wire, as phase 6
    on M=4: plan, steps through flash (MoE) or the GLA (mLSTM), the
    per-token int8 gap, the f32 ``wire="none"`` check against vanilla
    SGD.  fleet-xlstm's gap is held to the larger of ``E2E_LOSS_GAP`` and
    its precision floor, the gap between the same ``wire="none"`` steps
    in bf16 and in f32 (``GAP_FLOOR_STACKS``).
11. qwen2-moe-a2.7b at its published widths, cut to 2 of 24 layers,
    T=2,048, B=4: ``plan`` on M=1 -> ``step_fn``, 3 steps through flash at
    head width 128.
12. xlstm-350m at its published config, full depth, through
    ``init_state`` -> ``make_train_step`` (AdamW) -> ``run_train_loop``,
    B=4 x 512 tokens of the synthetic stream (T cut from 2,048: host
    time), under deterministic algorithms: 3 steps (the GLA twice per
    mLSTM block a step, remat), the loss on the first batch falling; a
    run killed after step 3 and resumed from its step-2 checkpoint ends
    bitwise equal; one profiled step.
13. distrib/ on a one-rank NCCL group (a ``FileStore``, no TCP port;
    destroyed after): qwen2.5-3b at its published widths, cut to 8 of 36
    layers, bf16, B=4 x 512, AdamW, through ``make_train_step(hier_sync=
    True)`` on a ``("pod",)`` mesh with ``tiers=None``, a mixed
    ``choose_tiers`` assignment (the largest leaves int8) and all-int8
    tiers, each from one seeded state: the first bitwise the flat step,
    the others bitwise the flat gradients with each demoted leaf through
    the plain quantizer under the same noise; the quantizer launched
    once per demoted leaf (phase 3 holds their f32 rows with tensor
    noise); step ms, peak memory.  Then the AlexNet E=2 tree of phase 8
    through ``Plan.step_fn(cloud_mesh=...)`` on a ``("data",)`` mesh,
    against the same step without it (bitwise, or else the reference
    test's tolerances), its divisibility guard, and both steps' ms.
14. launch/, after phase 13's group is destroyed: (a) the dry run
    (``python -m repro_torch.launch.dryrun``, one CPU process per
    ``DRYRUN_CELLS`` entry, all started together: the meta device and the
    fake backend, no card) on the production meshes: qwen2.5-3b
    ``train_4k`` on both meshes and with ``--hier`` on the multi-pod one,
    grok-1-314b ``decode_32k``, zamba2-7b ``long_500k`` and
    qwen2-moe-a2.7b ``train_4k``; every record ``OK`` with finite,
    positive roofline terms, one line a cell.  (b) Phase 13's flat step
    (qwen2.5-3b widths, 8 layers, bf16, B=4 x 512, AdamW) traced on meta
    by ``dryrun.measure``, then run once on the card under the same
    counter from the seeded state, then timed: the traced peak against
    ``max_memory_allocated`` (within ``DRYRUN_PEAK``), the card's counted
    FLOPs against the traced count (``DRYRUN_FLOPS``: flash's forward is
    opaque on the card), the roofline terms and bound beside the median
    step, and ``model_flops / (ms x 989e12)``; the meta trace counts no
    launch.  (c) ``crosscheck_flops`` on the card for block 1 of
    fleet-gla, fleet-moe and fleet-xlstm at T=512, each within the
    reference's band.
15. analysis/, the port's static gate against the card: (a) ``python -m
    repro_torch.analysis --check-baseline`` in a subprocess must exit 0;
    (b) every HMMA / HGMMA in every instantiation of the three libraries,
    in phase 2's ``cuobjdump -sass`` listings, must accumulate in F32, and
    every ``wgmma`` / ``mma.sync`` shape the static RA503 check finds in a
    source must appear in its library's SASS; (c) each kernel's C entry,
    called through its ``ctypes`` binding at ragged extents (the quantizer
    at odd ``m`` and ``n`` no multiple of its slice, both entries, f32 and
    bf16; flash at ``n_q = S = 1000``, head widths 64 and 128 in bf16 and
    the f32 route; the narrow GLA at ``n_t = 1000``, ``W = 128``, dk = dv =
    64; the wide GLA at dk = dv = 256, ``n_t = 300``; the f32 GLA at dv 72),
    each output a view inside a larger buffer of sentinels (NaN, or -128
    for int8 codes: values the kernels never write) with ``GUARD_BYTES``
    on either side, must write every element of every output and no guard
    byte, and agree with the plain version under phase 3's rule.  The
    RA501/RA502 twins at run time; ``compute-sanitizer`` does not run on
    the card's machine.
16. The dense train step partitioned over DTensor, on a one-rank NCCL
    group (a ``FileStore``; destroyed after): phase 13's flat step
    (qwen2.5-3b widths, 8 layers, bf16, B=4 x 512, AdamW) through
    ``distrib.partition.partitioned_step`` on a ``(data, model)`` mesh
    of (1, 1), at ``fsdp=False`` and ``True``, 3 steps each from the
    seeded state under deterministic algorithms: losses and state
    bitwise the unpartitioned step's (or else the first leaf that
    differs printed and each loss held to one bf16 rounding), flash
    launched 16 times a step on the local shards, every leaf's
    placements kept, ``CommDebugMode``'s collectives per step by type
    printed; 2 more steps of each timed beside the flat step's, and the
    peak.
17. One JSON line of kernels; last, the ``{"ok": true, ...}`` line.

Each main path (4, 5 and 6 per plan, 7, 8 per plan, 9 per generate call,
10 per plan, 11, 12, 13 per tier setting and the cloud_mesh step, 14's
counted flat step, 16 per step of each fsdp setting)
zeroes every launch counter just before its steps and reads them just
after, and fails unless each kernel of the path launched exactly as
often as the schedule's executed segments (flash per attention or MoE
block, the GLA per Mamba2 or mLSTM block, nothing per sLSTM block, for
each batch that passes it) or the model's layers imply (one flash per
attention block (whisper: per encoder layer) and one GLA per Mamba2 or
mLSTM layer per prefill, none per decode step; per flat train step
twice that, the forward re-run under remat); an AlexNet path that sends
the quantizer a row count phase 3 did not hold fails too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores
H100_BF16_FLOP_PER_S = 989e12     # dense bf16 tensor cores
E2E_LOSS_GAP = 0.02               # int8-vs-none loss budget (tests/test_wire.py)
REF_UPDATE_RTOL = 1e-2            # hybrid vs vanilla SGD, see check_reference
REF_LOSS_RTOL = 1e-5
# lr 1e-4: He-initialised AlexNet starts near loss 10 on random data and
# diverges at the repo's usual 0.05.
B, LR, SEED, BATCH_SEED = 64, 1e-4, 0, 100
STEPS, TIMED_STEPS = 3, 6
WIRE_SHAPE_N = 28 * 28 * 64       # AlexNet cut 1: conv1 + pool output

# LM paths.  sum_loss is a per-sequence sum (about T ln V = 5,300 at
# init), so SGD takes lr of order 1/T of a per-token-mean lr; these fall
# on a fixed batch in bf16 (see PERF.md).
LM_T, LM_B, LM_LR, LM_STEPS = 512, 64, 5e-4, 4
Z7_B, Z7_LR, Z7_STEPS = 8, 5e-4, 3

# Serving (phase 9): the published configs at full depth (grok-1-314b
# cut to 2 of its 64 layers: 314B parameters do not fit one card), B
# prompts of SERVE_T positions, SERVE_NEW greedy new tokens through
# ``generate``, and SERVE_TF teacher-forced decode steps held against the
# forward.  pixtral-12b's positions start with its stubbed ViT's patch
# embeddings, as many as ``configs.base.input_specs`` gives (1,024 of
# 2,048).  whisper-base takes its own shape: SERVE_FRAMES frames (30 s of
# audio after the stubbed conv frontend, its max_source_positions), a
# WHISPER_T-token decoder prompt and max_len WHISPER_MAX_LEN (its
# max_target_positions).
SERVE_ARCHS = ("zamba2-7b", "qwen2.5-3b", "qwen2-moe-a2.7b", "xlstm-350m",
               "whisper-base", "grok-1-314b", "gemma3-12b", "phi3-medium-14b",
               "granite-20b", "pixtral-12b")
SERVE_B, SERVE_T, SERVE_NEW, SERVE_TF = 4, 2048, 32, 8
SERVE_REDUCED = {"grok-1-314b": {"n_layers": 2}}
SERVE_FRAMES, WHISPER_T, WHISPER_MAX_LEN = 1500, 64, 448
# (a) kernel prefill vs plain prefill and (b) decode steps vs the kernel
# forward, as max |difference| over the largest |logit| (``rel_err``): at
# least twice (margin 2) what tests/test_torch_serve_kernels.py,
# tests/test_torch_serve_tolerances.py,
# tests/test_torch_serve_dense_tolerances.py and
# tests/test_torch_serve_gqa_tolerances.py measure on the CPU in bf16 at
# these archs' served depth, expert count, heads, KV heads, head and
# state widths (d_model, FF widths and, but for qwen2-moe-a2.7b, vocab
# cut; B=2, T=512 positions, gemma3-12b's window 256 and pixtral-12b's
# prefix 256 to keep their share of the prompt), the kernels' rounding
# emulated: zamba2-7b 0.1261 and 0.0977, qwen2.5-3b 0.0196 and 0.0194,
# xlstm-350m 0.0882 and 0.0311 (its mLSTM heads of 512 on the wide
# tensor-core kernel's split TF32 products; 0.0805 and 0.0486 on the
# CUDA-core kernel's f32 FMAs, whose (a) bound of 0.17 now misses twice),
# whisper-base 0.0061 and 0.0082,
# gemma3-12b 0.0149 and 0.0196, phi3-medium-14b 0.0169 and 0.0201,
# granite-20b 0.0179 and 0.0163, pixtral-12b 0.0225 and 0.0260.  Random
# bf16 weights through 81 Mamba2 or 24 xLSTM layers amplify a last-bit
# difference.  In an MoE a last-bit difference in a router logit flips a
# token's choice of experts, which moves its output as far as a wrong
# model would, and at 24 layers of 60 experts the flips reach most rows;
# so the MoE archs compare with one side's routing replayed on the other
# (``Routes``), and the flips are counted and printed but not held:
# measured so, grok-1-314b 0.0094 and 0.0105, qwen2-moe-a2.7b 0.1030 and
# 0.1200 (1.0645 and 1.2480 with each side's own routing, 17,922 of
# 24,576 (layer, token) choices flipped in (a); with the vocab cut to
# 8,192 it read 0.0617 and 0.1120, half the card's (a)).  The kernels
# themselves are held to the TOL rule in phase 3, and the ports of these
# models to JAX's on the CPU (tests/test_torch_serve_families.py).
SERVE_TOL = {"zamba2-7b": (0.26, 0.2), "qwen2.5-3b": (0.04, 0.04),
             "qwen2-moe-a2.7b": (0.21, 0.25), "xlstm-350m": (0.18, 0.1),
             "whisper-base": (0.02, 0.02), "grok-1-314b": (0.02, 0.022),
             "gemma3-12b": (0.03, 0.04), "phi3-medium-14b": (0.035, 0.045),
             "granite-20b": (0.04, 0.035), "pixtral-12b": (0.05, 0.055)}

# Pinned kernel tolerances of tests/test_kernel_oracle.py:40-49:
# |got - want| <= atol + ulps * ulp_dtype(|want|).
TOL = {
    ("flash_o", "float32"): (2e-6, 16.0),
    ("flash_o", "bfloat16"): (1e-3, 4.0),
    ("flash_lse", "float32"): (2e-6, 16.0),
    ("flash_lse", "bfloat16"): (2e-5, 64.0),
    ("gla_y", "float32"): (1e-4, 64.0),
    ("gla_y", "bfloat16"): (2e-2, 8.0),
    ("gla_state", "float32"): (1e-4, 64.0),
    ("gla_state", "bfloat16"): (1e-2, 64.0),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


@functools.cache
def side_stream(torch):
    """The one stream every warm-up runs on.  cuBLAS keeps a 32 MiB
    workspace for each stream it has run on, allocated from PyTorch's
    pool, so a new stream per timing left workspaces allocated into the
    main paths' peak memory."""
    return torch.cuda.Stream()


def graph_ms(torch, fn, reps: int = 10, trials: int = 25) -> float:
    """Median device ms of one ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed ``trials`` times between CUDA events."""
    stream = side_stream(torch)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):                       # warm-up outside capture
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    del g
    return statistics.median(times)


def kernel_label(symbol: str):
    """``base<args>`` of a mangled ``flash_fwd*`` or ``gla_fwd*`` template
    instance (``gla_fwd_bf16<64, 64>``, ``gla_fwd<bf16, 64>``), else
    None."""
    m = re.search(r"((?:flash|gla)_fwd\w*?)I(.*?)EE", symbol)
    if not m:
        return None
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    args = [t.group(1) or types[t.group(0)] for t in
            re.finditer(r"Li(\d+)|13__nv_bfloat16|f", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


# Kernels written for wgmma: every instantiation must hold HGMMA.
WGMMA_KERNELS = ("flash_fwd_bf16", "gla_fwd_bf16", "gla_fwd_wide_bf16")


def sass_listing(build, name: str) -> str:
    """``cuobjdump -sass`` of the built library ``name``."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    return subprocess.run(
        [str(tool), "-sass", str(build._target(name))],
        capture_output=True, text=True, timeout=300, check=True).stdout


def tensor_core_use(build, log: str, name: str = "flash_attention",
                    sass: str = None) -> dict:
    """Tensor-core instructions in each kernel instantiation of the built
    library ``name`` (its ``cuobjdump -sass`` listing ``sass``, read here
    when not given): HMMA (``mma.sync``) and HGMMA
    (``wgmma``), beside the registers and spill bytes ``ptxas -v``
    reported for it and the count of its ``ptxas`` performance notes
    (``C75xx``: a ``warpgroup.arrive`` or ``wait`` the compiler injected,
    which serialises ``wgmma``).  Fails unless every tensor-core
    instantiation (``*_bf16<...>``) has one or the other, and every one
    of :data:`WGMMA_KERNELS` has HGMMA; the CUDA-core ones (f32, and bf16
    shapes the tensor-core kernels do not take) need none."""
    if sass is None:
        sass = sass_listing(build, name)
    rows, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_label(m.group(1))
            if fn:
                rows[fn] = {"hmma": 0, "hgmma": 0}
        elif fn and re.search(r"\bHMMA\b", line):
            rows[fn]["hmma"] += 1
        elif fn and re.search(r"\bHGMMA\b", line):
            rows[fn]["hgmma"] += 1
    for line in log.splitlines():
        m = re.search(r"\(C75\d\d\).* in (?:the )?function '(\S+)'", line)
        if m:
            note = kernel_label(m.group(1))
            if note in rows:
                rows[note]["notes"] = rows[note].get("notes", 0) + 1
            continue
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            fn = kernel_label(m.group(1))
        elif fn in rows:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                rows[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    for fn, r in sorted(rows.items()):
        print(f"  {fn:24s} HMMA {r['hmma']:5d}  HGMMA {r['hgmma']:4d}  "
              f"registers {r.get('registers')}  spill bytes "
              f"{r.get('spill_bytes')}  injected warpgroup notes "
              f"{r.get('notes', 0)}")
    tc = [fn for fn in rows if fn.split("<")[0].endswith("_bf16")]
    if not tc or any(rows[fn]["hmma"] + rows[fn]["hgmma"] == 0 for fn in tc):
        fail(f"a tensor-core instantiation of {name} has no HMMA or HGMMA "
             f"instruction: {rows}")
    if any(rows[fn]["hgmma"] == 0 for fn in rows
           if fn.split("<")[0] in WGMMA_KERNELS):
        fail(f"a wgmma kernel of {name} has no HGMMA instruction: {rows}")
    return rows


def bound(nbytes: float, flops: float, flop_rate: float) -> tuple:
    """Least time on the card: bytes over the memory rate against
    operations over the peak rate for their type."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tol_check(torch, kind: str, got, want, dtype) -> tuple:
    """The oracle rule: returns (ok, max abs err, worst err/allowed)."""
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    atol, ulps = TOL[(kind, name)]
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        fail(f"{kind}: shape {tuple(g.shape)} vs {tuple(w.shape)}")
    mag = w.abs().clamp_min(torch.finfo(torch.float32).tiny)
    _, e = torch.frexp(mag)
    ulp = torch.ldexp(torch.ones_like(mag), e - 24)
    if dtype == torch.bfloat16:
        ulp = ulp * 2.0 ** 16
    err = (g - w).abs()
    allowed = atol + ulps * ulp
    ok = bool(torch.isfinite(g).all()) and bool((err <= allowed).all())
    return ok, float(err.max()), float((err / allowed).max())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def quant_bound(M: int, N: int, x_bytes: int, u_tensor: bool,
                wire: bool) -> tuple:
    """One call: each input read once, each output written once, against
    ~6 f32 operations per element (abs, max, divide, add, floor, clamp),
    7 on the wire (the multiply back).  ``quantize_int8`` writes int8
    codes and the f32 scales; the wire writes x's dtype.  The kernels'
    ``[M, S]`` scratch of partial maxima is their design's, not the
    function's, and is reported beside the bound."""
    out_bytes = x_bytes if wire else 1
    nbytes = M * N * (x_bytes + out_bytes + (4 if u_tensor else 0)) \
        + (0 if wire else 4 * M)
    return bound(nbytes, (7.0 if wire else 6.0) * M * N,
                 H100_F32_FLOP_PER_S)


def quant_cases(torch, dev, g, alexnet_rows, sync_rows=()) -> list:
    """``(name, x, u)`` of the quantizer phase: the main paths' wire
    shapes (AlexNet f32 ``alexnet_rows`` x 50,176, as
    :func:`alexnet_wire_rows` derives them; fleet-gla bf16 35/38 x
    262,144), the tiered sync's ``[M, N]`` f32 rows with tensor noise
    (``sync_rows``, as :func:`hier_sync_rows` derives them),
    a ragged f32 row, a 1x1, a zero row, a bf16 block, a NaN
    row with a row holding +-inf, a bf16 row length that is not a whole
    number of 16-byte vectors, and x at a storage offset, so its data
    pointer is off 16-byte alignment."""
    cases = []
    for m in alexnet_rows:
        cases.append((f"wire_{m}x{WIRE_SHAPE_N}", torch.randn(
            m, WIRE_SHAPE_N, generator=g, device=dev), 0.5))
    for m in (35, 38):                            # fleet-gla's wire rows
        cases.append((f"lm_bf16_{m}x{LM_T * 512}", torch.randn(
            m, LM_T * 512, generator=g, device=dev).to(torch.bfloat16), 0.5))
    for m, n in sync_rows:                        # phase 13's int8 tier
        cases.append((f"sync_{m}x{n}_u", torch.randn(
            m, n, generator=g, device=dev), torch.rand(
            m, n, generator=g, device=dev)))
    zero = torch.randn(3, 1000, generator=g, device=dev)
    zero[1] = 0.0
    nan_inf = 3.0 * torch.randn(4, 3000, generator=g, device=dev)
    nan_inf[1, 1234] = float("nan")
    nan_inf[2, 17], nan_inf[2, 2999] = float("inf"), -float("inf")
    flat = torch.randn(7 * 12345 + 1, generator=g, device=dev)
    flat16 = torch.randn(64 * 4096 + 3, generator=g, device=dev).to(
        torch.bfloat16)
    cases += [
        ("ragged_7x12345_u", torch.randn(7, 12345, generator=g, device=dev),
         torch.rand(7, 12345, generator=g, device=dev)),
        ("one_1x1_u", torch.randn(1, 1, generator=g, device=dev),
         torch.rand(1, 1, generator=g, device=dev)),
        ("zero_row_3x1000", zero, 0.5),
        ("bf16_64x4096", torch.randn(64, 4096, generator=g, device=dev)
         .to(torch.bfloat16), 0.5),
        ("nan_inf_rows_4x3000", nan_inf, 0.5),
        ("nan_inf_rows_bf16_4x3000", nan_inf.to(torch.bfloat16), 0.5),
        ("bf16_ragged_5x12343", torch.randn(5, 12343, generator=g, device=dev)
         .to(torch.bfloat16), 0.5),
        ("offset_7x12345", flat[1:].view(7, 12345), 0.5),
        ("offset_bf16_64x4096", flat16[3:].view(64, 4096), 0.5),
    ]
    return cases


def quant_divisors(torch, dev, g, n: int = 256):
    """Row scales ``max(absmax, 1e-30) / 127`` as the wire makes them:
    the extremes (1e-30 and the largest finite absmax), powers of two,
    significands of all ones, and random finite absmax bit patterns."""
    edge = torch.tensor([1e-30, 3.4028234663852886e38, 1.0, 127.0, 0.75,
                         16777215.0, 2.0 ** -60, 2.0 ** 60], device=dev)
    bits = torch.randint(0, 0x7F800000, (n - edge.numel(),), generator=g,
                         device=dev, dtype=torch.int32)
    absmax = torch.cat([edge, bits.view(torch.float32)]).clamp_min(1e-30)
    return absmax / torch.full_like(absmax, 127.0)


def same_bits(torch, got, want) -> bool:
    """Bitwise equality with NaN at the same places (any NaN payload):
    ``torch.equal`` is false on NaN."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        return False
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    dt = ints[got.dtype]
    return torch.equal(got[~nan].view(dt), want[~nan].view(dt))


def max_err(torch, got, want) -> float:
    """Largest |got - want| where neither is NaN (0 if none)."""
    g, w = got.float(), want.float()
    keep = ~(torch.isnan(g) | torch.isnan(w))
    return float((g[keep] - w[keep]).abs().max()) if keep.any() else 0.0


def check_quantizer(torch, iq, ref, alexnet_rows, sync_rows=()) -> dict:
    """Both entries of the int8 kernel against their plain versions,
    bitwise: ``quantize_int8`` on every case, the wire's fused
    ``wire_qdq_int8`` on every case with u = 0.5, timed beside the
    composition it replaces (``quantize_int8``, ``dequantize_int8``, the
    cast)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    divisors = quant_divisors(torch, dev, g)
    bad = iq.check_quotients(divisors)
    print(f"  quotient(x, s) against x / s: {divisors.numel()} divisors x "
          f"12 * 2^23 dividends, {bad} differ")
    if bad:
        fail(f"the kernels' division differs from the IEEE one on {bad} "
             f"quotients")
    rows = {}
    for name, x, u in quant_cases(torch, dev, g, alexnet_rows, sync_rows):
        M, N = x.shape
        utensor = isinstance(u, torch.Tensor)
        S = iq.plan_slices(M, N, x.element_size())[0]
        q, s = iq.quantize_int8(x, u)
        qr, sr = ref.ref_quantize_int8(x, u)
        torch.cuda.synchronize()
        runs = [("quantize_int8", same_bits(torch, q, qr)
                 and same_bits(torch, s, sr),
                 max(max_err(torch, q, qr), max_err(torch, s, sr)),
                 lambda: iq.quantize_int8(x, u),
                 lambda: ref.ref_quantize_int8(x, u), None)]
        if not utensor:
            w, wr = iq.wire_qdq_int8(x), ref.ref_wire_qdq_int8(x)
            torch.cuda.synchronize()
            runs.append(("wire_qdq_int8", same_bits(torch, w, wr),
                         max_err(torch, w, wr),
                         lambda: iq.wire_qdq_int8(x),
                         lambda: ref.ref_wire_qdq_int8(x),
                         lambda: iq.dequantize_int8(*iq.quantize_int8(
                             x, 0.5)).to(x.dtype)))
        for entry, equal, err, kernel, plain, before in runs:
            wire = entry == "wire_qdq_int8"
            bnd, by = quant_bound(M, N, x.element_size(), utensor, wire)
            row = {"case": name, "entry": entry, "shape": [M, N],
                   "dtype": str(x.dtype), "slices": S,
                   "scratch_bytes": 8 * M * S,
                   "aligned": x.data_ptr() % 16 == 0, "equal": equal,
                   "max_abs_err": err, "ms": graph_ms(torch, kernel),
                   "plain_ms": graph_ms(torch, plain),
                   "before_ms": None if before is None
                   else graph_ms(torch, before),
                   "bound_ms": bnd, "bound_by": by, "library_ms": None}
            rows[f"{entry}:{name}"] = row
            extra = "" if before is None else \
                f"  before {row['before_ms'] * 1e3:9.2f} us"
            print(f"  {entry:14s} {name:26s} S={S:<4d} equal={equal} "
                  f"kernel {row['ms'] * 1e3:9.2f} us  plain "
                  f"{row['plain_ms'] * 1e3:9.2f} us  bound {bnd * 1e3:7.2f}"
                  f" us ({by}){extra}")
            if not equal:
                fail(f"{entry} disagrees with its plain version on {name} "
                     f"(max abs err {err})")
    return rows


def attention_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: the work this run's data
    needs."""
    n = 0
    for t in range(T):
        hi = min(S - 1, t) if causal else S - 1
        lo = max(0, t - window + 1) if window > 0 else 0
        n += max(0, hi - lo + 1)
    return n


# (name, BH, BKV, T, S, hd, dtype, causal, window).  bf16 runs on the
# tensor-core kernel, f32 on the CUDA-core one; the bf16 edge cases are
# a ragged last 128-row query tile at every head width, the non-causal
# window and T != S (no tile skipped).
FLASH_CASES = (
    ("fleet_gla_64x8_512_64", 64 * 8, 64 * 8, 512, 512, 64, "bf16", True, 0),
    ("zamba2_7b_8x32_512_112", 8 * 32, 8 * 32, 512, 512, 112, "bf16", True,
     0),
    ("gqa_rep2_64x8_512_64", 64 * 8, 64 * 4, 512, 512, 64, "bf16", True, 0),
    ("window128_16x8_512_128", 16 * 8, 16 * 8, 512, 512, 128, "bf16", True,
     128),
    ("f32_ragged_32_300_64", 32, 16, 300, 300, 64, "f32", True, 0),
    ("f32_noncausal_w64_16_200_112", 16, 16, 200, 200, 112, "f32", False,
     64),
    ("bf16_ragged_32_300_64", 32, 16, 300, 300, 64, "bf16", True, 0),
    ("bf16_noncausal_w64_16_200_112", 16, 16, 200, 200, 112, "bf16", False,
     64),
    ("bf16_cross_16_128x384_128", 16, 8, 128, 384, 128, "bf16", False, 0),
    ("bf16_ragged_16_1000_128_gqa4", 16, 4, 1000, 1000, 128, "bf16", True,
     0),
    ("bf16_ragged_w64_8x4_300_256", 8, 4, 300, 300, 256, "bf16", True, 64),
    # phase 9's prefills: zamba2-7b (B=4 x 32 heads of 112) and
    # qwen2.5-3b (B=4 x 16 query heads over 2 KV heads of 128, GQA rep 8)
    ("zamba2_7b_prefill_4x32_2048_112", 4 * 32, 4 * 32, 2048, 2048, 112,
     "bf16", True, 0),
    ("qwen2_5_3b_prefill_4x16_2048_128_gqa8", 4 * 16, 4 * 2, 2048, 2048,
     128, "bf16", True, 0),
    # qwen2-moe-a2.7b (B=4 x 16 heads of 128, MHA), grok-1-314b (B=4 x
    # 48 query heads over 8 KV heads of 128, GQA rep 6) and whisper-base's
    # encoder (B=4 x 8 heads of 64 over 1,500 frames, non-causal, ragged)
    ("qwen2_moe_prefill_4x16_2048_128", 4 * 16, 4 * 16, 2048, 2048, 128,
     "bf16", True, 0),
    ("grok1_prefill_4x48_2048_128_gqa6", 4 * 48, 4 * 8, 2048, 2048, 128,
     "bf16", True, 0),
    ("whisper_base_encoder_4x8_1500_64", 4 * 8, 4 * 8, 1500, 1500, 64,
     "bf16", False, 0),
    # gemma3-12b (B=4 x 16 query heads over 8 KV heads of 256, GQA rep 2):
    # every 6th layer global, the other five windowed at 1,024;
    # phi3-medium-14b (B=4 x 40 over 10 of 128, rep 4), granite-20b (B=4 x
    # 48 over one KV head of 128: MQA, rep 48) and pixtral-12b (B=4 x 32
    # over 8 of 128, rep 4; 1,024 patch embeddings then 1,024 tokens)
    ("gemma3_12b_global_4x16_2048_256_gqa2", 4 * 16, 4 * 8, 2048, 2048,
     256, "bf16", True, 0),
    ("gemma3_12b_local_4x16_2048_256_w1024", 4 * 16, 4 * 8, 2048, 2048,
     256, "bf16", True, 1024),
    ("phi3_medium_prefill_4x40_2048_128_gqa4", 4 * 40, 4 * 10, 2048, 2048,
     128, "bf16", True, 0),
    ("granite_20b_prefill_4x48_2048_128_mqa", 4 * 48, 4 * 1, 2048, 2048,
     128, "bf16", True, 0),
    ("pixtral_12b_prefill_4x32_2048_128_gqa4", 4 * 32, 4 * 8, 2048, 2048,
     128, "bf16", True, 0),
    ("f32_ragged_w64_8x4_300_256", 8, 4, 300, 300, 256, "f32", True, 64),
)


def window_mask(torch, T: int, S: int, causal: bool, window: int, dev):
    """The boolean ``[T, S]`` mask (True = attend) of a windowed row:
    ``kpos > qpos - window``, and ``kpos <= qpos`` if causal."""
    qpos = torch.arange(T, device=dev)[:, None]
    kpos = torch.arange(S, device=dev)[None, :]
    keep = kpos > qpos - window
    return keep & (kpos <= qpos) if causal else keep


def check_flash(torch, fa, ref) -> dict:
    """Flash attention against its plain version at the TOL rule."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = {}
    for name, BH, BKV, T, S, hd, dt, causal, window in FLASH_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q = torch.randn(BH, T, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(BKV, S, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(BKV, S, hd, generator=g, device=dev).to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
        o_r, lse_r = ref.ref_flash_attention(q, k, v, causal=causal,
                                             window=window)
        torch.cuda.synchronize()
        ok_o, err_o, ex_o = tol_check(torch, "flash_o", o, o_r, dtype)
        ok_l, err_l, ex_l = tol_check(torch, "flash_lse", lse, lse_r, dtype)
        rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
            else H100_F32_FLOP_PER_S
        nbytes = (2 * BH * T * hd + 2 * BKV * S * hd) * q.element_size() \
            + 4 * BH * T
        flops = 4.0 * hd * BH * attention_pairs(T, S, causal, window)
        bnd, by = bound(nbytes, flops, rate)
        heavy = BH * T * S > 2 ** 26
        # SDPA computes the same function: its causal mask is top-left, as
        # ours; a window goes in as an explicit boolean [T, S] mask.
        qs, ks, vs = q[None], k[None], v[None]
        mask = None if window == 0 else window_mask(torch, T, S, causal,
                                                    window, dev)
        library = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=BH != BKV))
        row = {"case": name, "shape": {"q": [BH, T, hd], "kv": [BKV, S, hd]},
               "dtype": str(dtype), "causal": causal, "window": window,
               "ok": ok_o and ok_l, "max_abs_err": max(err_o, err_l),
               "o_err": err_o, "lse_err": err_l,
               "o_err_over_tol": ex_o, "lse_err_over_tol": ex_l,
               "ms": graph_ms(torch, lambda: fa.flash_attention_fwd(
                   q, k, v, causal, window)),
               "plain_ms": graph_ms(torch, lambda: ref.ref_flash_attention(
                   q, k, v, causal=causal, window=window),
                   reps=3 if heavy else 10, trials=10 if heavy else 25),
               "bound_ms": bnd, "bound_by": by, "library_ms": library,
               "flops": flops, "bytes": nbytes}
        rows[name] = row
        print(f"  {name:30s} ok={row['ok']} o err {err_o:.3e} "
              f"({ex_o:.3f} of tol) lse err {err_l:.3e} ({ex_l:.3f}); "
              f"kernel {row['ms']:.5f} ms plain {row['plain_ms']:.5f} ms "
              f"bound {bnd:.5f} ms ({by}) library {library:.5f} ms; "
              f"kernel / library {row['ms'] / library:.2f}, bound / kernel "
              f"{bnd / row['ms']:.3f}")
        if not row["ok"]:
            fail(f"flash_attention disagrees with its plain version on "
                 f"{name}")
    return rows


# (name, BH, T, dk, dv, chunk, dtype, normalize, draw).  bf16 with dk and
# dv multiples of 16 runs on a tensor-core kernel (``gla_kernel``: up to
# 128 on gla_fwd_bf16, wider on gla_fwd_wide_bf16), any other shape (dk up
# to 512) on the CUDA-core one.  The bf16 tensor-core edges: a ragged last
# chunk, normalizing at W=256, dk != dv with the chunk one 64-row
# sub-tile, dk 64 x dv 128 with a chunk of 96 rows; the wide kernel at xlstm-350m's prefill (dk 512, eight
# 64-column pieces of q and k), at fleet-xlstm's training shape and ragged
# at dk = dv = 256; on the CUDA cores, one bf16 shape (dv=40) and f32 at
# dk = dv = 256, ragged.  ``draw`` is "mamba2" (log-decays
# -softplus(N - 2), k 0.3 N) or "mlstm" (as the mLSTM forms them:
# log-decays logsigmoid(N(3, 1)), k N / sqrt(dk) times exp(clip(2 N, -8,
# 8)) per step, so the normalizer matters).
GLA_CASES = (
    ("fleet_gla_64x16_512_64_W128", 64 * 16, 512, 64, 64, 128, "bf16",
     False, "mamba2"),
    ("zamba2_7b_8x112_512_64_W256", 8 * 112, 512, 64, 64, 256, "bf16",
     False, "mamba2"),
    ("normalize_16_512_128_W128", 16, 512, 128, 128, 128, "bf16", True,
     "mamba2"),
    ("f32_ragged_32_300_64_W128", 32, 300, 64, 64, 128, "f32", False,
     "mamba2"),
    ("f32_normalize_8_96_16x40_W32", 8, 96, 16, 40, 32, "f32", True,
     "mamba2"),
    ("bf16_ragged_32_300_64_W128", 32, 300, 64, 64, 128, "bf16", False,
     "mamba2"),
    ("bf16_normalize_64_512_64_W256", 64, 512, 64, 64, 256, "bf16", True,
     "mamba2"),
    ("bf16_dk128_dv64_32_256_W64", 32, 256, 128, 64, 64, "bf16", False,
     "mamba2"),
    # gla_fwd_bf16<64, 128>, with a chunk that is not a multiple of 64
    # rows: a tile's rows past W belong to the next chunk and are masked
    ("bf16_dk64_dv128_ragged_16_300_W96", 16, 300, 64, 128, 96, "bf16",
     False, "mamba2"),
    ("bf16_cuda_cores_8_96_16x40_W32", 8, 96, 16, 40, 32, "bf16", True,
     "mamba2"),
    # phase 9's zamba2-7b prefill: B=4 x 112 SSM heads, d_state 64
    ("zamba2_7b_prefill_4x112_2048_64_W256", 4 * 112, 2048, 64, 64, 256,
     "bf16", False, "mamba2"),
    # phase 9's xlstm-350m prefill: B=4 x 4 mLSTM heads of 512, W=256
    ("xlstm_350m_prefill_4x4_2048_512_W256", 4 * 4, 2048, 512, 512, 256,
     "bf16", True, "mlstm"),
    ("bf16_dk256_ragged_8_300_256_W128", 8, 300, 256, 256, 128, "bf16",
     True, "mlstm"),
    # fleet-xlstm (benchmarks/fig_lm_fleet.py:60-63) at phase 4's batch:
    # B=64 x 4 mLSTM heads of 256, T=512, chunk 128
    ("fleet_xlstm_64x4_512_256_W128", 64 * 4, 512, 256, 256, 128, "bf16",
     True, "mlstm"),
    # phase 12's xlstm-350m train step: B=4 x 4 mLSTM heads of 512, T=512
    ("xlstm_350m_train_4x4_512_512_W256", 4 * 4, 512, 512, 512, 256,
     "bf16", True, "mlstm"),
    ("f32_dk256_ragged_8_300_256_W128", 8, 300, 256, 256, 128, "f32",
     False, "mamba2"),
)


def gla_kernel(bf16: bool, dk: int, dv: int) -> str:
    """The kernel ``dispatch`` in csrc/gla_scan.cu picks for a GLA call of
    these widths (16-byte aligned inputs, as PyTorch allocates them):
    bf16 with widths that are multiples of 16 on the tensor cores, up to
    128 in ``gla_fwd_bf16`` and wider in ``gla_fwd_wide_bf16``; the rest
    in ``gla_fwd`` on the CUDA cores."""
    if bf16 and dk % 16 == 0 and dv % 16 == 0:
        return "gla_fwd_bf16" if max(dk, dv) <= 128 else "gla_fwd_wide_bf16"
    return "gla_fwd"


def gla_tensor_cores(dk: int, dv: int) -> bool:
    """Whether a bf16 GLA call of these widths takes a tensor-core
    kernel (``gla_kernel``)."""
    return gla_kernel(True, dk, dv) != "gla_fwd"


def gla_flops(BH: int, T: int, dk: int, dv: int, W: int) -> float:
    """``_gla_flops`` of the JAX layer stack (layerstack.py:172-176)."""
    return float(T * BH * (2 * W * (dk + dv) + 4 * dk * dv))


def gla_inputs(torch, g, BH, T, dk, dv, dtype, draw: str):
    """q, k, v in ``dtype`` and f32 log-decays, drawn as ``draw`` says
    (GLA_CASES)."""
    import torch.nn.functional as F
    dev = g.device
    q = torch.randn(BH, T, dk, generator=g, device=dev)
    k = torch.randn(BH, T, dk, generator=g, device=dev)
    v = torch.randn(BH, T, dv, generator=g, device=dev)
    a = torch.randn(BH, T, generator=g, device=dev)
    if draw == "mlstm":
        ig = (2.0 * torch.randn(BH, T, 1, generator=g, device=dev)).clamp(
            -8.0, 8.0)
        k = k / math.sqrt(dk) * torch.exp(ig)
        a = F.logsigmoid(a + 3.0)
    else:
        k = 0.3 * k
        a = -F.softplus(a - 2.0)
    return q.to(dtype), k.to(dtype), v.to(dtype), a


def check_gla(torch, gs, ref) -> dict:
    """The GLA scan against its plain version (the step recurrence) at
    the TOL rule, on Mamba2-like or mLSTM-like inputs (``gla_inputs``)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = {}
    for name, BH, T, dk, dv, W, dt, normalize, draw in GLA_CASES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v, a = gla_inputs(torch, g, BH, T, dk, dv, dtype, draw)
        y, S, n = gs.gla_scan_fwd(q, k, v, a, W, normalize)
        y_r, S_r, n_r = ref.ref_gla(q, k, v, a, normalize=normalize)
        torch.cuda.synchronize()
        ok_y, err_y, ex_y = tol_check(torch, "gla_y", y, y_r, dtype)
        ok_s, err_s, ex_s = tol_check(torch, "gla_state", S, S_r, dtype)
        ok_n, err_n, ex_n = tol_check(torch, "gla_state", n, n_r, dtype)
        rate = H100_BF16_FLOP_PER_S if dtype == torch.bfloat16 \
            else H100_F32_FLOP_PER_S
        nbytes = BH * T * (2 * dk + 2 * dv) * q.element_size() \
            + 4 * BH * T + 4 * BH * (dk * dv + dk)
        bnd, by = bound(nbytes, gla_flops(BH, T, dk, dv, min(W, T)), rate)
        kernel = gla_kernel(dtype == torch.bfloat16, dk, dv)
        cores = f"{'CUDA' if kernel == 'gla_fwd' else 'tensor'}: {kernel}"
        row = {"case": name, "shape": {"qk": [BH, T, dk], "v": [BH, T, dv]},
               "chunk": W, "dtype": str(dtype), "normalize": normalize,
               "draw": draw, "cores": cores,
               "ok": ok_y and ok_s and ok_n,
               "max_abs_err": max(err_y, err_s, err_n), "y_err": err_y,
               "S_err": err_s, "n_err": err_n, "y_err_over_tol": ex_y,
               "S_err_over_tol": ex_s, "n_err_over_tol": ex_n,
               "ms": graph_ms(torch, lambda: gs.gla_scan_fwd(
                   q, k, v, a, W, normalize)),
               "plain_ms": graph_ms(torch, lambda: ref.ref_gla(
                   q, k, v, a, normalize=normalize), reps=1, trials=5),
               "bound_ms": bnd, "bound_by": by, "library_ms": None,
               "bytes": nbytes}
        rows[name] = row
        print(f"  {name:37s} ({cores}) ok={row['ok']} y err "
              f"{err_y:.3e} ({ex_y:.3f} "
              f"of tol) S err {err_s:.3e} ({ex_s:.3f}) n err {err_n:.3e} "
              f"({ex_n:.3f}); kernel {row['ms']:.5f} ms plain "
              f"{row['plain_ms']:.5f} ms bound {bnd:.5f} ms ({by})")
        if not row["ok"]:
            fail(f"gla_scan disagrees with its plain version on {name}")
    return rows


# ---------------------------------------------------------------------------
# Phase 4: AlexNet.
# ---------------------------------------------------------------------------


def crossings(sched) -> int:
    """TASK-S/L streams whose cut ships an activation (m > 0, b > 0)."""
    n = sum(1 for m, b in zip(sched.m_s, sched.b_s) if m > 0 and b > 0)
    return n + (1 if sched.m_l > 0 and sched.b_l > 0 else 0)


def wire_rows(sched) -> set:
    """Row counts the quantizer sees on a schedule's crossings (forward
    and cotangent alike): the batch of each stream counted by
    :func:`crossings`."""
    rows = {b for m, b in zip(sched.m_s, sched.b_s) if m > 0 and b > 0}
    return rows | ({sched.b_l} if sched.m_l > 0 and sched.b_l > 0
                   else set())


def batch(torch):
    """One fixed seeded batch: every step trains on it, so the loss must
    fall."""
    g = torch.Generator(device="cuda").manual_seed(BATCH_SEED)
    x = torch.randn((B, 224, 224, 3), generator=g, device="cuda")
    y = torch.randint(0, 200, (B,), generator=g, device="cuda")
    return x, y


def zero_counters(kernels) -> None:
    for mod in kernels.values():
        mod.launches = 0


def read_counters(kernels) -> dict:
    return {name: mod.launches for name, mod in kernels.items()}


def run_plan(torch, api, kernels, cnn, fleet, label: str,
             n_steps: int = STEPS + TIMED_STEPS) -> dict:
    """AlexNet for one fleet: plan, then int8 steps through Plan.step_fn
    (``STEPS`` checked, the rest for the step time), with the launch
    counters zeroed just before, read after every step and just after,
    and one profiled step."""
    t0 = time.perf_counter()
    p = api.plan(cnn.alexnet(), fleet, B)
    plan_ms = (time.perf_counter() - t0) * 1e3
    sched = p.multi_schedule
    print(f"  {label} plan: {p.schedule}  T_total={p.t_total!r} s (model); "
          f"planned in {plan_ms:.1f} ms")
    n_cross = crossings(sched)
    if n_cross == 0:
        fail(f"{label}: the plan crosses no int8 wire (m > 0, b > 0)")
    params = p.init_params(seed=SEED)
    step = p.step_fn(lr=LR)
    x, y = batch(torch)
    losses, ms, per_step = [], [], []
    zero_counters(kernels)
    for _ in range(n_steps):
        before = read_counters(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append({k: v - before[k]
                         for k, v in read_counters(kernels).items()})
    launches = read_counters(kernels)
    one = {"int8_quant": 2 * n_cross, "flash_attention": 0, "gla_scan": 0}
    want = {k: v * n_steps for k, v in one.items()}
    print(f"  {label} losses {losses}")
    print(f"  {label} step ms {ms}")
    print(f"  {label} launches {launches} (expected {want})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss {losses}")
    if not losses[STEPS - 1] < losses[0]:
        fail(f"{label}: the loss did not fall on a fixed batch: {losses}")
    if launches != want or any(s != one for s in per_step):
        fail(f"{label}: launches {launches} ({per_step} per step), "
             f"expected {want}")
    prof = profile_call(torch, lambda: step(params, x, y), label)
    return {"plan": p, "plan_ms": plan_ms, "losses": losses, "step_ms": ms,
            "launches": launches, "crossings": n_cross,
            "wire_rows": sorted(wire_rows(sched)),
            "launches_per_step": one, "profile": prof}


def step_fn(hs, p):
    """The engine ``Plan.step_fn`` runs for ``p``'s topology, as a
    function of the schedule (a tree derives its stream->edge map from
    each schedule, as ``Plan.train`` does)."""
    if p.fleet.topology == "tree":
        return hs.tree_schedule_step(p.profile, p.network)
    return hs.hybrid_step_from_schedule if p.fleet.topology == "triple" \
        else hs.multi_hybrid_step_from_schedule


def leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of a nested dict in sorted key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def compare_updates(torch, hs, stack, params, x, y, sched_run, lr,
                    f64: bool = False) -> dict:
    """A ``wire="none"`` hybrid step against vanilla SGD from the same
    params: each leaf's update ``p_new - p`` must agree to
    ``REF_UPDATE_RTOL`` of its largest entry and the loss to
    ``REF_LOSS_RTOL``.  Both differ only in summation order (a batch
    split against the whole batch, and the libraries' choice of
    algorithm for each batch size); a routing or aggregation fault (a
    worker's gradient dropped or counted twice) moves an update by about
    ``b_worker / B``, tens of percent here.  With ``f64`` both updates
    are also measured against a float64 vanilla step, for the record."""
    hyb, hl = sched_run(params)
    ref, rl = hs.reference_sgd_step(stack, params, x, y, lr)
    exact = params
    if f64:
        p64 = [{k: v.double() for k, v in q.items()} for q in params]
        exact, _ = hs.reference_sgd_step(stack, p64, x.double(), y, lr)
    names = [m.name for m in stack.cut_meta()]
    out = []
    for i, (p0, ph, pr, pe) in enumerate(zip(params, hyb, ref, exact)):
        for (path, a), (_, b), (_, c), (_, e) in zip(
                leaves(p0), leaves(ph), leaves(pr), leaves(pe)):
            u_h, u_r = b.double() - a.double(), c.double() - a.double()
            top = max(float(u_r.abs().max()), 1e-300)
            row = {"leaf": f"{names[i]}.{path}",
                   "hybrid_vs_ref": float((u_h - u_r).abs().max()) / top}
            if f64:
                u_e = e - a.double()
                top_e = max(float(u_e.abs().max()), 1e-300)
                row["hybrid_vs_f64"] = float((u_h - u_e).abs().max()) / top_e
                row["ref_vs_f64"] = float((u_r - u_e).abs().max()) / top_e
            out.append(row)
    worst = max(out, key=lambda d: d["hybrid_vs_ref"])
    lgap = abs(float(hl) - float(rl)) / abs(float(rl))
    return {"loss_rel_gap": lgap, "worst": worst, "leaves": out,
            "ok": worst["hybrid_vs_ref"] <= REF_UPDATE_RTOL
            and lgap <= REF_LOSS_RTOL}


def check_reference(torch, hs, run) -> dict:
    """AlexNet: ``wire="none"`` on the plan's cuts against vanilla SGD on
    the card (f32)."""
    p = run["plan"]
    params = p.init_params(seed=SEED)
    x, y = batch(torch)
    res = compare_updates(
        torch, hs, p.model, params, x, y,
        lambda q: step_fn(hs, p)(p.model, q, x, y, p.schedule, LR,
                                 wire="none"), LR, f64=True)
    print(f"  {p.fleet.topology} reference check: loss rel gap "
          f"{res['loss_rel_gap']!r}; worst leaf {res['worst']}")
    if not res["ok"]:
        fail("wire='none' hybrid step disagrees with vanilla SGD")
    return {"loss_rel_gap": res["loss_rel_gap"], "worst": res["worst"]}


def check_int8_gap(torch, hs, run) -> float:
    """The checked steps again with ``wire="none"`` on the same cuts: the
    int8 losses stay within ``E2E_LOSS_GAP``."""
    p = run["plan"]
    params = p.init_params(seed=SEED)
    step = step_fn(hs, p)
    x, y = batch(torch)
    gaps = []
    for k in range(STEPS):
        params, loss = step(p.model, params, x, y, p.schedule, LR,
                            wire="none")
        gaps.append(abs(float(loss) - run["losses"][k]))
    print(f"  int8-vs-none loss gaps {gaps}")
    if max(gaps) > E2E_LOSS_GAP:
        fail(f"int8 loss gap {max(gaps)} exceeds {E2E_LOSS_GAP}")
    return max(gaps)


# ---------------------------------------------------------------------------
# Phase 5: AlexNet through Plan.train.
# ---------------------------------------------------------------------------

# The loop trains on SyntheticImages (a new batch every step) at the
# step_fn phase's lr.  The straggler slows one worker by ``factor`` for
# steps [2, 6); with re-solves every 2 steps (EMA 0.8) the schedule
# changes at step 2 and is back by the last step (pinned on the CPU by
# tests/test_torch_train_loop.py::test_chip_smoke_slowdowns_move_and_restore
# and, for the E=2 tree, tests/test_torch_facade.py).  Keys: M of the
# Table-II fleet, or the label of a tree path.
TRAIN_STEPS, TRAIN_PROFILED_STEPS = 10, 4
TRAIN_KW = dict(lr=LR, resched_every=2, ema=0.8, seed=SEED)
TRAIN_SLOW = {1: ("edge", 8.0), 4: ("device_0", 4.0),
              "tree E=2": ("device_1", 2.0)}
TRAIN_WINDOW = (2, 6)
CKPT_EVERY, FAIL_AT = 3, 7
TREE_STEPS = 10                   # step_fn steps per tree plan
TREE_EDGES = (1, 2, 4)


def train_slowdown(key):
    worker, factor = TRAIN_SLOW[key]
    lo, hi = TRAIN_WINDOW
    return lambda step: {worker: factor} if lo <= step < hi else {}


def tree_fleet(api, e: int):
    """benchmarks/fig_tree.py:29-31's fleet: AlexNet's Table-II testbed,
    M=4, a 2 Mbps backhaul per edge, ``e`` edge servers; the int8 wire."""
    return api.Fleet.from_table2("alexnet", m=4, edge_cloud_mbps=2.0,
                                 topology="tree", n_edges=e, wire="int8")


def as_multi(api, sched):
    return sched if isinstance(sched, api.MultiSchedule) \
        else api.MultiSchedule.from_schedule(sched)


def train_config(loop, p):
    """The ``HierLoopConfig`` that ``Plan.train(**TRAIN_KW)`` builds."""
    return loop.HierLoopConfig(
        total_steps=TRAIN_STEPS, batch=p.B, pipeline_depth=p.pipeline_depth,
        objective=p.objective, wire=p.wire, **TRAIN_KW)


def same_params(torch, a, b) -> bool:
    return all(torch.equal(u, v) for q, r in zip(a, b)
               for (_, u), (_, v) in zip(leaves(q), leaves(r)))


def train_part_costs(torch, hs, loop, store, p, data, out, tmp) -> dict:
    """Host and device ms of each part of one loop step, by the calls
    the loop makes, at this run's schedules: the data batch (host), the
    pageable host-to-device copy of x, the step (ending in
    ``synchronize``), a warm re-solve, a checkpoint save and a restore.
    """
    cfg = train_config(loop, p)
    run = step_fn(hs, p)
    params = p.init_params(seed=SEED)
    parts = {"batch": [], "h2d": [], "step": []}
    for k, h in enumerate(out["history"]):
        t0 = time.perf_counter()
        b = data.batch(k)
        parts["batch"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = torch.as_tensor(b["x"], device="cuda")
        y = torch.as_tensor(b["labels"], device="cuda")
        torch.cuda.synchronize()
        parts["h2d"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        params, loss = run(p.model, params, x, y, h["sched"], LR,
                           wire=p.wire)
        torch.cuda.synchronize()
        parts["step"].append((time.perf_counter() - t0) * 1e3)
    planner = loop._Planner(cfg, None, p.profile, p.network,
                            topology=p.fleet.topology,
                            initial_schedule=p.schedule)
    solve = planner.ops["solve"]
    parts["resolve"] = []
    for _ in range(3):
        t0 = time.perf_counter()
        solve(planner.prof, planner.sched)
        parts["resolve"].append((time.perf_counter() - t0) * 1e3)
    tree, extra = planner.state()
    tree["params"] = params
    extra.update(step=TRAIN_STEPS, seed=SEED)
    manager = store.CheckpointManager(str(tmp), keep=1)
    parts["save"], parts["restore"] = [], []
    for k in range(3):
        t0 = time.perf_counter()
        path = manager.save(k + 1, tree, extra=extra)
        parts["save"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, back, _ = manager.restore_latest_with(
            lambda step, e: {"params": params, **planner.like(e)})
        torch.cuda.synchronize()
        parts["restore"].append((time.perf_counter() - t0) * 1e3)
        if got != k + 1 or not same_params(torch, back["params"], params):
            fail("a checkpoint did not restore the params it saved")
    nbytes = Path(path, "arrays.npz").stat().st_size
    return {"ms": parts, "x_bytes": int(x.numel() * x.element_size()),
            "ckpt_bytes": nbytes,
            "median_ms": {k: statistics.median(v) for k, v in parts.items()}}


def run_train(torch, api, loop, store, hs, kernels, cnn, data_mod, fleet,
              key, tmp: Path) -> dict:
    """AlexNet ``Plan.train`` on one fleet with a straggler: the main
    path (counters zeroed just before, read just after), a second
    uninterrupted run, a run killed after ``FAIL_AT`` and resumed from
    its checkpoint, the numpy replay of the planning, the part costs and
    one profiled short run.  ``key`` picks the straggler (TRAIN_SLOW)."""
    model = cnn.alexnet()
    p = api.plan(model, fleet, B)
    data = data_mod.SyntheticImages(model.input_shape, model.num_classes, B,
                                    seed=SEED)
    slow = train_slowdown(key)
    kw = dict(steps=TRAIN_STEPS, worker_slowdown=slow, **TRAIN_KW)
    label = f"{f'M={key}' if isinstance(key, int) else key} Plan.train"
    print(f"  {label}: plan {p.schedule}; straggler {TRAIN_SLOW[key]} over "
          f"steps {TRAIN_WINDOW}")

    t0 = time.perf_counter()
    replay = loop.replay(train_config(loop, p), p.profile, p.network, slow,
                         topology=p.fleet.topology,
                         initial_schedule=p.schedule)
    replay_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    zero_counters(kernels)
    t0 = time.perf_counter()
    out = p.train(data, **kw)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters(kernels)
    hist = out["history"]
    per_step = [2 * crossings(as_multi(api, h["sched"])) for h in hist]
    want = {"int8_quant": sum(per_step), "flash_attention": 0,
            "gla_scan": 0}
    losses = [h["loss"] for h in hist]
    scheds = [h["sched"] for h in hist]
    changes = [h["step"] for a, h in zip(scheds, hist[1:])
               if h["sched"] != a]
    print(f"  {label} losses {losses}")
    print(f"  {label} walls {[float(h['wall']) for h in hist]}")
    print(f"  {label} schedules: changed before steps {changes}; final "
          f"{out['final_schedule']}")
    print(f"  {label} launches {launches} (expected {want}, per step "
          f"{per_step}); loop {loop_ms:.1f} ms for {TRAIN_STEPS} steps "
          f"({loop_ms / TRAIN_STEPS:.1f} ms a step, init included); "
          f"numpy replay {replay_ms:.1f} ms")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    if [repr(s) for s in scheds] != [repr(r["sched"]) for r in replay] or \
            [h["wall"] for h in hist] != [r["wall"] for r in replay]:
        fail(f"{label}: schedules or walls differ from the numpy replay")
    if not changes or out["final_schedule"] != p.schedule:
        fail(f"{label}: the straggler did not move the schedule and let "
             f"it come back (changes before steps {changes})")

    again = p.train(data, **kw)
    deterministic = same_params(torch, out["params"], again["params"]) \
        and [h["loss"] for h in again["history"]] == losses
    print(f"  {label} second uninterrupted run bitwise equal: "
          f"{deterministic}")
    if not deterministic:
        fail(f"{label}: two uninterrupted runs differ")
    del again

    ckpt = tmp / f"m{key}".replace(" ", "_")
    try:
        p.train(data, ckpt_dir=str(ckpt), ckpt_every=CKPT_EVERY,
                fail_at=FAIL_AT, **kw)
    except loop.InjectedFailure:
        pass
    else:
        fail(f"{label}: fail_at={FAIL_AT} did not raise")
    resumed = p.train(data, ckpt_dir=str(ckpt), ckpt_every=CKPT_EVERY, **kw)
    at = (FAIL_AT // CKPT_EVERY) * CKPT_EVERY
    tail = [h for h in hist if h["step"] > at]
    rh = resumed["history"]
    resume_ok = resumed["resumed_from"] == at and \
        same_params(torch, out["params"], resumed["params"]) and \
        len(rh) == len(tail) and \
        all(a["loss"] == b["loss"] and a["wall"] == b["wall"] and
            a["sched"] == b["sched"] for a, b in zip(tail, rh)) and \
        resumed["wall"] == out["wall"]
    print(f"  {label} killed after step {FAIL_AT}, resumed from "
          f"{resumed['resumed_from']}: bitwise equal to the uninterrupted "
          f"run: {resume_ok}")
    if not resume_ok:
        fail(f"{label}: the resumed run differs from the uninterrupted one")
    del resumed

    costs = train_part_costs(torch, hs, loop, store, p, data, out,
                             tmp / f"costs{key}".replace(" ", "_"))
    print(f"  {label} part ms (median): {costs['median_ms']}; x "
          f"{costs['x_bytes']} bytes pageable; checkpoint "
          f"{costs['ckpt_bytes']} bytes")
    print(f"  {label} part ms per step: {costs['ms']}")
    prof = profile_call(torch, lambda: p.train(
        data, steps=TRAIN_PROFILED_STEPS, worker_slowdown=slow, **TRAIN_KW),
        f"{label} ({TRAIN_PROFILED_STEPS} steps)")
    idle = None if prof["device_busy_ms"] == 0 else \
        1.0 - prof["device_busy_ms"] / prof["wall_ms"]
    print(f"  {label} device idle share over {TRAIN_PROFILED_STEPS} loop "
          f"steps: {'not measured' if idle is None else idle}")
    return {"plan": str(p.schedule), "losses": losses,
            "walls": [float(h["wall"]) for h in hist],
            "schedules": [str(s) for s in scheds], "changes": changes,
            "wire_rows": sorted(set().union(
                *(wire_rows(as_multi(api, s)) for s in scheds))),
            "launches": launches,
            "launches_per_step": {"int8_quant": per_step,
                                  "flash_attention": 0, "gla_scan": 0},
            "loop_ms": loop_ms, "replay_ms": replay_ms, "costs": costs,
            "profile": prof, "idle_share": idle}


def check_measure_profile(torch, profiler, cnn, p_analytic) -> dict:
    """``measure_profile(alexnet())`` on the card at B=64: each cut's
    forward and backward per sample, beside the analytic Table-II
    profile the plans use and the rate the forward reached."""
    stack = cnn.alexnet()
    prof = profiler.measure_profile(stack, batch=B, repeats=5,
                                    device="cuda")
    metas = p_analytic.model.cut_meta()
    rows = []
    for i, name in enumerate(prof.layer_names):
        f_us, b_us = prof.L_f[1, i] * 1e6, prof.L_b[1, i] * 1e6
        ana = [p_analytic.profile.L_f[j, i] * 1e6 for j in range(3)]
        rate = metas[i].flops_fwd / prof.L_f[1, i] / 1e12
        rows.append({"cut": name, "fwd_us_per_sample": f_us,
                     "bwd_us_per_sample": b_us,
                     "analytic_fwd_us_device_edge_cloud": ana,
                     "fwd_tflops": rate})
        print(f"  {name:6s} measured fwd {f_us:9.3f} us bwd {b_us:9.3f} us "
              f"per sample ({rate:.2f} TFLOP/s fwd); analytic fwd "
              f"device/edge/cloud {ana[0]:.1f} / {ana[1]:.1f} / "
              f"{ana[2]:.2f} us")
        if not (math.isfinite(f_us) and math.isfinite(b_us) and f_us > 0
                and b_us > 0):
            fail(f"measure_profile: cut {name} timed {f_us}, {b_us}")
    return {"rows": rows, "L_u": prof.L_u.tolist()}


# ---------------------------------------------------------------------------
# Phase 8: AlexNet on fig_tree's fleets.
# ---------------------------------------------------------------------------


def alexnet_wire_rows(api, loop, cnn) -> tuple:
    """The row counts the AlexNet paths (phases 4, 5 and 8) send through
    the quantizer, derived from the plans they drive and, on the
    ``Plan.train`` paths, from every schedule of the loop's numpy replay
    (the straggler moves the schedule).  Phase 3 holds each of them
    bitwise; the end of ``main`` fails on any other."""
    paths = [(api.Fleet.from_table2("alexnet", m=m, wire="int8"), m)
             for m in (1, 4)]
    paths += [(tree_fleet(api, e), f"tree E={e}") for e in TREE_EDGES]
    rows = set()
    for fleet, key in paths:
        p = api.plan(cnn.alexnet(), fleet, B)
        rows |= wire_rows(p.multi_schedule)
        if key in TRAIN_SLOW:
            for r in loop.replay(train_config(loop, p), p.profile,
                                 p.network, train_slowdown(key),
                                 topology=p.fleet.topology,
                                 initial_schedule=p.schedule):
                rows |= wire_rows(as_multi(api, r["sched"]))
    return tuple(sorted(rows, reverse=True))


def explain_plan(p, label: str) -> dict:
    """``p.explain()`` and ``p.simulate()`` of one plan, printed."""
    text = p.explain()
    sim = p.simulate()
    print(f"  {label} explain():")
    for line in text.splitlines():
        print(f"    {line}")
    print(f"  {label} simulate(): {sim!r} s (T_total {p.t_total!r} s); "
          f"stream edges {p.stream_edges()}")
    return {"simulate": sim, "t_total": p.t_total,
            "stream_edges": list(p.stream_edges())}


def check_tree_e1_bitwise(torch, api, cnn) -> dict:
    """At E=1 every stream sits on edge 0 and the tree step runs the
    star's arithmetic: two steps of the E=1 tree plan and of the star
    plan of the same fleet, from the same params and batch (cuDNN held to
    deterministic algorithms by the caller), must give bitwise equal
    losses and params."""
    tree = api.plan(cnn.alexnet(), tree_fleet(api, 1), B)
    star = api.plan(cnn.alexnet(), api.Fleet.from_table2(
        "alexnet", m=4, edge_cloud_mbps=2.0, topology="star", wire="int8"),
        B)
    if tree.multi_schedule != star.multi_schedule or \
            set(tree.stream_edges()) != {0}:
        fail(f"tree E=1: plan {tree.schedule} on edges "
             f"{tree.stream_edges()} is not the star's {star.schedule}")
    x, y = batch(torch)
    runs = []
    for p in (tree, star):
        params, step, losses = p.init_params(seed=SEED), p.step_fn(lr=LR), []
        for _ in range(2):
            params, loss = step(params, x, y)
            losses.append(loss)
        runs.append((params, losses))
    torch.cuda.synchronize()
    equal = same_params(torch, runs[0][0], runs[1][0]) and \
        all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    losses = [float(v) for v in runs[0][1]]
    print(f"  tree E=1 vs star, 2 steps from the same params and batch: "
          f"bitwise equal {equal}; losses {losses}")
    if not equal:
        fail("tree E=1: the tree step differs from the star step")
    return {"plan": str(tree.schedule), "equal": equal, "losses": losses}


# ---------------------------------------------------------------------------
# Phases 6 and 7: the LM stacks.
# ---------------------------------------------------------------------------


# The kernel each block kind's forward launches once per batch that
# passes it (``LMLayerStack.block_kinds``): attention and MoE blocks run
# flash attention, Mamba2 and mLSTM blocks the GLA scan; an sLSTM block is
# an eager step loop and launches neither.  The backwards are plain.
BLOCK_KERNELS = {"attn": "flash_attention", "moe": "flash_attention",
                 "mamba2": "gla_scan", "mlstm": "gla_scan"}


def expected_lm_launches(stack, sched, wire: str) -> dict:
    """Kernel launches of one step, from the schedule's executed
    segments: each block runs once per non-empty batch that passes it
    (worker o's running batch, and every non-empty TASK-S/L stream below
    its cut) and launches its kind's kernel (``BLOCK_KERNELS``); each
    int8 crossing quantizes forward and backward."""
    count = {"flash_attention": 0, "gla_scan": 0,
             "int8_quant": 2 * crossings(sched) if wire == "int8" else 0}
    for i, kind in enumerate(stack.block_kinds):
        if kind not in BLOCK_KERNELS:
            continue
        o_batch = sched.b_o + sum(b for m, b in zip(sched.m_s, sched.b_s)
                                  if m <= i) \
            + (sched.b_l if sched.m_l <= i else 0)
        n = int(o_batch > 0)
        n += sum(1 for m, b in zip(sched.m_s, sched.b_s) if b and i < m)
        n += int(sched.b_l > 0 and i < sched.m_l)
        count[BLOCK_KERNELS[kind]] += n
    return count


def lm_steps(torch, kernels, p, params, x, y, lr: float, n_steps: int,
             label: str) -> dict:
    """``n_steps`` of ``Plan.step_fn`` on one fixed batch, with the launch
    counters zeroed just before and read just after."""
    step = p.step_fn(lr=lr)
    T = x.shape[1]
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    zero_counters(kernels)
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = read_counters(kernels)
    per_step = expected_lm_launches(p.model, p.multi_schedule, p.wire)
    want = {k: v * n_steps for k, v in per_step.items()}
    peak = torch.cuda.max_memory_allocated()
    per_token = [v / T for v in losses]
    print(f"  {label} losses per sequence {losses}")
    print(f"  {label} losses per token {per_token}")
    print(f"  {label} step ms {ms}; peak memory {peak / 2 ** 30:.3f} GiB"
          f" ({start / 2 ** 30:.3f} GiB allocated before the first step)")
    print(f"  {label} launches {launches} (expected {want})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss {losses}")
    if not all(b < a for a, b in zip(losses, losses[1:])):
        fail(f"{label}: the loss did not fall on a fixed batch: {losses}")
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    prof = profile_call(torch, lambda: step(params, x, y), label)
    return {"losses": losses, "per_token": per_token, "step_ms": ms,
            "peak_bytes": peak, "start_bytes": start, "launches": launches,
            "launches_per_step": per_step, "profile": prof}


def profile_call(torch, fn, label: str) -> dict:
    """``fn()`` under ``torch.profiler``: device time by kernel (one
    stream, so kernels do not overlap) against the call's wall time, and
    the ten kernels that took the most.  Only the device-side kernel
    events count: ``key_averages()`` also lists each host-side operator
    with the device time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    top = [{"ms": ms, "count": n, "name": name[:100]}
           for ms, n, name in rows[:10]]
    ours = {k: sum(ms for ms, _, name in rows if tag in name)
            for k, tag in (("flash_attention", "flash_fwd"),
                           ("gla_scan", "gla_fwd"),
                           ("int8_quant", "quant_rows"))}
    share = "not measured" if busy == 0 else \
        f"{busy:.2f} ms, {busy / wall:.3f} of the profiled wall"
    print(f"  {label} profiled: wall {wall:.2f} ms, device busy "
          f"{share}, {n_kernels} kernels; our kernels {ours}")
    for r in top:
        print(f"    {r['ms']:9.3f} ms  x{r['count']:<5d} {r['name']}")
    return {"wall_ms": wall, "device_busy_ms": busy, "kernels": n_kernels,
            "ours_ms": ours, "top": top}


SLSTM_RANGE = "slstm_step"


def split_prefill(torch, xlstm_mod, fn, label: str,
                  activities=None) -> dict:
    """``fn()``, one xLSTM prefill, under ``torch.profiler`` with each
    sLSTM step (``xlstm._slstm_cell``) in a ``record_function`` range:
    device ms of the GLA kernel, of the kernels the sLSTM step loop
    launched and of the rest, beside the call's wall and the host ms
    inside the steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    if activities is None:
        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cell = xlstm_mod._slstm_cell

    def step(*args):
        with record_function(SLSTM_RANGE):
            return cell(*args)

    torch.cuda.synchronize()
    xlstm_mod._slstm_cell = step
    try:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        xlstm_mod._slstm_cell = cell
    steps = [e for e in prof.events() if e.name == SLSTM_RANGE and
             e.device_type == DeviceType.CPU]
    loop_ms = sum(e.device_time_total for e in steps) / 1e3
    loop_host_ms = sum(e.cpu_time_total for e in steps) / 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.key == SLSTM_RANGE:
            continue   # the range's own device-side annotation is no kernel
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            kernels.append((us / 1e3, e.count, e.key[:100]))
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    gla = sum(ms for ms, _, name in kernels if "gla_fwd" in name)
    out = {"wall_ms": wall, "device_busy_ms": busy, "gla_ms": gla,
           "slstm_loop_ms": loop_ms, "rest_ms": busy - gla - loop_ms,
           "slstm_steps": len(steps), "slstm_loop_host_ms": loop_host_ms,
           "top": [{"ms": ms, "count": n, "name": name}
                   for ms, n, name in kernels[:8]]}
    print(f"  {label} prefill split by kernel (device ms): GLA {gla:.3f}, "
          f"sLSTM step loop {loop_ms:.3f} ({len(steps)} steps, "
          f"{loop_host_ms:.3f} host ms inside them), rest "
          f"{out['rest_ms']:.3f}; busy {busy:.3f} of a {wall:.3f} ms "
          f"profiled wall")
    for r in out["top"]:
        print(f"    {r['ms']:9.3f} ms  x{r['count']:<6d} {r['name']}")
    return out


def to_float(torch, params):
    def conv(t):
        return {k: conv(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.float()
    return [conv(p) for p in params]


def run_lm_fleet(torch, api, hs, kernels, stack, m: int,
                 gap_floor: bool = False) -> dict:
    """A fleet LM stack (fleet-gla, fleet-moe, fleet-xlstm) on
    ``Fleet.lm_default(m)`` with the int8 wire: plan, steps through the
    stack's kernels, the per-token int8 gap against ``wire="none"`` on
    the same cuts, and an f32 ``wire="none"`` variant on the same cuts
    against ``reference_sgd_step``.  The gap is held to
    ``E2E_LOSS_GAP``; with ``gap_floor`` to the larger of that and the
    precision floor, the gap between the same ``wire="none"`` steps in
    the stack's dtype and in f32 (``GAP_FLOOR_STACKS``)."""
    from repro_torch.models.lm.layerstack import lm_layerstack
    fleet = api.Fleet.lm_default(m=m, wire="int8")
    p = api.plan(stack, fleet, LM_B)
    sched = p.multi_schedule
    T = stack.seq_len
    label = f"{stack.cfg.name} M={m}"
    print(f"  {label} plan: {p.schedule}  T_total={p.t_total!r} s (model)")
    if crossings(sched) == 0:
        fail(f"{label}: the plan crosses no int8 wire (m > 0, b > 0)")
    gen = torch.Generator(device="cuda").manual_seed(BATCH_SEED)
    x, y = stack.dummy_batch(gen, LM_B)
    lr = LM_LR
    run = lm_steps(torch, kernels, p, p.init_params(seed=SEED), x, y, lr,
                   LM_STEPS, label)

    def none_losses(st, params):
        """Per-token losses of LM_STEPS ``wire="none"`` steps."""
        out = []
        for _ in range(LM_STEPS):
            params, loss = hs.multi_hybrid_step_from_schedule(
                st, params, x, y, p.schedule, lr, wire="none")
            out.append(float(loss) / T)
        return out

    # the same steps with wire="none" on the same cuts: per-token gap
    none = none_losses(stack, p.init_params(seed=SEED))
    gaps = [abs(a - b / T) for a, b in zip(none, run["losses"])]
    print(f"  {label} wire='none' losses per token {none}")
    print(f"  {label} int8-vs-none per-token loss gaps {gaps}")
    # the precision floor: the same wire="none" steps in f32 from the
    # same (bf16) init
    stack32 = lm_layerstack(stack.cfg.variant(dtype=torch.float32), T,
                            backend="cuda")
    none32 = none_losses(stack32, to_float(torch, p.init_params(seed=SEED)))
    floor = [abs(a - b) for a, b in zip(none, none32)]
    limit = max(E2E_LOSS_GAP, max(floor)) if gap_floor else E2E_LOSS_GAP
    print(f"  {label} f32 wire='none' losses per token {none32}")
    print(f"  {label} precision floor (bf16-vs-f32 per-token loss gaps) "
          f"{floor}; int8 gap limit {limit!r}")
    if max(gaps) > limit:
        fail(f"{label}: per-token int8 loss gap {max(gaps)} exceeds "
             f"{limit}")

    # f32 variant, wire none, same cuts, against vanilla SGD
    p32 = to_float(torch, p.init_params(seed=SEED))
    res = compare_updates(
        torch, hs, stack32, p32, x, y,
        lambda q: hs.multi_hybrid_step_from_schedule(
            stack32, q, x, y, p.schedule, lr, wire="none"), lr)
    print(f"  {label} f32 reference check: loss rel gap "
          f"{res['loss_rel_gap']!r}; worst leaf {res['worst']}")
    if not res["ok"]:
        fail(f"{label}: f32 wire='none' hybrid step disagrees with vanilla "
             f"SGD")
    del p32
    torch.cuda.empty_cache()
    run.update({"plan": str(p.schedule), "t_total": p.t_total,
                "int8_gap_per_token": max(gaps), "gap_limit": limit,
                "precision_floor": floor,
                "reference": {"loss_rel_gap": res["loss_rel_gap"],
                              "worst": res["worst"]}})
    return run


def run_deep_cut(torch, api, kernels, stack, B: int, lr: float,
                 n_steps: int, needs: tuple) -> dict:
    """A published config at full width, its depth cut (zamba2-7b one
    group, qwen2-moe-a2.7b 2 layers), on ``Fleet.lm_default(m=1)`` with
    the int8 wire: plan, then steps; each kernel in ``needs`` must
    launch."""
    p = api.plan(stack, api.Fleet.lm_default(m=1, wire="int8"), B)
    label = stack.cfg.name
    print(f"  {label} plan: {p.schedule}  T_total={p.t_total!r} s (model)")
    n_params = sum(m.param_count for m in stack.cut_meta())
    print(f"  {label} parameters: {n_params}")
    gen = torch.Generator(device="cuda").manual_seed(BATCH_SEED)
    x, y = stack.dummy_batch(gen, B)
    run = lm_steps(torch, kernels, p, p.init_params(seed=SEED), x, y, lr,
                   n_steps, label)
    if any(run["launches"][k] == 0 for k in needs):
        fail(f"{label}: one of {needs} never launched: {run['launches']}")
    torch.cuda.empty_cache()
    run.update({"plan": str(p.schedule), "params": n_params})
    return run


# ---------------------------------------------------------------------------
# Phases 10-12: training the moe and xlstm families; the flat train loop.
# ---------------------------------------------------------------------------

# fleet-xlstm's int8-vs-none gap is held to the larger of E2E_LOSS_GAP
# and its precision floor: how far the same wire="none" steps move the
# per-token loss when run in f32 instead of bf16 from the same init.  At
# phase 6's lr the JAX reference's own int8 wire moves this stack past
# E2E_LOSS_GAP, and the port's moves it as far, step for step
# (tests/test_torch_int8_gap.py; tests/int8_gap_probe.py prints both
# packages' gaps and floors over more steps).
GAP_FLOOR_STACKS = ("fleet-xlstm",)
# qwen2-moe-a2.7b at its published widths, cut to 2 of 24 layers, routes
# 2,048-token sequences in groups of 1,024.
QM_REDUCED = {"n_layers": 2}
QM_B, QM_T, QM_LR, QM_STEPS = 4, 2048, 1e-4, 3
# xlstm-350m through make_train_step (AdamW) and run_train_loop at its
# published config, full depth: FLAT_STEPS steps, then a run killed after
# step FLAT_FAIL_AT and resumed from its step-FLAT_CKPT_EVERY checkpoint.
# T is cut from 2,048 to 512: at 2,048 a step took 20.7-24.7 s (548k
# kernels, the sLSTM step loops' forward, remat forward and backward;
# device busy 0.055) and the phase 819 s of the smoke's 1,200.
FLAT_B, FLAT_T, FLAT_LR, FLAT_STEPS = 4, 512, 1e-3, 3
FLAT_CKPT_EVERY, FLAT_FAIL_AT = 2, 3


def flat_launches(cfg) -> dict:
    """Kernel launches of one ``make_train_step`` step on ``build_model``:
    a forward's, twice with ``cfg.remat``, whose blocks re-run their
    forward in the backward.  A forward launches what a prefill does
    (``serve_launches``), and in the ``encdec`` family also the flash
    kernel once per decoder layer: its training forward runs the
    decoder's self-attention through ``use_flash``, where the prefill
    runs the plain attention."""
    k = 2 if cfg.remat else 1
    fwd = serve_launches(cfg)
    if cfg.family == "encdec":
        fwd["flash_attention"] += cfg.n_layers
    return {name: n * k for name, n in fwd.items()}


@contextlib.contextmanager
def deterministic(torch, algorithms: bool = True):
    """cuDNN's deterministic algorithms; with ``algorithms`` also
    PyTorch's deterministic implementations (an ``index_add`` by sort,
    not by atomics; a warning where an op has none), new tensors left
    unfilled.  The flags are restored after."""
    import torch.utils.deterministic as det
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             det.fill_uninitialized_memory)
    cudnn.deterministic, cudnn.benchmark = True, False
    if algorithms:
        torch.use_deterministic_algorithms(True, warn_only=True)
        det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = flags[:2]
        if algorithms:
            torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])
            det.fill_uninitialized_memory = flags[4]


def run_flat_loop(torch, kernels, lm_model, optim, train, make_batch_fn,
                  shape, cfg, tmp: Path) -> dict:
    """``cfg`` through ``init_state`` -> ``make_train_step`` (AdamW) ->
    ``run_train_loop`` on the synthetic token stream (``shape``): the
    launch counters zeroed just before ``FLAT_STEPS`` steps and read just
    after, against ``flat_launches``; finite losses, and the trained
    params' loss on the first batch below the initial one; then a run
    killed after step ``FLAT_FAIL_AT`` and a run resumed from its
    step-``FLAT_CKPT_EVERY`` checkpoint, whose state must be bitwise the
    uninterrupted run's; one profiled step."""
    label = f"{cfg.name} flat"
    model = lm_model.build_model(cfg)
    opt = optim.AdamW(lr=FLAT_LR)
    step = train.make_train_step(model, opt)
    batch_fn = make_batch_fn(cfg, shape, seed=BATCH_SEED)

    def fresh():
        g = torch.Generator(device="cuda").manual_seed(SEED)
        return train.init_state(model, opt, g, "cuda")

    ms = []

    def timed(state, batch, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch, k)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    state = fresh()
    n_params = sum(t.numel() for _, t in leaves(state["params"]))
    print(f"  {label} parameters: {n_params}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    zero_counters(kernels)
    ref = train.run_train_loop(
        train.LoopConfig(FLAT_STEPS, log_every=1), state, timed, batch_fn,
        log=lambda line: print(f"  {label} {line}"))
    launches = read_counters(kernels)
    peak = torch.cuda.max_memory_allocated()
    per_step = flat_launches(cfg)
    want = {k: v * FLAT_STEPS for k, v in per_step.items()}
    losses = [h["loss"] for h in ref["history"]]
    print(f"  {label} losses {losses}")
    print(f"  {label} step ms {ms}; peak memory {peak / 2 ** 30:.3f} GiB "
          f"({start / 2 ** 30:.3f} GiB allocated before the first step)")
    print(f"  {label} launches {launches} (expected {want})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss {losses}")
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    # each step draws a new batch, whose loss moves by more than a step's
    # progress; so the trained params are held to the first batch
    dev = next(leaves(ref["state"]["params"]))[1].device
    with torch.no_grad():
        first = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch_fn(0).items()}
        after = float(model.loss_fn(ref["state"]["params"], first))
    print(f"  {label} loss on batch 0: {losses[0]} at init, {after} after "
          f"{FLAT_STEPS} steps")
    if not after < losses[0]:
        fail(f"{label}: the loss on batch 0 did not fall: {losses[0]} -> "
             f"{after}")

    kw = dict(ckpt_every=FLAT_CKPT_EVERY, ckpt_dir=str(tmp), log_every=1)
    t0 = time.perf_counter()
    try:
        train.run_train_loop(
            train.LoopConfig(FLAT_STEPS, fail_at=FLAT_FAIL_AT, **kw),
            fresh(), step, batch_fn, log=None)
    except train.InjectedFailure as e:
        print(f"  {label} killed: {e}")
    else:
        fail(f"{label}: the injected failure never fired")
    t1 = time.perf_counter()
    out = train.run_train_loop(train.LoopConfig(FLAT_STEPS, **kw), fresh(),
                               step, batch_fn, log=None)
    t2 = time.perf_counter()
    equal = all(torch.equal(a, b) for (_, a), (_, b) in
                zip(leaves(out["state"]), leaves(ref["state"])))
    tail = [h["loss"] for h in out["history"]]
    print(f"  {label} killed after step {FLAT_FAIL_AT} "
          f"({(t1 - t0) * 1e3:.1f} ms with its checkpoint at step "
          f"{FLAT_CKPT_EVERY}), resumed from step {out['resumed_from']} "
          f"({(t2 - t1) * 1e3:.1f} ms): state bitwise equal {equal}; "
          f"losses after the resume {tail}")
    if out["resumed_from"] != FLAT_CKPT_EVERY or not equal or \
            tail != losses[FLAT_CKPT_EVERY:]:
        fail(f"{label}: the resumed run differs from the uninterrupted one")
    del out
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in batch_fn(FLAT_STEPS).items()}
    prof = profile_call(torch, lambda: step(ref["state"], batch, FLAT_STEPS),
                        label)
    return {"losses": losses, "loss_after_on_batch0": after,
            "step_ms": ms, "peak_bytes": peak,
            "start_bytes": start, "params": n_params, "launches": launches,
            "launches_per_step": per_step, "kill_ms": (t1 - t0) * 1e3,
            "resume_ms": (t2 - t1) * 1e3, "resume_bitwise": equal,
            "profile": prof}


# ---------------------------------------------------------------------------
# Phase 9: serving.
# ---------------------------------------------------------------------------


def serve_launches(cfg) -> dict:
    """Kernel launches of one prefill: flash once per attention block
    applied (every layer of a dense or MoE model; each of zamba's
    ``n_layers // shared_attn_every`` shared-block applications; each
    encoder layer of whisper, whose decoder prefill runs the plain
    attention as the reference's does), the GLA scan once per Mamba2 or
    mLSTM layer.  A decode step launches neither."""
    launches = {"int8_quant": 0, "flash_attention": 0, "gla_scan": 0}
    if cfg.family == "zamba":
        launches["flash_attention"] = cfg.n_layers // cfg.shared_attn_every
        launches["gla_scan"] = cfg.n_layers
    elif cfg.family == "xlstm":
        every = cfg.xlstm.slstm_every
        launches["gla_scan"] = cfg.n_layers - (cfg.n_layers // every
                                               if every else 0)
    elif cfg.family == "encdec":
        launches["flash_attention"] = cfg.encoder_layers
    else:
        launches["flash_attention"] = cfg.n_layers
    return launches


def serve_config(configs, arch: str):
    """The served config: the published one with the kernels on, cut as
    ``SERVE_REDUCED`` says."""
    return configs.get_arch(arch).lm.variant(
        use_flash=True, use_gla_kernel=True, **SERVE_REDUCED.get(arch, {}))


def no_drop_variant(cfg):
    """An MoE config whose output does not depend on the batch: capacity
    ``G`` per expert and group (``capacity_factor = n_experts / top_k``),
    so no token is dropped, in groups of ``SERVE_B`` tokens (a divisor
    of every token count the serving checks run).  At the published
    capacity a decode step's group of ``SERVE_B`` tokens has capacity 1
    and drops tokens, and the forward over ``SERVE_T + SERVE_TF``
    positions is not a multiple of the published group; so check (b)
    runs on this variant.  Other families are returned as they are."""
    if cfg.family != "moe":
        return cfg
    moe = dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k,
        group_size=SERVE_B)
    return cfg.variant(moe=moe)


def serve_inputs(torch, cfg, g, B: int, T: int) -> tuple:
    """(prompt batch, tokens ``[B, prompt tokens + SERVE_TF]``, max_len)
    of ``B`` prompts of ``T`` positions, drawn from ``g``.  whisper-base
    takes ``WHISPER_T`` tokens and seeded bf16 frames; a config with a
    frontend stub (pixtral-12b) takes ``P = min(n_frontend_tokens, T //
    2)`` seeded bf16 patch embeddings, then ``T - P`` tokens, as
    ``configs.base.input_specs`` shapes its prompts."""
    encdec = cfg.family == "encdec"
    P = min(cfg.n_frontend_tokens, T // 2)
    n_tok = WHISPER_T if encdec else T - P
    toks = torch.randint(0, cfg.vocab, (B, n_tok + SERVE_TF), generator=g,
                         device=g.device)
    batch = {"tokens": toks[:, :n_tok]}
    if encdec:
        batch["frames"] = torch.randn(B, SERVE_FRAMES, cfg.d_model,
                                      generator=g, device=g.device).to(
                                          cfg.dtype)
    elif P:
        batch["embeds"] = torch.randn(B, P, cfg.d_model, generator=g,
                                      device=g.device).to(cfg.dtype)
    return batch, toks, WHISPER_MAX_LEN if encdec else T + SERVE_NEW


def prefix_len(batch) -> int:
    """Positions ahead of the prompt's tokens: the ``embeds`` prefix
    (pixtral-12b's patch embeddings), else 0.  Decode positions are
    absolute, so they count it (``serve.engine.generate``)."""
    return batch["embeds"].shape[1] if "embeds" in batch else 0


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def forward_logits(torch, lm_model, model, params, batch, toks):
    """f32 logits of the kernel forward (``hidden_fn``) over the prompt
    and the teacher-forced tokens, from the prompt's last position on:
    ``[B, 1 + SERVE_TF, V]``."""
    end = prefix_len(batch) + batch["tokens"].shape[1]
    hidden = model.hidden_fn(params, dict(batch, tokens=toks))
    h = lm_model._apply_norm(model.cfg, params["final_norm"],
                             hidden[:, end - 1:])
    del hidden
    return (h @ params["lm_head"]).float()


def decode_pairs(torch, logits, step_logits, full) -> tuple:
    """Check (b)'s (got, want) pairs (the prefill's last logits, then
    each decode step, against the forward) and whether every logit is
    finite."""
    pairs = [(logits, full[:, 0])] + \
        [(s, full[:, 1 + i]) for i, s in enumerate(step_logits)]
    finite = all(bool(torch.isfinite(t).all())
                 for t in step_logits + [logits, full])
    return pairs, finite


class Routes:
    """The experts each MoE layer chooses in one run (``record``: expert
    ids ``[B, T, K]`` per layer, in call order), then followed by other
    runs of the same model (``follow``)."""

    def __init__(self):
        from repro_torch.models.lm import moe
        self.moe, self.rec, self.flips = moe, [], []

    @contextlib.contextmanager
    def record(self):
        def hook(idx):
            self.rec.append(idx.clone())
            return idx
        with self.moe.routing(hook):
            yield

    @contextlib.contextmanager
    def follow(self, t0: int, replay: bool):
        """Each layer routed by the recorded choices at positions ``[t0,
        t0 + T)`` (``replay``) or by its own; appends to ``flips`` the
        number of (layer, token) whose own choices differ from the
        recorded ones."""
        calls, n = iter(self.rec), []

        def hook(idx):
            rec = next(calls, None)
            if rec is None:
                fail("a run has more MoE layers than the recorded one")
            want = rec[:, t0:t0 + idx.shape[1]]
            n.append((idx != want).any(-1).sum())
            return want if replay else idx
        with self.moe.routing(hook):
            yield
        if len(n) != len(self.rec):
            fail(f"{len(n)} MoE layers ran, {len(self.rec)} recorded")
        self.flips.append(int(sum(n)))


def decode_logits(model, params, batch, toks, max_len, around) -> tuple:
    """The prefill's last logits and those of ``SERVE_TF`` teacher-forced
    decode steps, each call inside ``around(t0)`` (t0 its first
    position)."""
    T, P = batch["tokens"].shape[1], prefix_len(batch)
    with around(0):
        logits, cache = model.prefill(params, batch, max_len)
    steps = []
    for i in range(SERVE_TF):
        with around(P + T + i):
            step, cache = model.decode_step(params, toks[:, T + i:T + i + 1],
                                            cache, P + T + i)
        steps.append(step)
    del cache
    return logits, steps


def moe_checks(torch, lm_model, model, plain, params, batch, toks,
               max_len, logits) -> dict:
    """Checks (a) and (b) of an MoE arch.  (a): the kernel prefill (its
    last logits ``logits``) recorded, the plain prefill run with its own
    routing and with the kernel's replayed.  (b), on ``no_drop_variant``:
    the kernel forward recorded, prefill and decode steps run with their
    own routing and with the forward's replayed.  Each run with its own
    routing counts the (layer, token) choices that differ from the
    recorded ones."""
    routes = Routes()
    with routes.record():
        rec_logits, cache = model.prefill(params, batch, max_len)
    del cache
    if not torch.equal(rec_logits, logits):
        fail("recording the routing changed the kernel prefill")
    a, finite = {}, True
    for replay in (False, True):
        with routes.follow(0, replay):
            got, cache = plain.prefill(params, batch, max_len)
        del cache
        a[replay] = rel_err(logits, got)
        finite = finite and bool(torch.isfinite(got).all())
    flips_a = routes.flips[0]

    model_b = lm_model.build_model(no_drop_variant(model.cfg))
    routes = Routes()
    with routes.record():
        full = forward_logits(torch, lm_model, model_b, params, batch, toks)
    b = {}
    for replay in (False, True):
        first, steps = decode_logits(
            model_b, params, batch, toks, max_len,
            lambda t0: routes.follow(t0, replay))
        pairs, ok = decode_pairs(torch, first, steps, full)
        b[replay] = [rel_err(g, w) for g, w in pairs]
        finite = finite and ok
    return {"err_a": a[True], "err_a_own_routing": a[False],
            "flips_a": flips_a, "errs_b": b[True],
            "errs_b_own_routing": b[False],
            "flips_b": routes.flips[:1 + SERVE_TF], "finite": finite}


def run_serve(torch, kernels, configs, lm_model, engine, arch) -> dict:
    """One published config through ``build_model`` -> ``init`` on the
    card -> ``generate`` (twice, greedy; counters zeroed just before each
    and read just after), then the prefill alone, the same prefill on the
    plain paths (a), ``SERVE_TF`` teacher-forced decode steps (each with
    its launches) against the kernel forward over the prompt and those
    tokens (b; for MoE ``moe_checks``), and one profiled decode step.
    Params and caches are freed before it returns."""
    cfg = serve_config(configs, arch)
    model = lm_model.build_model(cfg)
    plain = lm_model.build_model(cfg.variant(use_flash=False,
                                             use_gla_kernel=False))
    tol_a, tol_b = SERVE_TOL[arch]
    reduced = SERVE_REDUCED.get(arch, {})
    label = f"{arch} serve"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = lm_model.param_count(params)
    param_bytes = torch.cuda.memory_allocated()
    g = torch.Generator(device="cuda").manual_seed(BATCH_SEED)
    batch, toks, max_len = serve_inputs(torch, cfg, g, SERVE_B, SERVE_T)
    T, P = batch["tokens"].shape[1], prefix_len(batch)
    per_prefill = serve_launches(cfg)
    extra = "".join(f", {k} {tuple(batch[k].shape)}"
                    for k in ("frames", "embeds") if k in batch)
    print(f"  {label}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters ({param_bytes / 2 ** 30:.3f} GiB "
          f"allocated), init {init_s:.2f} s; B={SERVE_B}, prompt "
          f"{T} tokens{extra}, {SERVE_NEW} new tokens, max_len {max_len}; "
          f"reduced {reduced or 'nothing'}")
    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        gens = []
        for _ in range(2):
            torch.cuda.synchronize()
            zero_counters(kernels)
            t0 = time.perf_counter()
            out = engine.generate(model, params, batch, max_len=max_len,
                                  n_new=SERVE_NEW)
            torch.cuda.synchronize()
            gens.append({"out": out, "ms": (time.perf_counter() - t0) * 1e3,
                         "launches": read_counters(kernels)})
        peak = torch.cuda.max_memory_allocated()

        torch.cuda.synchronize()
        zero_counters(kernels)
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = read_counters(kernels)
        finite = bool(torch.isfinite(logits).all())
        split = None
        if cfg.family == "xlstm":
            from repro_torch.models.lm import xlstm as xlstm_mod
            split = split_prefill(torch, xlstm_mod, lambda: model.prefill(
                params, batch, max_len), label)
        if cfg.family != "moe":
            plain_logits, plain_cache = plain.prefill(params, batch, max_len)
            del plain_cache
            err_a = rel_err(logits, plain_logits)
            finite = finite and bool(torch.isfinite(plain_logits).all())
            del plain_logits

        step_ms, step_launches, step_logits = [], [], []
        for i in range(SERVE_TF):
            tok = toks[:, T + i:T + i + 1]
            torch.cuda.synchronize()
            zero_counters(kernels)
            t0 = time.perf_counter()
            step, cache = model.decode_step(params, tok, cache, P + T + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_launches.append(read_counters(kernels))
            step_logits.append(step)
        prof = profile_call(torch, lambda: model.decode_step(
            params, toks[:, -1:], cache, P + T + SERVE_TF),
            f"{label} decode step")
        del cache
        moe = None
        if cfg.family == "moe":
            print(f"  {label} (b) on the no-drop variant: "
                  f"{no_drop_variant(cfg).moe}")
            moe = moe_checks(torch, lm_model, model, plain, params, batch,
                             toks, max_len, logits)
            err_a, errs_b, finite_b = moe["err_a"], moe["errs_b"], \
                moe["finite"]
        else:
            pairs_b, finite_b = decode_pairs(
                torch, logits, step_logits,
                forward_logits(torch, lm_model, model, params, batch, toks))
            errs_b = [rel_err(g, w) for g, w in pairs_b]
            del pairs_b
        err_b = max(errs_b)
    torch.cuda.synchronize()

    decode = steady(step_ms)
    gen_ms = [r["ms"] for r in gens]
    busy = None if prof["device_busy_ms"] == 0 else \
        prof["device_busy_ms"] / prof["wall_ms"]
    res = {
        "arch": arch, "reduced": reduced, "prompt": T, "prefix": P,
        "max_len": max_len,
        "no_drop_variant": None if moe is None else
        str(no_drop_variant(cfg).moe),
        "params": n_params, "param_bytes": param_bytes,
        "init_s": init_s, "prefill_ms": prefill_ms, "prefill_split": split,
        "decode_ms": step_ms, "decode_ms_median": decode["median"],
        "decode_tokens_per_s": SERVE_B / decode["median"] * 1e3,
        "generate_ms": gen_ms,
        "generate_tokens_per_s": SERVE_B * SERVE_NEW / min(gen_ms) * 1e3,
        "peak_bytes": peak, "busy_share": busy, "profile": prof,
        "err_prefill_vs_plain": err_a, "err_decode_vs_forward": err_b,
        "err_by_position": errs_b, "moe_routing": moe,
        "tol": [tol_a, tol_b], "launches": gens[0]["launches"],
        "launches_per_step": per_prefill,
        "prefill_launches": prefill_launches, "step_launches": step_launches,
        "tokens": gens[0]["out"].tokens[0].tolist()}
    print(f"  {label} prefill ms {prefill_ms:.3f} (B={SERVE_B} x {P + T} "
          f"positions: {SERVE_B * (P + T) / prefill_ms * 1e3:.0f} "
          f"positions/s)")
    print(f"  {label} decode ms per token {decode['median']:.3f} (median of "
          f"{decode['n']} steps after the first {decode['first']:.3f}; max "
          f"{decode['max']:.3f}): {res['decode_tokens_per_s']:.1f} tokens/s "
          f"at B={SERVE_B}")
    print(f"  {label} generate ms {gen_ms} ({SERVE_B} x {SERVE_NEW} tokens, "
          f"prefill included): {res['generate_tokens_per_s']:.1f} tokens/s")
    print(f"  {label} peak memory {peak / 2 ** 30:.3f} GiB over generate")
    print(f"  {label} decode-step device busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'}")
    routed = "" if moe is None else " (routing replayed)"
    print(f"  {label} (a) kernel vs plain prefill{routed}: {err_a:.4e} of "
          f"the largest |logit| (tol {tol_a}); (b) prefill and decode "
          f"steps vs the kernel forward{routed}: {err_b:.4e} (by position "
          f"{[f'{e:.4e}' for e in errs_b]}; tol {tol_b})")
    if moe is not None:
        print(f"  {label} own routing: (a) {moe['err_a_own_routing']:.4e} "
              f"with {moe['flips_a']} (layer, token) choices flipped of "
              f"{cfg.n_layers * SERVE_B * T}; (b) by position "
              f"{[f'{e:.4e}' for e in moe['errs_b_own_routing']]} with "
              f"{moe['flips_b']} flipped of {cfg.n_layers * SERVE_B * T} "
              f"(prefill), {cfg.n_layers * SERVE_B} (each step)")
    print(f"  {label} launches per generate {[r['launches'] for r in gens]}, "
          f"prefill {prefill_launches} (expected {per_prefill}); per "
          f"decode step {step_launches}")
    finite = finite and finite_b and all(
        bool(torch.isfinite(t).all()) for t in
        [r["out"].prefill_logits for r in gens] + step_logits)
    same = torch.equal(gens[0]["out"].tokens, gens[1]["out"].tokens) and \
        torch.equal(gens[0]["out"].prefill_logits,
                    gens[1]["out"].prefill_logits)
    tokens = gens[0]["out"].tokens
    print(f"  {label} greedy runs bitwise equal: {same}; tokens of row 0 "
          f"{res['tokens']}")
    if not finite:
        fail(f"{label}: a logit is not finite")
    if tuple(tokens.shape) != (SERVE_B, SERVE_NEW) or \
            not bool(((tokens >= 0) & (tokens < cfg.vocab)).all()):
        fail(f"{label}: tokens {tuple(tokens.shape)} out of shape or range")
    if not err_a <= tol_a:
        fail(f"{label}: (a) kernel prefill {err_a} from the plain one")
    if not err_b <= tol_b:
        fail(f"{label}: (b) decode {err_b} from the kernel forward")
    if not same:
        fail(f"{label}: two greedy generate runs differ")
    zero = {k: 0 for k in per_prefill}
    if any(r["launches"] != per_prefill for r in gens) or \
            prefill_launches != per_prefill or \
            any(s != zero for s in step_launches):
        fail(f"{label}: launches differ from {per_prefill} per prefill and "
             f"none per decode step")
    del params, logits, gens, step_logits, batch, toks
    return res


# ---------------------------------------------------------------------------
# Phase 13: distrib/ on a one-rank NCCL group.
# ---------------------------------------------------------------------------

# qwen2.5-3b at its published widths, 8 of 36 layers (two train states
# and the f32 copies of the demoted leaves fit the card), B x T tokens,
# AdamW; HIER_STEPS steps of each tier setting (the first from the seeded
# state and checked, the rest timed).  HIER_MIXED demotes the largest
# leaves to the int8 tier (the greedy stops once the predicted sync fits
# a quarter of HIER_MIXED's compute_seconds at 25 GB/s); HIER_INT8 forces
# every leaf to it, as tests/test_distrib.py does.
HIER_ARCH, HIER_REDUCED = "qwen2.5-3b", {"n_layers": 8}
HIER_B, HIER_T, HIER_LR, HIER_STEPS = 4, 512, 1e-4, 4
HIER_MIXED = dict(dcn_bytes_per_s=25e9, compute_seconds=0.25)
HIER_INT8 = dict(dcn_bytes_per_s=1.0, compute_seconds=1e-12)
HIER_PODS = 2                     # dcn_bytes_per_step is printed for 2
# the cloud_mesh tree step against the same plan's step without it: the
# reference test's tolerances (tests/test_distrib.py:226-229) where the
# two are not bitwise equal
CLOUD_LOSS_RTOL, CLOUD_RTOL, CLOUD_ATOL = 1e-6, 2e-5, 2e-6


def hier_config(configs):
    return configs.get_arch(HIER_ARCH).lm.variant(use_flash=True,
                                                  **HIER_REDUCED)


def hier_tiers(tiered, params) -> dict:
    """The phase's tier assignments over ``params`` (``None`` is the
    all-full-width step)."""
    return {"none": None,
            "mixed": tiered.choose_tiers(params, n_pods=HIER_PODS,
                                         **HIER_MIXED),
            "int8": tiered.choose_tiers(params, n_pods=HIER_PODS,
                                        **HIER_INT8)}


def hier_sync_rows(torch, lm_model, tiered, cfg) -> list:
    """The ``_as_2d`` ``[M, N]`` of every leaf the phase's int8 tiers
    demote (every leaf, under ``HIER_INT8``), from a seeded init on the
    card that is freed after."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = lm_model.build_model(cfg).init(g, g.device)
    rows = set()
    for t in hier_tiers(tiered, params).values():
        if t is not None:
            flags = dict(leaves(t.quantized))
            rows |= {tuple(tiered._as_2d(x)[0].shape)
                     for k, x in leaves(params) if flags[k]}
    del params
    torch.cuda.empty_cache()
    return sorted(rows)


def hier_composition(torch, ref, tiered, step_mod, model, opt, state,
                     batch, tiers, step: int):
    """What a one-rank hier step must give: the flat step's gradients,
    each demoted leaf replaced by the plain quantizer's dequantized round
    trip under the same noise (one generator seeded by ``sync_seed(step,
    0)``, drawn in leaf order), then the optimizer's update."""
    from repro_torch import tree
    loss, grads = step_mod._microbatched_grads(model.loss_fn,
                                               state["params"], batch, 1)
    gen = torch.Generator(device="cuda").manual_seed(
        tiered.sync_seed(step, 0))
    out = []
    for g, q in zip(tree.leaves(grads), tree.leaves(tiers.quantized)):
        if q:
            g2, shape = tiered._as_2d(g.float())
            u = torch.rand(g2.shape, generator=gen, dtype=torch.float32,
                           device=g.device)
            codes, scale = ref.ref_quantize_int8(g2.contiguous(), u)
            del g2, u
            g = (codes.float() * scale[:, None]).reshape(shape).to(g.dtype)
            del codes, scale
        out.append(g)
    grads = tree.unflatten(grads, iter(out))
    params, opt_state, gnorm = opt.update(state["params"], grads,
                                          state["opt"])
    return {"params": params, "opt": opt_state}, loss


def same_state(torch, a, b) -> bool:
    return all(torch.equal(u, v) and u.dtype == v.dtype for (_, u), (_, v)
               in zip(leaves(a), leaves(b)))


def run_hier(torch, kernels, ref, lm_model, optim, train, step_mod, tiered,
             compat, make_batch_fn, shape, cfg, pod, held_rows) -> dict:
    """``make_train_step(hier_sync=True)`` on the ``("pod",)`` mesh of one
    rank for each tier setting, from one seeded state and batch: the
    full-width step bitwise the flat step, the int8 ones bitwise
    :func:`hier_composition`; the quantizer launched once per demoted
    leaf and flash as the layer count implies; step ms (host clock and
    ``synchronize``) and peak memory; one profiled step."""
    model = lm_model.build_model(cfg)
    opt = optim.AdamW(lr=HIER_LR)
    state0 = train.init_state(model, opt,
                              torch.Generator(device="cuda").manual_seed(
                                  SEED), "cuda")
    batch_fn = make_batch_fn(cfg, shape, seed=BATCH_SEED)
    dev = next(leaves(state0["params"]))[1].device

    def dev_batch(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in batch_fn(i).items()}

    n_params = sum(t.numel() for _, t in leaves(state0["params"]))
    tiers = hier_tiers(tiered, state0["params"])
    demoted = {name: [] if t is None else
               [k for k, q in leaves(t.quantized) if q]
               for name, t in tiers.items()}
    rows = {tuple(tiered._as_2d(x)[0].shape)
            for k, x in leaves(state0["params"])
            if any(k in d for d in demoted.values())}
    if not rows <= set(held_rows):
        fail(f"{cfg.name} hier: the int8 tiers quantize rows "
             f"{sorted(rows - set(held_rows))} phase 3 did not hold")
    flash = flat_launches(cfg)["flash_attention"]
    out = {"params": n_params, "tiers": {}}
    print(f"  {cfg.name} hier: {n_params} parameters, "
          f"{len(list(leaves(state0['params'])))} leaves")
    b0 = dev_batch(0)
    want, wmet = train.make_train_step(model, opt)(state0, b0, 0)
    for name, t in tiers.items():
        label = f"{cfg.name} hier tiers={name}"
        info = {"demoted": demoted[name]}
        if t is not None:
            info["dcn_bytes_per_step"] = tiered.dcn_bytes_per_step(
                t, HIER_PODS)
            info["describe"] = t.describe()
            print(f"  {label}: demoted {demoted[name]}; {t.describe()}; "
                  f"dcn_bytes_per_step(n_pods={HIER_PODS}) "
                  f"{info['dcn_bytes_per_step']!r}")
        step = train.make_train_step(model, opt, hier_sync=True, tiers=t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        zero_counters(kernels)
        t0 = time.perf_counter()
        with compat.set_mesh(pod):
            got, met = step(state0, b0, 0)
        torch.cuda.synchronize()
        ms = [(time.perf_counter() - t0) * 1e3]
        launches = read_counters(kernels)
        peak = torch.cuda.max_memory_allocated()
        one = {"int8_quant": len(demoted[name]), "flash_attention": flash,
               "gla_scan": 0}
        if t is None:
            equal = same_state(torch, got, want) and \
                torch.equal(met["loss"], wmet["loss"])
            against = "the flat step"
        else:
            expect, eloss = hier_composition(torch, ref, tiered, step_mod,
                                             model, opt, state0, b0, t, 0)
            equal = same_state(torch, got, expect) and \
                torch.equal(met["loss"], eloss)
            against = "the flat gradients through the plain quantizer"
            del expect
        print(f"  {label}: loss {float(met['loss'])!r}, bitwise equal to "
              f"{against}: {equal}; launches {launches} (expected {one}); "
              f"peak {peak / 2 ** 30:.3f} GiB ({start / 2 ** 30:.3f} GiB "
              f"before)")
        if not equal:
            fail(f"{label}: differs from {against}")
        if launches != one:
            fail(f"{label}: launches {launches}, expected {one}")
        if t is None:
            del want
        state = got
        del got
        with compat.set_mesh(pod):
            for i in range(1, HIER_STEPS):
                b = dev_batch(i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, b, i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if not math.isfinite(float(met["loss"])):
                    fail(f"{label}: non-finite loss at step {i}")
            prof = profile_call(torch, lambda: step(state, b0, 0), label) \
                if name == "mixed" else None
        del state
        torch.cuda.empty_cache()
        print(f"  {label} step ms {ms}")
        info.update(step_ms=ms, peak_bytes=peak, start_bytes=start,
                    launches=launches, launches_per_step=one, equal=equal,
                    loss=float(met["loss"]), profile=prof)
        out["tiers"][name] = info
    return out


def run_cloud(torch, api, cnn, kernels, sharding, data) -> dict:
    """``Plan.step_fn(cloud_mesh=...)`` on the AlexNet E=2 tree of phase 8
    (B=64, int8 wire) over a one-rank ``("data",)`` mesh against the same
    plan's step without it, from the same params and batch under cuDNN's
    deterministic algorithms: bitwise equal, or else within the
    reference test's tolerances; the same launches; the divisibility
    guard; the ms of both steps."""
    label = "tree E=2 cloud_mesh"
    p = api.plan(cnn.alexnet(), tree_fleet(api, 2), B)
    params = p.init_params(seed=SEED)
    x, y = batch(torch)
    steps = {"plain": p.step_fn(lr=LR),
             "cloud_mesh": p.step_fn(lr=LR, cloud_mesh=data)}
    res, launches = {}, {}
    for k, fn in steps.items():
        zero_counters(kernels)
        res[k] = fn(params, x, y)
        torch.cuda.synchronize()
        launches[k] = read_counters(kernels)
    (want, wl), (got, gl) = res["plain"], res["cloud_mesh"]
    pairs = [(u, v) for q, r in zip(got, want)
             for (_, u), (_, v) in zip(leaves(q), leaves(r))]
    bitwise = torch.equal(gl, wl) and all(torch.equal(u, v)
                                          for u, v in pairs)
    loss_rel = abs(float(gl) - float(wl)) / abs(float(wl))
    worst = max(float(((u - v).abs() - CLOUD_RTOL * v.abs()).max())
                for u, v in pairs)
    print(f"  {label}: {p.schedule}; loss {float(gl)!r} vs {float(wl)!r}; "
          f"bitwise {bitwise}; loss rel {loss_rel!r}; params worst "
          f"|d| - rtol |v| {worst!r}; launches {launches}")
    if not bitwise and (loss_rel > CLOUD_LOSS_RTOL or worst > CLOUD_ATOL):
        fail(f"{label}: differs from the step without cloud_mesh beyond "
             f"the reference's tolerances")
    if launches["plain"] != launches["cloud_mesh"]:
        fail(f"{label}: launches {launches}")
    try:
        p.step_fn(lr=LR, cloud_mesh=sharding.MeshShape((3,), ("data",)))(
            params, x, y)
    except ValueError as e:
        guard = str(e)
    else:
        fail(f"{label}: a 3-shard mesh over B={B} did not raise")
    if "divisible" not in guard:
        fail(f"{label}: the guard said {guard!r}")
    print(f"  {label}: guard on a 3-shard mesh: {guard}")
    ms = {k: [] for k in steps}
    for _ in range(TIMED_STEPS):
        for k, fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, x, y)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t0) * 1e3)
    print(f"  {label} step ms {ms}")
    return {"plan": str(p.schedule), "bitwise": bitwise,
            "wire_rows": sorted(wire_rows(p.multi_schedule)),
            "loss_rel": loss_rel, "params_worst": worst,
            "launches": launches["cloud_mesh"],
            "launches_per_step": launches["cloud_mesh"], "step_ms": ms,
            "guard": guard}


def run_distrib(torch, kernels, tmp: Path, **mods) -> dict:
    """Phase 13 on a one-rank NCCL group (a ``FileStore`` under ``tmp``),
    destroyed at the end."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        pod = init_device_mesh("cuda", (1,), mesh_dim_names=("pod",))
        data = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        print(f"  process group: {dist.get_backend()} world "
              f"{dist.get_world_size()}; meshes {pod} {data}")
        with deterministic(torch):
            hier = run_hier(torch, kernels, pod=pod, **mods["hier"])
        with deterministic(torch, algorithms=False):
            cloud = run_cloud(torch, kernels=kernels, data=data,
                              **mods["cloud"])
    finally:
        dist.destroy_process_group()
    return {"hier": hier, "cloud": cloud}


# ---------------------------------------------------------------------------
# Phase 14: launch/ — the meta-device dry run, against the card.
# ---------------------------------------------------------------------------

# (a) the dry run's cells, one process each (all started together, while
# (b) and (c) run): the CLI's arguments.
DRYRUN_CELLS = (
    ("--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh", "single"),
    ("--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh", "multi"),
    ("--arch", "qwen2.5-3b", "--shape", "train_4k", "--mesh", "multi",
     "--hier"),
    ("--arch", "grok-1-314b", "--shape", "decode_32k", "--mesh", "both"),
    ("--arch", "zamba2-7b", "--shape", "long_500k", "--mesh", "both"),
    ("--arch", "qwen2-moe-a2.7b", "--shape", "train_4k", "--mesh", "single"),
)
DRYRUN_TIMEOUT = 300
# (b) phase 13's flat step: the traced peak against the card's within
# DRYRUN_PEAK, the card's counted FLOPs DRYRUN_FLOPS of the traced count
# (flash's forward, opaque on the card, is counted on meta: 1 % of this
# step); DRYRUN_STEPS timed steps.
DRYRUN_PEAK, DRYRUN_FLOPS, DRYRUN_STEPS = (0.5, 2.0), (0.9, 1.0), 5
# (c) the FLOP cross-check's bands (tests/test_lm_layerstack.py:195-201),
# one block of each fleet stack of benchmarks/fig_lm_fleet.py:51-63 at
# T=LM_T, per sample of CROSS_B.
CROSS_BANDS = {"mamba2": (0.9, 1.1), "moe": (0.6, 1.4), "mlstm": (0.9, 1.1)}
CROSS_B = 2


def start_dryruns(root: Path, out: Path) -> list:
    """Starts one ``python -m repro_torch.launch.dryrun`` per
    ``DRYRUN_CELLS`` entry (CPU only: the meta device and the fake
    backend), each writing its records under ``out``."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, args in enumerate(DRYRUN_CELLS):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
               "--out", str(out / f"cells{i}.json")]
        procs.append((args, subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_dryruns(procs, out: Path) -> list:
    """Waits for :func:`start_dryruns`' processes; every record must be
    ``OK`` with finite, positive compute and memory terms (and a positive
    collective term where the step syncs over the pod axis)."""
    records = []
    for i, (args, p) in enumerate(procs):
        log = p.communicate(timeout=DRYRUN_TIMEOUT)[0]
        if p.returncode != 0:
            print(log)
            fail(f"dry run {' '.join(args)} exited {p.returncode}")
        with open(out / f"cells{i}.json") as f:
            records += json.load(f)
    for r in records:
        tag = f"{r['arch']} x {r['shape']} x " \
              f"{'x'.join(map(str, r.get('mesh', {}).values()))}" \
              f"{' [hier]' if r.get('hier') else ''}"
        if r["status"] != "OK":
            fail(f"dry run {tag}: {r['status']} {r.get('error')}")
        roof, mem = r["roofline"], r["memory"]
        terms = ("compute_s", "memory_s") + \
            (("collective_s",) if r["hier"] else ())
        if not all(math.isfinite(roof[k]) and roof[k] > 0 for k in terms):
            fail(f"dry run {tag}: roofline {roof}")
        print(f"  dry run {tag}: trace {r['trace_s']} s, peak "
              f"{mem['peak_gb']:.2f} GB a rank (fits 80 GB: "
              f"{mem['fits_80gb']}), sharded state "
              f"{mem['sharded_state_gb']:.2f} GB a device; compute / "
              f"memory / collective {roof['compute_s']} / "
              f"{roof['memory_s']} / {roof['collective_s']} s, "
              f"{roof['dominant']}; useful {roof['useful_ratio']}; "
              f"collectives {r['collectives']['counts']}"
              + (f"; tiers {r['tiers']}" if r.get("tiers") else ""))
    return records


def dryrun_vs_card(torch, kernels, lm_model, optim, train, dryrun,
                   make_batch_fn, shape, cfg) -> dict:
    """Phase 13's flat step (``make_train_step``, AdamW, B x T tokens)
    traced on meta by ``dryrun.measure``, then run once on the card under
    the same counter from the seeded state, then timed: the peaks, the
    FLOPs, the roofline terms beside the measured median step."""
    label = f"{cfg.name} flat step"
    model = lm_model.build_model(cfg)
    opt = optim.AdamW(lr=HIER_LR)
    meta_params = model.init(torch.Generator(), "meta")
    model_flops = dryrun._model_flops(cfg, shape, dryrun._active_params(
        cfg, meta_params))
    meta_batch = {k: torch.empty((shape.global_batch, shape.seq_len),
                                 dtype=torch.int32, device="meta")
                  for k in ("tokens", "targets")}
    step = train.make_train_step(model, opt)
    zero_counters(kernels)
    traced = dryrun.measure(dryrun.Program(step, (
        {"params": meta_params, "opt": opt.init(meta_params)}, meta_batch,
        0)), model_flops=model_flops)
    if any(read_counters(kernels).values()):
        fail(f"{label}: the meta trace counted launches "
             f"{read_counters(kernels)}")
    state0 = train.init_state(model, opt, torch.Generator(
        device="cuda").manual_seed(SEED), "cuda")
    dev = next(leaves(state0["params"]))[1].device
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             make_batch_fn(cfg, shape, seed=BATCH_SEED)(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(kernels)
    card = dryrun.measure(dryrun.Program(step, (state0, batch, 0)),
                          model_flops=model_flops)
    torch.cuda.synchronize()
    launches = read_counters(kernels)
    peak = torch.cuda.max_memory_allocated()
    expect = {"int8_quant": 0, "gla_scan": 0,
              "flash_attention": flat_launches(cfg)["flash_attention"]}
    if launches != expect:
        fail(f"{label}: launches {launches}, expected {expect}")
    ms = []
    for _ in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state0, batch, 0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        del out
    del state0
    torch.cuda.empty_cache()
    med = statistics.median(ms[1:])
    roof = traced["roofline"]
    flops = (traced["xla_cost"]["flops_per_dev"],
             card["xla_cost"]["flops_per_dev"])
    peaks = (traced["memory"]["peak_gb"] * 1e9 / 2 ** 30, peak / 2 ** 30)
    bound_ms = max(roof["compute_s"], roof["memory_s"]) * 1e3
    mfu = model_flops / (med / 1e3 * H100_BF16_FLOP_PER_S)
    print(f"  {label}: peak GiB traced on meta {peaks[0]:.3f}, card "
          f"max_memory_allocated {peaks[1]:.3f} (the counter's own on the "
          f"card {card['memory']['peak_gb'] * 1e9 / 2 ** 30:.3f}); FLOPs "
          f"traced {flops[0]:.6e}, counted on the card {flops[1]:.6e} "
          f"({flops[1] / flops[0]:.4f}; {launches['flash_attention']} flash "
          f"launches the card's count cannot see); bytes traced "
          f"{traced['xla_cost']['bytes_per_dev']:.6e}, on the card "
          f"{card['xla_cost']['bytes_per_dev']:.6e}")
    print(f"  {label}: compute_s {roof['compute_s']} memory_s "
          f"{roof['memory_s']} ({roof['dominant']}), bound {bound_ms:.3f} ms, "
          f"against the measured median step {med:.3f} ms (steps {ms}); "
          f"model_flops {model_flops:.6e}, model_flops / (ms x 989e12) = "
          f"{mfu:.4f}; trace {traced['trace_s']} s, counted card step "
          f"{card['trace_s']} s")
    if not DRYRUN_PEAK[0] <= peaks[0] / peaks[1] <= DRYRUN_PEAK[1]:
        fail(f"{label}: traced peak / card peak {peaks[0] / peaks[1]}")
    if not DRYRUN_FLOPS[0] <= flops[1] / flops[0] <= DRYRUN_FLOPS[1]:
        fail(f"{label}: card FLOPs / traced {flops[1] / flops[0]}")
    return {"traced": traced, "card": card, "card_peak_bytes": peak,
            "step_ms": ms, "median_ms": med, "bound_ms": bound_ms,
            "model_flops": model_flops, "mfu": mfu, "launches": launches,
            "launches_per_step": expect}


def crosscheck_fleets(torch, lm_layerstack, crosscheck_flops,
                      fleet_configs, device: str = "cuda") -> dict:
    """``crosscheck_flops`` on the card for cut 1 of each fleet stack
    (``"ref"`` backend), held to the reference's band."""
    out = {}
    for cfg in (fleet_configs.FLEET_GLA, fleet_configs.FLEET_MOE,
                fleet_configs.FLEET_XLSTM):
        stack = lm_layerstack(cfg, LM_T)
        kind = stack.block_kinds[1]
        analytic, counted = crosscheck_flops(stack, 1, CROSS_B, device)
        lo, hi = CROSS_BANDS[kind]
        ratio = analytic / counted
        print(f"  crosscheck {cfg.name} block 1 ({kind}): analytic "
              f"{analytic:.6e}, counted on the card {counted:.6e} a sample, "
              f"ratio {ratio:.4f} (band {lo}-{hi})")
        if not lo <= ratio <= hi:
            fail(f"crosscheck {cfg.name}: ratio {ratio} outside {lo}-{hi}")
        out[cfg.name] = {"kind": kind, "analytic": analytic,
                         "counted": counted, "ratio": ratio}
        torch.cuda.empty_cache()
    return out


def run_launch(torch, kernels, root: Path, cfg, shape) -> dict:
    """Phase 14: (a)'s processes started first, (b) and (c) on the card
    while they run, then (a)'s records; the phase's seconds."""
    from repro_torch import optim, train
    from repro_torch.data.pipeline import make_lm_batch_fn
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import fleet_configs
    from repro_torch.models.lm import model as lm_model
    from repro_torch.models.lm.layerstack import (crosscheck_flops,
                                                  lm_layerstack)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = start_dryruns(root, Path(tmp))
        try:
            vs_card = dryrun_vs_card(torch, kernels, lm_model, optim, train,
                                     dryrun, make_lm_batch_fn, shape, cfg)
            cross = crosscheck_fleets(torch, lm_layerstack, crosscheck_flops,
                                      fleet_configs)
            cells = finish_dryruns(procs, Path(tmp))
        finally:
            for _, p in procs:
                p.kill()
    out = {"cells": cells, "vs_card": vs_card, "crosscheck": cross,
           "phase_s": time.perf_counter() - t0}
    print(f"  launch/ phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 15: analysis/ — the port's static gate, against the card.
# ---------------------------------------------------------------------------

# Sentinels on either side of each output of (c): a multiple of 128 bytes,
# so a view inside the buffer keeps TMA's 16-byte alignment.
GUARD_BYTES = 256
# (c)'s ragged extents.  The quantizer: (dtype, m, n), m odd and n no
# multiple of plan_slices' slice.  Flash: (dtype, BH, BKV, n_q = S, hd,
# causal).  The GLA: (name, dtype, BH, n_t, dk, dv, W, normalize, draw),
# one row per kernel dispatch picks (narrow and wide tensor-core, CUDA
# cores), each n_t no multiple of W.
RAGGED_QUANT = (("f32", 37, 50003), ("bf16", 5, 4099))
RAGGED_FLASH = (("bf16", 4, 2, 1000, 64, True),
                ("bf16", 4, 2, 1000, 128, True),
                ("f32", 4, 2, 1000, 64, False))
RAGGED_GLA = (
    ("narrow_bf16_8_1000_64_W128", "bf16", 8, 1000, 64, 64, 128, False,
     "mamba2"),
    ("wide_bf16_4_300_256_W128", "bf16", 4, 300, 256, 256, 128, True,
     "mlstm"),
    ("f32_4_1000_64x72_W128", "f32", 4, 1000, 64, 72, 128, False, "mamba2"),
)


def run_gate(root: Path) -> dict:
    """(a) ``python -m repro_torch.analysis --check-baseline`` in a
    subprocess; fails unless it exits 0.  Returns its summary."""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--check-baseline", "--json", "-"], cwd=str(root),
                         env=env, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"python -m repro_torch.analysis --check-baseline exited "
             f"{out.returncode}:\n{out.stdout[-4000:]}{out.stderr[-4000:]}")
    summary = json.loads(out.stdout)["summary"]
    print(f"  python -m repro_torch.analysis --check-baseline: {summary}")
    return summary


def check_sass_accumulators(root: Path, sass: dict) -> dict:
    """(b) Each library's SASS (``sass``: phase 2's listings) against the
    MMA sites the static RA503 check finds in its source: every HMMA /
    HGMMA accumulates in F32, and every ``wgmma`` / ``mma.sync`` shape
    there was emitted."""
    from repro_torch.analysis.base import SourceFile
    from repro_torch.analysis.cuda_checks import check_sass, mma_sites
    rows = {}
    for name, listing in sorted(sass.items()):
        rel = f"src/repro_torch/kernels/csrc/{name}.cu"
        sites = mma_sites(SourceFile(rel, (root / rel).read_text()).lexed)
        n, problems = check_sass(sites, listing)
        rows[name] = {"sites": len(sites), "instructions": n,
                      "problems": problems}
        print(f"  {name}: {len(sites)} MMA sites in the source, {n} HMMA / "
              f"HGMMA in the SASS, all F32 and every site emitted: "
              f"{not problems}")
        if problems:
            fail(f"{name}: the SASS breaks RA503: {problems}")
    if not all(rows[n]["sites"] and rows[n]["instructions"]
               for n in ("flash_attention", "gla_scan")):
        fail(f"no MMA site or no tensor-core instruction where the "
             f"tensor-core kernels live: {rows}")
    return rows


def guarded(torch, shape, dtype, dev) -> tuple:
    """``(buffer, view)``: a tensor of ``shape`` inside a buffer that holds
    ``GUARD_BYTES`` more on either side, every element a sentinel the
    kernels never write (NaN; -128 in int8, outside the codes'
    [-127, 127])."""
    g = GUARD_BYTES // torch.empty((), dtype=dtype).element_size()
    n = math.prod(shape)
    fill = -128 if dtype == torch.int8 else float("nan")
    buf = torch.full((g + n + g,), fill, dtype=dtype, device=dev)
    return buf, buf[g:g + n].view(shape)


def check_guarded(torch, case: str, outs: dict) -> dict:
    """Per output of ``outs`` (``{label: (buffer, view)}`` from
    :func:`guarded`, after the launch): the elements of the view still
    the sentinel and the guard elements no longer bitwise the sentinel.
    Fails unless both are 0 for every output."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
            torch.int8: torch.int8}
    report = {}
    for label, (buf, view) in outs.items():
        g = (buf.numel() - view.numel()) // 2
        as_int = ints[buf.dtype]
        sentinel = guarded(torch, (1,), buf.dtype, buf.device)[1]
        unwritten = view == -128 if buf.dtype == torch.int8 \
            else torch.isnan(view)
        guard = torch.cat([buf[:g], buf[g + view.numel():]])
        touched = guard.view(as_int) != sentinel.view(as_int)
        report[label] = {"unwritten": int(unwritten.sum()),
                         "guard_touched": int(touched.sum())}
        if report[label]["unwritten"] or report[label]["guard_touched"]:
            fail(f"{case}: {label} {tuple(view.shape)} left "
                 f"{report[label]['unwritten']} elements unwritten and "
                 f"wrote {report[label]['guard_touched']} guard elements")
    return report


def ragged_quantizer(torch, iq, ref, g, stream) -> dict:
    """Both C entries of the quantizer at ``RAGGED_QUANT``, bitwise."""
    quant, wire, _ = iq._kernels()
    dev, rows = g.device, {}
    for dt, m, n in RAGGED_QUANT:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        bf16 = int(dtype == torch.bfloat16)
        x = (3.0 * torch.randn(m, n, generator=g, device=dev)).to(dtype)
        u = torch.rand(m, n, generator=g, device=dev)
        S, slice_elems = iq.plan_slices(m, n, x.element_size())
        if m % 2 == 0 or n % slice_elems == 0:
            fail(f"RAGGED_QUANT {dt} {m}x{n} is not ragged: slice "
                 f"{slice_elems}")
        outs = {"q": guarded(torch, (m, n), torch.int8, dev),
                "scale": guarded(torch, (m,), torch.float32, dev),
                "partial": guarded(torch, (m, S), torch.float32, dev),
                "wire_out": guarded(torch, (m, n), dtype, dev),
                "wire_partial": guarded(torch, (m, S), torch.float32, dev)}
        (_, q), (_, scale), (_, part), (_, out), (_, wpart) = outs.values()
        errs = (quant(x.data_ptr(), bf16, u.data_ptr(), 0.0, q.data_ptr(),
                      scale.data_ptr(), part.data_ptr(), m, n, S,
                      slice_elems, stream),
                wire(x.data_ptr(), bf16, out.data_ptr(), wpart.data_ptr(), m,
                     n, S, slice_elems, stream))
        torch.cuda.synchronize()
        name = f"int8_quant_{dt}_{m}x{n}"
        if any(errs):
            fail(f"{name}: CUDA errors {errs}")
        guards = check_guarded(torch, name, outs)
        q_r, s_r = ref.ref_quantize_int8(x, u)
        equal = same_bits(torch, q, q_r) and same_bits(torch, scale, s_r) \
            and same_bits(torch, out, ref.ref_wire_qdq_int8(x))
        rows[name] = {"slices": S, "slice_elems": slice_elems,
                      "equal": equal, "outputs": guards}
        print(f"  {name:34s} S={S} slice {slice_elems}: every output whole, "
              f"guards untouched; bitwise equal {equal}")
        if not equal:
            fail(f"{name}: disagrees with the plain quantizer")
    return rows


def ragged_flash(torch, fa, ref, g, stream) -> dict:
    """The flash C entry at ``RAGGED_FLASH`` under the TOL rule."""
    fn, dev, rows = fa._kernel(), g.device, {}
    for dt, BH, BKV, T, hd, causal in RAGGED_FLASH:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q = torch.randn(BH, T, hd, generator=g, device=dev).to(dtype)
        k = torch.randn(BKV, T, hd, generator=g, device=dev).to(dtype)
        v = torch.randn(BKV, T, hd, generator=g, device=dev).to(dtype)
        outs = {"o": guarded(torch, (BH, T, hd), dtype, dev),
                "lse": guarded(torch, (BH, T), torch.float32, dev)}
        (_, o), (_, lse) = outs.values()
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), int(dtype == torch.bfloat16), BH, BKV, T, T,
                 hd, int(causal), 0, 1.0 / hd ** 0.5, stream)
        torch.cuda.synchronize()
        name = f"flash_{dt}_{BH}x{T}_{hd}{'_causal' if causal else ''}"
        if err:
            fail(f"{name}: CUDA error {err}")
        guards = check_guarded(torch, name, outs)
        o_r, lse_r = ref.ref_flash_attention(q, k, v, causal=causal)
        ok_o, err_o, ex_o = tol_check(torch, "flash_o", o, o_r, dtype)
        ok_l, err_l, ex_l = tol_check(torch, "flash_lse", lse, lse_r, dtype)
        rows[name] = {"ok": ok_o and ok_l, "o_err_over_tol": ex_o,
                      "lse_err_over_tol": ex_l, "outputs": guards}
        print(f"  {name:34s} every output whole, guards untouched; o "
              f"{ex_o:.3f} and lse {ex_l:.3f} of the TOL")
        if not rows[name]["ok"]:
            fail(f"{name}: disagrees with the plain version")
    return rows


def ragged_gla(torch, gs, ref, g, stream) -> dict:
    """The GLA C entry at ``RAGGED_GLA`` under the TOL rule."""
    fn, dev, rows = gs._kernel(), g.device, {}
    for name, dt, BH, T, dk, dv, W, normalize, draw in RAGGED_GLA:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v, a = gla_inputs(torch, g, BH, T, dk, dv, dtype, draw)
        outs = {"y": guarded(torch, (BH, T, dv), dtype, dev),
                "S": guarded(torch, (BH, dk, dv), torch.float32, dev),
                "n": guarded(torch, (BH, dk), torch.float32, dev)}
        (_, y), (_, S), (_, n) = outs.values()
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
                 y.data_ptr(), S.data_ptr(), n.data_ptr(),
                 int(dtype == torch.bfloat16), BH, T, dk, dv, W,
                 int(normalize), stream)
        torch.cuda.synchronize()
        kernel = gla_kernel(dtype == torch.bfloat16, dk, dv)
        if err:
            fail(f"{name}: CUDA error {err}")
        guards = check_guarded(torch, name, outs)
        y_r, S_r, n_r = ref.ref_gla(q, k, v, a, normalize=normalize)
        checks = [tol_check(torch, "gla_y", y, y_r, dtype),
                  tol_check(torch, "gla_state", S, S_r, dtype),
                  tol_check(torch, "gla_state", n, n_r, dtype)]
        rows[name] = {"kernel": kernel, "ok": all(c[0] for c in checks),
                      "err_over_tol": [c[2] for c in checks],
                      "outputs": guards}
        print(f"  {name:34s} ({kernel}) every output whole, guards "
              f"untouched; y, S, n at "
              f"{', '.join(f'{c[2]:.3f}' for c in checks)} of the TOL")
        if not rows[name]["ok"]:
            fail(f"{name}: disagrees with the plain version")
    return rows


def run_analysis(torch, kernels, ref, root: Path, sass: dict) -> dict:
    """Phase 15: (a) the gate, (b) RA503 against the SASS, (c) every
    kernel entry at ragged extents inside guard bands; the phase's
    seconds."""
    t0 = time.perf_counter()
    gate = run_gate(root)
    accumulators = check_sass_accumulators(root, sass)
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    stream = torch.cuda.current_stream().cuda_stream
    ragged = {**ragged_quantizer(torch, kernels["int8_quant"], ref, g,
                                 stream),
              **ragged_flash(torch, kernels["flash_attention"], ref, g,
                             stream),
              **ragged_gla(torch, kernels["gla_scan"], ref, g, stream)}
    out = {"gate": gate, "sass": accumulators, "ragged": ragged,
           "phase_s": time.perf_counter() - t0}
    print(f"  analysis/ phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the dense train step partitioned over DTensor.
# ---------------------------------------------------------------------------

# phase 13's flat step through ``partitioned_step`` on a (1, 1) mesh:
# PART_STEPS steps checked against the flat step, then PART_TIMED timed
BF16_LOSS_RTOL = 2.0 ** -8   # tests/test_torch_train_int8_lm.py
PART_STEPS, PART_TIMED = 3, 2


def drive(torch, kernels, step, state, batches, kept=None,
          keep=lambda state: state) -> dict:
    """``PART_STEPS`` checked steps of ``step`` from ``state`` (each one's
    loss and launches; given ``kept``, each under ``CommDebugMode``, its
    collectives by type and ``kept(state)`` after it), then
    ``PART_TIMED`` timed steps; the peak over all of them, and above the
    bytes allocated before them (what the steps themselves add: the
    caller may hold other states).  Returns ``keep`` of the state after
    the checked steps as ``state`` (``keep`` may copy it to the host)."""
    from torch.distributed.tensor.debug import CommDebugMode
    out = {"losses": [], "launches": [], "comms": [], "kept": [],
           "check_ms": [], "step_ms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    checked = None
    for i, b in enumerate(batches):
        timed = i >= PART_STEPS
        mode = CommDebugMode() if kept and not timed else \
            contextlib.nullcontext()
        zero_counters(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mode:
            state, met = step(state, b, i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if timed:
            out["step_ms"].append(ms)
            continue
        out["check_ms"].append(ms)
        out["losses"].append(met["loss"])
        out["launches"].append(read_counters(kernels))
        if kept:
            out["comms"].append({str(k): v for k, v in
                                 mode.get_comm_counts().items()})
            out["kept"].append(kept(state))
        if i == PART_STEPS - 1:
            checked = keep(state)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["added_bytes"] = out["peak_bytes"] - start
    out["state"] = checked
    return out


def run_partition(torch, kernels, tmp: Path, lm_model, optim, train,
                  make_batch_fn, shape, cfg, configs) -> dict:
    """Phase 16 on a one-rank NCCL group (a ``FileStore`` under ``tmp``),
    destroyed at the end: phase 13's flat step (``make_train_step``,
    AdamW, B x T) through ``distrib.partition.partitioned_step`` on a
    ``(data, model)`` mesh of (1, 1) at ``fsdp=False`` and ``True``, from
    the seeded state under deterministic algorithms, against the
    unpartitioned step: the losses and final state bitwise equal (or the
    first leaf that differs printed and each loss held to one bf16
    rounding), flash launched as the layers imply every step, every
    leaf's placements kept, ``CommDebugMode``'s collectives per step by
    type; step ms beside the flat step's and the peak.  Then, on the same
    group and mesh, each of ``PART_FAMILIES``
    (:func:`run_partition_family`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distrib import partition, sharding
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        model = lm_model.build_model(cfg)
        opt = optim.AdamW(lr=HIER_LR)
        state0 = train.init_state(model, opt, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")
        batch_fn = make_batch_fn(cfg, shape, seed=BATCH_SEED)
        batches = [{k: torch.as_tensor(v, device="cuda")
                    for k, v in batch_fn(i).items()}
                   for i in range(PART_STEPS + PART_TIMED)]
        one = {"int8_quant": 0, "gla_scan": 0,
               "flash_attention": flat_launches(cfg)["flash_attention"]}
        step = train.make_train_step(model, opt)
        with deterministic(torch):
            flat = drive(torch, kernels, step, state0, batches)
        want = dict(leaves(flat.pop("state")))
        print(f"  {cfg.name} flat: losses "
              f"{[float(x) for x in flat['losses']]}; step ms "
              f"{flat['step_ms']}; peak {flat['peak_bytes'] / 2 ** 30:.3f} "
              f"GiB ({flat['added_bytes'] / 2 ** 30:.3f} above the start); "
              f"launches {flat['launches']}")
        out = {"mesh": str(mesh), "flat": {
            k: v for k, v in flat.items() if k != "losses"}}
        out["flat"]["losses"] = [float(x) for x in flat["losses"]]
        for fsdp in (False, True):
            label = f"{cfg.name} partitioned fsdp={fsdp}"
            shard = {"params": sharding.param_shardings(
                mesh, state0["params"], fsdp), "opt":
                sharding.opt_state_shardings(mesh, state0["opt"], fsdp)}
            pstep = partition.partitioned_step(
                step, mesh, shard, sharding.batch_shardings(mesh,
                                                            batches[0]))
            placed = dict(leaves(shard))

            def kept(state):
                return all(tuple(placed[k]) == x.placements
                           for k, x in leaves(state))
            with deterministic(torch):
                run = drive(torch, kernels, pstep, partition.distribute_tree(
                    state0, mesh, shard), batches, kept=kept)
            got = dict(leaves(run.pop("state")))
            differs = [k for k in want if not torch.equal(
                got[k].to_local(), want[k])]
            losses = [float(x) for x in run["losses"]]
            bitwise = not differs and all(torch.equal(a, b) for a, b in zip(
                run["losses"], flat["losses"]))
            worst = max(abs(a - b) / abs(b) for a, b in
                        zip(losses, out["flat"]["losses"]))
            why = "" if bitwise else \
                f" (first leaf differing {differs[:1]}, loss rel {worst!r})"
            print(f"  {label}: losses {losses}; bitwise the flat step: "
                  f"{bitwise}{why}; placements kept {run['kept']}; launches "
                  f"{run['launches']} (expected {one} a step); collectives "
                  f"a step {run['comms']}; step ms {run['step_ms']} "
                  f"(checked steps, under CommDebugMode, {run['check_ms']}); "
                  f"peak {run['peak_bytes'] / 2 ** 30:.3f} GiB "
                  f"({run['added_bytes'] / 2 ** 30:.3f} above the start)")
            if not bitwise and worst > BF16_LOSS_RTOL:
                fail(f"{label}: loss {worst!r} from the flat step's, past "
                     f"one bf16 rounding")
            if not all(run["kept"]):
                fail(f"{label}: a leaf's placements changed")
            if run["launches"] != [one] * PART_STEPS:
                fail(f"{label}: launches {run['launches']}, expected {one} "
                     f"a step")
            del got
            torch.cuda.empty_cache()
            out[f"fsdp_{fsdp}"] = dict(
                run, losses=losses, bitwise=bitwise, differs=differs[:8],
                loss_rel=worst, launches_per_step=one,
                launches={n: sum(c[n] for c in run["launches"])
                          for n in one})
        del want, state0
        torch.cuda.empty_cache()
        for arch, cut in PART_FAMILIES:
            out[arch] = run_partition_family(
                torch, kernels, mesh, lm_model, optim, train, partition,
                sharding, make_batch_fn, configs.get_arch(arch).lm.variant(
                    use_flash=True, use_gla_kernel=True, **cut), cut)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return out


# Phase 16's other families: each at its published widths, bf16, cut in
# depth only: zamba2-7b to one group (6 Mamba2 layers and the shared
# block), qwen2-moe-a2.7b to 2 of 24 layers (groups of 1,024 tokens, as
# published), xlstm-350m to 8 of 24 (7 mLSTM blocks and 1 sLSTM),
# whisper-base whole.  B x T = PART_B x PART_T, whisper's frames and
# tokens both T long (make_lm_batch_fn).  fsdp=True only.
PART_FAMILIES = (("zamba2-7b", {"n_layers": 6, "shared_attn_every": 6}),
                 ("qwen2-moe-a2.7b", {"n_layers": 2}),
                 ("xlstm-350m", {"n_layers": 8}),
                 ("whisper-base", {}))
PART_B, PART_T = 4, 512


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in leaves(tree))


def on_host(torch, state) -> dict:
    """Each leaf of a state (plain, or a DTensor's local shard) copied to
    the host, by path: a state the card need not hold while the next
    steps run."""
    from repro_torch.device import is_dtensor
    return {k: (x.to_local() if is_dtensor(x) else x).cpu()
            for k, x in leaves(state)}


def run_partition_family(torch, kernels, mesh, lm_model, optim, train,
                         partition, sharding, make_batch_fn, cfg, cut
                         ) -> dict:
    """One family's flat step (``make_train_step``, AdamW, ``PART_B`` x
    ``PART_T``) and the same step through ``partitioned_step`` at
    ``fsdp=True`` on ``mesh``, each from the seeded state (drawn anew for
    each run, so that the card holds one) under deterministic
    algorithms: the losses and the state after the checked steps bitwise
    equal (or the first leaf that differs printed and each loss held to
    one bf16 rounding), flash and GLA launched ``flat_launches(cfg)``
    times a step by both runs, every leaf's placements kept, the
    collectives a step by type; the bytes reckoned before the runs
    beside the measured peaks, step ms beside the flat step's, and the
    seconds the whole took."""
    from repro_torch.configs.base import ShapeSpec
    t0 = time.perf_counter()
    label = f"{cfg.name} {cut or 'whole'}"
    model = lm_model.build_model(cfg)
    opt = optim.AdamW(lr=HIER_LR)

    def fresh():
        return train.init_state(model, opt, torch.Generator(
            device="cuda").manual_seed(SEED), "cuda")
    shapes = train.init_state(model, opt, torch.Generator(), "meta")
    batch_fn = make_batch_fn(cfg, ShapeSpec("part", PART_T, PART_B, "train"),
                             seed=BATCH_SEED)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in batch_fn(i).items()}
               for i in range(PART_STEPS + PART_TIMED)]
    shard = {"params": sharding.param_shardings(mesh, shapes["params"],
                                                True),
             "opt": sharding.opt_state_shardings(mesh, shapes["opt"], True)}
    placed = dict(leaves(shard))
    # distribute_tensor copies a leaf it shards, even over a one-rank dim
    reckon = {"params": tree_bytes(shapes["params"]),
              "opt": tree_bytes(shapes["opt"]),
              "laid_out_copy": sum(
                  x.numel() * x.element_size() for k, x in leaves(shapes)
                  if any(p.is_shard() for p in placed[k]))}
    reckon["state"] = reckon["params"] + reckon["opt"]
    print(f"  {label}: bytes reckoned {reckon} (a state "
          f"{reckon['state'] / 2 ** 30:.3f} GiB; the card holds the "
          f"running state, its update and, while the partitioned run is "
          f"laid out, the copy; the checked states go to the host)")
    per_step = flat_launches(cfg)
    step = train.make_train_step(model, opt)
    with deterministic(torch):
        flat = drive(torch, kernels, step, fresh(), batches,
                     keep=lambda st: on_host(torch, st))
    want = flat.pop("state")
    flat["losses"] = [float(x) for x in flat["losses"]]
    torch.cuda.empty_cache()
    pstep = partition.partitioned_step(
        step, mesh, shard, sharding.batch_shardings(mesh, batches[0]))

    def kept(state):
        return all(tuple(placed[k]) == x.placements
                   for k, x in leaves(state))
    with deterministic(torch):
        run = drive(torch, kernels, pstep, partition.distribute_tree(
            fresh(), mesh, shard), batches, kept=kept,
            keep=lambda st: on_host(torch, st))
    got = run.pop("state")
    differs = [k for k in want if not torch.equal(got[k], want[k])]
    del got, want
    losses = [float(x) for x in run["losses"]]
    bitwise = not differs and losses == flat["losses"]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, flat["losses"]))
    why = "" if bitwise else \
        f" (first leaf differing {differs[:1]}, loss rel {worst!r})"
    seconds = time.perf_counter() - t0
    print(f"  {label} flat: losses {flat['losses']}; step ms "
          f"{flat['step_ms']}; peak {flat['peak_bytes'] / 2 ** 30:.3f} GiB; "
          f"launches {flat['launches']} (expected {per_step} a step)")
    print(f"  {label} partitioned fsdp=True: losses {losses}; bitwise the "
          f"flat step: {bitwise}{why}; placements kept {run['kept']}; "
          f"launches {run['launches']}; collectives a step {run['comms']}; "
          f"step ms {run['step_ms']} (checked steps, under CommDebugMode, "
          f"{run['check_ms']}); peak {run['peak_bytes'] / 2 ** 30:.3f} GiB "
          f"({run['added_bytes'] / 2 ** 30:.3f} above the start); "
          f"{seconds:.1f} s")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{label}: non-finite loss {losses}")
    if not bitwise and worst > BF16_LOSS_RTOL:
        fail(f"{label}: loss {worst!r} from the flat step's, past one bf16 "
             f"rounding")
    if not all(run["kept"]):
        fail(f"{label}: a leaf's placements changed")
    for name, r in (("flat", flat), ("partitioned", run)):
        if r["launches"] != [per_step] * PART_STEPS:
            fail(f"{label} {name}: launches {r['launches']}, expected "
                 f"{per_step} a step")
    return dict(run, losses=losses, bitwise=bitwise, differs=differs[:8],
                differing_params=[k for k in differs
                                  if k.startswith("params.")][:8],
                loss_rel=worst, launches_per_step=per_step,
                launches={n: sum(c[n] for c in run["launches"])
                          for n in per_step},
                flat=flat, reckon=reckon, seconds=seconds, reduced=cut)


def steady(ms):
    rest = sorted(ms[1:])
    return {"median": statistics.median(rest), "max": rest[-1],
            "n": len(rest), "first": ms[0]}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs only on the card")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch import api
    from repro_torch import configs
    from repro_torch import data as data_mod
    from repro_torch.checkpoint import store
    from repro_torch.configs import zamba2_7b
    from repro_torch.core import hybrid_step as hs
    from repro_torch.core import profiler
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gla_scan as gs
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.kernels import ref
    from repro_torch.models import cnn
    from repro_torch import optim
    from repro_torch import train
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import make_lm_batch_fn
    from repro_torch.distrib import compat, sharding
    from repro_torch.distrib import tiered_sync as tiered
    from repro_torch.models.lm import fleet_configs
    from repro_torch.models.lm import model as lm_model
    from repro_torch.models.lm.fleet_configs import FLEET_GLA
    from repro_torch.models.lm.layerstack import lm_layerstack
    from repro_torch.serve import engine
    from repro_torch.train import loop
    from repro_torch.train import step as step_mod
    kernels = {"int8_quant": iq, "flash_attention": fa, "gla_scan": gs}

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off: "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}")
    for name, rep in built.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    sass = {name: sass_listing(_build, name) for name in sorted(built)}
    tensor_cores = {}
    for name in ("flash_attention", "gla_scan"):
        print(f"{name} tensor-core use (cuobjdump -sass):")
        tensor_cores[name] = tensor_core_use(_build, built[name]["log"], name,
                                             sass[name])

    # 3. kernels vs plain versions
    t0 = time.perf_counter()
    alexnet_rows = alexnet_wire_rows(api, loop, cnn)
    print(f"AlexNet wire rows, from phases 4, 5 and 8's plans and loop "
          f"replays: {alexnet_rows} "
          f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    hcfg = hier_config(configs)
    sync_rows = hier_sync_rows(torch, lm_model, tiered, hcfg)
    print(f"tiered-sync rows of phase 13's int8 tiers: {sync_rows}")
    print("int8_quant, both entries, vs plain versions (bitwise):")
    qcases = check_quantizer(torch, iq, ref, alexnet_rows, sync_rows)
    print("flash_attention vs plain version (TOL rule):")
    fcases = check_flash(torch, fa, ref)
    print("gla_scan vs plain version (TOL rule):")
    gcases = check_gla(torch, gs, ref)

    print(f"kernel phase leaves {torch.cuda.memory_allocated()} bytes "
          f"allocated")

    # 4. AlexNet
    print("main path: AlexNet 224x224, B=64, wire=int8")
    runs = {m: run_plan(torch, api, kernels, cnn,
                        api.Fleet.from_table2("alexnet", m=m, wire="int8"),
                        f"M={m}") for m in (1, 4)}
    ref_gap = {m: check_reference(torch, hs, runs[m]) for m in (1, 4)}
    int8_gap = {m: check_int8_gap(torch, hs, runs[m]) for m in (1, 4)}
    for m, r in runs.items():
        print(f"  M={m} step ms {steady(r['step_ms'])}")

    # 5. AlexNet through Plan.train, cuDNN held to deterministic algorithms
    print(f"main path: AlexNet Plan.train, B={B}, wire=int8, "
          f"{TRAIN_STEPS} steps, lr {LR}")
    with deterministic(torch, algorithms=False):
        with tempfile.TemporaryDirectory() as tmp:
            train_runs = {m: run_train(
                torch, api, loop, store, hs, kernels, cnn, data_mod,
                api.Fleet.from_table2("alexnet", m=m, wire="int8"), m,
                Path(tmp)) for m in (1, 4)}
        print("measure_profile(alexnet()) on the card, B=64:")
        measured = check_measure_profile(torch, profiler, cnn,
                                         runs[1]["plan"])
    torch.cuda.empty_cache()

    # 6. LM fleet-gla
    print(f"main path: LM fleet-gla, T={LM_T}, B={LM_B}, wire=int8, "
          f"lr {LM_LR}")
    gla_stack = lm_layerstack(FLEET_GLA, LM_T, backend="cuda")
    lm_runs = {m: run_lm_fleet(torch, api, hs, kernels, gla_stack, m)
               for m in (1, 4)}
    for m, r in lm_runs.items():
        print(f"  fleet-gla M={m} step ms {steady(r['step_ms'])}")

    # 7. zamba2-7b, full width, one group deep
    z7cfg = zamba2_7b.FULL.variant(n_layers=6, shared_attn_every=6)
    print(f"main path: zamba2-7b widths, n_layers=6 + 1 attention block, "
          f"T={LM_T}, B={Z7_B}, lr {Z7_LR}")
    z7 = run_deep_cut(torch, api, kernels,
                      lm_layerstack(z7cfg, LM_T, backend="cuda"), Z7_B, Z7_LR,
                      Z7_STEPS, ("flash_attention", "gla_scan"))
    print(f"  zamba2-7b step ms {steady(z7['step_ms'])}")

    # 8. AlexNet on fig_tree's fleets: step_fn per E, then Plan.train
    print(f"main path: AlexNet on fig_tree's fleets (M=4, 2 Mbps backhaul "
          f"per edge, E in {TREE_EDGES}), B={B}, wire=int8")
    tree_runs, tree_info = {}, {}
    for e in TREE_EDGES:
        label = f"tree E={e}"
        tree_runs[e] = run_plan(torch, api, kernels, cnn, tree_fleet(api, e),
                                label, n_steps=TREE_STEPS)
        tree_info[e] = {"reference": check_reference(torch, hs, tree_runs[e]),
                        "int8_loss_gap": check_int8_gap(torch, hs,
                                                        tree_runs[e]),
                        **explain_plan(tree_runs[e]["plan"], label)}
    for e, r in tree_runs.items():
        print(f"  tree E={e} step ms {steady(r['step_ms'])}")
    with deterministic(torch, algorithms=False):
        tree_e1 = check_tree_e1_bitwise(torch, api, cnn)
        print(f"main path: AlexNet Plan.train on the E=2 tree, B={B}, "
              f"wire=int8, {TRAIN_STEPS} steps, lr {LR}")
        with tempfile.TemporaryDirectory() as tmp:
            tree_train = run_train(torch, api, loop, store, hs, kernels, cnn,
                                   data_mod, tree_fleet(api, 2), "tree E=2",
                                   Path(tmp))
    torch.cuda.empty_cache()

    # 9. serving: the published configs, full depth, through generate
    serve_runs = {}
    for arch in SERVE_ARCHS:
        print(f"main path: serving {arch} (published config, use_flash, "
              f"use_gla_kernel; reduced {SERVE_REDUCED.get(arch)}), "
              f"B={SERVE_B}, {SERVE_NEW} greedy new tokens")
        serve_runs[arch] = run_serve(torch, kernels, configs, lm_model,
                                     engine, arch)
        torch.cuda.empty_cache()

    # 10. hierarchical training for the moe and xlstm families
    print(f"main path: LM fleet-moe and fleet-xlstm (published configs), "
          f"T={LM_T}, B={LM_B}, M=4, wire=int8, lr {LM_LR}")
    fam_runs = {}
    for cfg in (fleet_configs.FLEET_MOE, fleet_configs.FLEET_XLSTM):
        fam_runs[cfg.name] = run_lm_fleet(
            torch, api, hs, kernels,
            lm_layerstack(cfg, LM_T, backend="cuda"), 4,
            gap_floor=cfg.name in GAP_FLOOR_STACKS)
    for name, r in fam_runs.items():
        print(f"  {name} M=4 step ms {steady(r['step_ms'])}")

    # 11. qwen2-moe-a2.7b, full width, 2 of 24 layers
    qcfg = configs.get_arch("qwen2-moe-a2.7b").lm.variant(**QM_REDUCED)
    print(f"main path: qwen2-moe-a2.7b widths, reduced {QM_REDUCED}, "
          f"T={QM_T}, B={QM_B}, lr {QM_LR}, head width {qcfg.hd}")
    if qcfg.hd != 128:
        fail(f"qwen2-moe-a2.7b: head width {qcfg.hd}, expected 128")
    qm = run_deep_cut(torch, api, kernels,
                      lm_layerstack(qcfg, QM_T, backend="cuda"), QM_B, QM_LR,
                      QM_STEPS, ("flash_attention",))
    print(f"  qwen2-moe-a2.7b step ms {steady(qm['step_ms'])}")

    # 12. xlstm-350m through make_train_step and run_train_loop
    xcfg = configs.get_arch("xlstm-350m").lm.variant(use_flash=True,
                                                      use_gla_kernel=True)
    print(f"main path: xlstm-350m (published config, full depth) through "
          f"make_train_step (AdamW, lr {FLAT_LR}) and run_train_loop, "
          f"B={FLAT_B}, T={FLAT_T}, remat {xcfg.remat}; deterministic "
          f"algorithms")
    with deterministic(torch), tempfile.TemporaryDirectory() as tmp:
        flat = run_flat_loop(torch, kernels, lm_model, optim, train,
                             make_lm_batch_fn,
                             ShapeSpec("flat", FLAT_T, FLAT_B, "train"),
                             xcfg, Path(tmp))
    print(f"  xlstm-350m flat step ms {steady(flat['step_ms'])}")
    torch.cuda.empty_cache()

    # 13. distrib/: the hier train step and the tree's cloud_mesh
    print(f"main path: distrib/ on one NCCL rank: {HIER_ARCH} widths, "
          f"reduced {HIER_REDUCED}, make_train_step(hier_sync=True), "
          f"B={HIER_B}, T={HIER_T}, AdamW lr {HIER_LR}; then the AlexNet "
          f"E=2 tree's Plan.step_fn(cloud_mesh=...)")
    with tempfile.TemporaryDirectory() as tmp:
        distrib = run_distrib(torch, kernels, Path(tmp), hier=dict(
            ref=ref, lm_model=lm_model, optim=optim, train=train,
            step_mod=step_mod, tiered=tiered, compat=compat,
            make_batch_fn=make_lm_batch_fn,
            shape=ShapeSpec("hier", HIER_T, HIER_B, "train"), cfg=hcfg,
            held_rows=sync_rows), cloud=dict(api=api, cnn=cnn,
                                              sharding=sharding))
    for k, r in distrib["hier"]["tiers"].items():
        print(f"  hier tiers={k} step ms {steady(r['step_ms'])}")
    torch.cuda.empty_cache()

    # 14. launch/: the dry run's cells (CPU processes), the dry run of
    # phase 13's flat step against the card, the FLOP cross-check
    print(f"main path: launch/ dry runs ({len(DRYRUN_CELLS)} processes: "
          f"meta device, fake backend); {HIER_ARCH} {HIER_REDUCED} flat "
          f"step traced on meta and run on the card; crosscheck_flops")
    launch = run_launch(torch, kernels, root, hcfg,
                        ShapeSpec("hier", HIER_T, HIER_B, "train"))
    vs_card = launch["vs_card"]

    # 15. analysis/: the static gate, the SASS's accumulators, and every
    # kernel entry at ragged extents inside guard bands
    print("analysis/: the port's gate, RA503 against the SASS, RA501/502 "
          "at run time")
    analysis = run_analysis(torch, kernels, ref, root, sass)

    # 16. the train step of every family partitioned over DTensor (one
    # NCCL rank)
    print(f"main path: {HIER_ARCH} {HIER_REDUCED} flat step through "
          f"distrib.partition.partitioned_step on a (data, model) = (1, 1) "
          f"mesh, fsdp False and True, {PART_STEPS} checked and "
          f"{PART_TIMED} timed steps each; then {PART_FAMILIES} at their "
          f"published widths, B={PART_B}, T={PART_T}, fsdp True")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        part = run_partition(torch, kernels, Path(tmp), lm_model=lm_model,
                             optim=optim, train=train,
                             make_batch_fn=make_lm_batch_fn,
                             shape=ShapeSpec("hier", HIER_T, HIER_B,
                                             "train"), cfg=hcfg,
                             configs=configs)
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    path_runs = {"alexnet_M1": runs[1], "alexnet_M4": runs[4],
                 "alexnet_train_M1": train_runs[1],
                 "alexnet_train_M4": train_runs[4],
                 "fleet_gla_M1": lm_runs[1], "fleet_gla_M4": lm_runs[4],
                 "zamba2_7b": z7,
                 **{f"alexnet_tree_E{e}": r for e, r in tree_runs.items()},
                 "alexnet_train_tree_E2": tree_train,
                 **{f"serve_{a}": r for a, r in serve_runs.items()},
                 "fleet_moe_M4": fam_runs["fleet-moe"],
                 "fleet_xlstm_M4": fam_runs["fleet-xlstm"],
                 "qwen2_moe_2_layers": qm, "xlstm_350m_flat": flat,
                 **{f"hier_{k}": r
                    for k, r in distrib["hier"]["tiers"].items()},
                 "alexnet_cloud_tree_E2": distrib["cloud"],
                 "dryrun_flat_step": vs_card,
                 **{f"partition_{k}": part[k]
                    for k in ("fsdp_False", "fsdp_True")},
                 **{f"partition_{a}": part[a] for a, _ in PART_FAMILIES}}
    paths = {k: r["launches"] for k, r in path_runs.items()}
    held = set(alexnet_rows)
    seen = {k: r["wire_rows"] for k, r in path_runs.items()
            if k.startswith("alexnet")}
    print(f"AlexNet wire rows by path {seen}; phase 3 held {sorted(held)}")
    if not set().union(*map(set, seen.values())) <= held:
        fail(f"an AlexNet path quantized rows phase 3 did not hold: {seen}")
    for name in kernels:
        if all(counts[name] == 0 for counts in paths.values()):
            fail(f"{name} never launched on a main path")
    print("summary " + json.dumps({
        "alexnet": {str(m): {"step_ms": r["step_ms"], "losses": r["losses"],
                             "reference": ref_gap[m],
                             "int8_loss_gap": int8_gap[m],
                             "profile": r["profile"]}
                    for m, r in runs.items()},
        "fleet_gla": {str(m): {k: v for k, v in r.items()}
                      for m, r in lm_runs.items()},
        "alexnet_train": {str(m): r for m, r in train_runs.items()},
        "alexnet_tree": {str(e): {"plan": str(r["plan"].schedule),
                                  "plan_ms": r["plan_ms"],
                                  "step_ms": r["step_ms"],
                                  "losses": r["losses"],
                                  "crossings": r["crossings"],
                                  "profile": r["profile"], **tree_info[e]}
                         for e, r in tree_runs.items()},
        "alexnet_tree_e1_vs_star": tree_e1,
        "alexnet_train_tree_E2": tree_train,
        "measure_profile": measured,
        "zamba2_7b": z7, "serve": serve_runs, "fleet_families": fam_runs,
        "qwen2_moe_2_layers": qm, "xlstm_350m_flat": flat,
        "distrib": distrib, "launch": launch, "analysis": analysis,
        "partition": part,
        "launches": paths,
        "tensor_cores": tensor_cores,
        "quantizer_cases": list(qcases.values()),
        "flash_cases": list(fcases.values()),
        "gla_cases": list(gcases.values())}, default=str))

    # 17. kernels line
    def entry(name, source, replaces, main, cases, ok_key):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(c[name] for c in paths.values()),
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "launches_per_step": {p: r["launches_per_step"][name]
                                      for p, r in path_runs.items()},
                "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "case": main["case"],
                "check": all(c[ok_key] for c in cases.values())}
    print(json.dumps({"kernels": [
        entry("int8_quant", "src/repro_torch/kernels/csrc/int8_quant.cu",
              "src/repro/kernels/int8_quant.py:29",
              qcases[f"wire_qdq_int8:lm_bf16_35x{LM_T * 512}"], qcases,
              "equal"),
        entry("flash_attention",
              "src/repro_torch/kernels/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:33",
              fcases[FLASH_CASES[0][0]], fcases, "ok"),
        entry("gla_scan", "src/repro_torch/kernels/csrc/gla_scan.cu",
              "src/repro/kernels/gla_scan.py:31",
              gcases[GLA_CASES[0][0]], gcases, "ok"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
