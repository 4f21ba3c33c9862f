"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py

Phases (every one that fails exits non-zero; there is no CPU path):

1. Card: ``nvidia-smi`` name and power limit; TF32 off for cuDNN and
   matmul, so f32 means f32.
2. Build: every CUDA source under ``src/repro_torch/kernels/csrc/`` with
   ``nvcc`` (one process per source, all at once).
3. Kernel vs plain version: the int8 quantizer at the main path's shapes
   (and ragged, all-zero, random-noise and bf16 cases) against its plain
   PyTorch version on the same inputs, bitwise (both divide in IEEE f32);
   times from CUDA events over CUDA-graph replays (device time, L2 warm
   as on the main path, where conv1 has just written the activation).
4. Main path: AlexNet 224x224 at full width, B=64, int8 wire:
   ``Fleet.from_table2`` -> ``plan`` -> ``Plan.init_params`` ->
   ``Plan.step_fn``, 13 steps on one fixed batch each on the M=1 triple
   and the M=4 star (3 checked: finite, falling; all timed), with the
   launch counter zeroed just before and read just after; then
   ``wire="none"`` on the same cuts against the vanilla SGD step, and
   the int8-vs-none loss gap against the repo's int8 budget.
5. One JSON line of kernels; last, the ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12       # f32 outside the tensor cores
E2E_LOSS_GAP = 0.02               # int8-vs-none loss budget (tests/test_wire.py)
REF_UPDATE_RTOL = 1e-2            # hybrid vs vanilla SGD, see check_reference
REF_LOSS_RTOL = 1e-5
# lr 1e-4: He-initialised AlexNet starts near loss 10 on random data and
# diverges at the repo's usual 0.05.
B, LR, SEED, BATCH_SEED = 64, 1e-4, 0, 100
STEPS, TIMED_STEPS = 3, 10
WIRE_SHAPE_N = 28 * 28 * 64       # AlexNet cut 1: conv1 + pool output


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def graph_ms(torch, fn, reps: int = 10, trials: int = 25) -> float:
    """Median device ms of one ``fn()``: ``reps`` calls captured in one
    CUDA graph, replayed ``trials`` times between CUDA events."""
    stream = torch.cuda.Stream()
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
    return statistics.median(times)


def quant_bound(M: int, N: int, x_bytes: int, u_tensor: bool) -> tuple:
    """Least time for one quantize call: each input read once, each output
    written once, vs ~6 f32 operations per element (abs, max, divide, add,
    floor, clamp)."""
    nbytes = M * N * (x_bytes + 1 + (4 if u_tensor else 0)) + 4 * M
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 6.0 * M * N / H100_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_quantizer(torch, iq, ref) -> dict:
    """Phase 3: the kernel against its plain version, bitwise."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for m in (39, 33, 6, 5, 4):                   # the wire's rows
        cases.append((f"wire_{m}x{WIRE_SHAPE_N}", torch.randn(
            m, WIRE_SHAPE_N, generator=g, device=dev), 0.5))
    zero = torch.randn(3, 1000, generator=g, device=dev)
    zero[1] = 0.0
    cases += [
        ("ragged_7x12345_u", torch.randn(7, 12345, generator=g, device=dev),
         torch.rand(7, 12345, generator=g, device=dev)),
        ("one_1x1_u", torch.randn(1, 1, generator=g, device=dev),
         torch.rand(1, 1, generator=g, device=dev)),
        ("zero_row_3x1000", zero, 0.5),
        ("bf16_64x4096", torch.randn(64, 4096, generator=g, device=dev)
         .to(torch.bfloat16), 0.5),
    ]
    rows = []
    for name, x, u in cases:
        q, s = iq.quantize_int8(x, u)
        qr, sr = ref.ref_quantize_int8(x, u)
        torch.cuda.synchronize()
        equal = torch.equal(q, qr) and torch.equal(s, sr)
        err = max(float((q.int() - qr.int()).abs().max()),
                  float((s - sr).abs().max()))
        M, N = x.shape
        utensor = isinstance(u, torch.Tensor)
        bound, by = quant_bound(M, N, x.element_size(), utensor)
        row = {"case": name, "shape": [M, N], "dtype": str(x.dtype),
               "equal": equal, "max_abs_err": err,
               "ms": graph_ms(torch, lambda: iq.quantize_int8(x, u)),
               "plain_ms": graph_ms(torch,
                                    lambda: ref.ref_quantize_int8(x, u)),
               "bound_ms": bound, "bound_by": by}
        rows.append(row)
        print(f"  {name:22s} equal={equal} kernel {row['ms'] * 1e3:9.2f} us"
              f"  plain {row['plain_ms'] * 1e3:9.2f} us  bound "
              f"{bound * 1e3:7.2f} us ({by})")
        if not equal:
            fail(f"int8_quant disagrees with its plain version on {name} "
                 f"(max abs err {err})")
    return {r["case"]: r for r in rows}


def crossings(sched) -> int:
    """TASK-S/L streams whose cut ships an activation (m > 0, b > 0)."""
    n = sum(1 for m, b in zip(sched.m_s, sched.b_s) if m > 0 and b > 0)
    return n + (1 if sched.m_l > 0 and sched.b_l > 0 else 0)


def batch(torch):
    """One fixed seeded batch: every step trains on it, so the loss must
    fall."""
    g = torch.Generator(device="cuda").manual_seed(BATCH_SEED)
    x = torch.randn((B, 224, 224, 3), generator=g, device="cuda")
    y = torch.randint(0, 200, (B,), generator=g, device="cuda")
    return x, y


def run_plan(torch, api, iq, cnn, m: int) -> dict:
    """Phase 4 for one fleet: plan, then int8 steps through Plan.step_fn
    (``STEPS`` checked, ``TIMED_STEPS`` more for the step time), with the
    quantizer's launch counter zeroed just before and read just after."""
    fleet = api.Fleet.from_table2("alexnet", m=m, wire="int8")
    p = api.plan(cnn.alexnet(), fleet, B)
    sched = p.multi_schedule
    print(f"  M={m} plan: {p.schedule}  T_total={p.t_total!r} s (model)")
    n_cross = crossings(sched)
    if n_cross == 0:
        fail(f"M={m}: the plan crosses no int8 wire (m > 0, b > 0)")
    params = p.init_params(seed=SEED)
    step = p.step_fn(lr=LR)
    x, y = batch(torch)
    n_steps = STEPS + TIMED_STEPS
    losses, ms = [], []
    iq.launches = 0
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launches = iq.launches
    print(f"  M={m} losses {losses}")
    print(f"  M={m} step ms {ms}")
    print(f"  M={m} quantizer launches {launches} (expected "
          f"{2 * n_cross * n_steps})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"M={m}: non-finite loss {losses}")
    if not losses[STEPS - 1] < losses[0]:
        fail(f"M={m}: the loss did not fall on a fixed batch: {losses}")
    if launches != 2 * n_cross * n_steps:
        fail(f"M={m}: {launches} quantizer launches, expected "
             f"2 x {n_cross} crossings x {n_steps} steps")
    return {"plan": p, "losses": losses, "step_ms": ms,
            "launches": launches, "crossings": n_cross}


def step_fn(hs, p):
    """The engine ``Plan.step_fn`` runs for ``p``'s topology."""
    return hs.hybrid_step_from_schedule if p.fleet.topology == "triple" \
        else hs.multi_hybrid_step_from_schedule


def check_reference(torch, hs, run) -> dict:
    """``wire="none"`` on the plan's cuts against vanilla SGD on the card.

    The two differ only in summation order (a batch split against the
    whole batch, and cuDNN's choice of algorithm for each batch size), so
    each leaf's update ``p_new - p`` must agree to ``REF_UPDATE_RTOL`` of
    its largest entry and the loss to ``REF_LOSS_RTOL``.  A routing or
    aggregation fault (a worker's gradient dropped or counted twice)
    moves an update by about ``b_worker / B``, tens of percent here.
    Both f32 updates are also measured against a float64 vanilla step,
    for the record."""
    p = run["plan"]
    stack = p.model
    params = p.init_params(seed=SEED)
    x, y = batch(torch)
    hyb, hl = step_fn(hs, p)(stack, params, x, y, p.schedule, LR,
                             wire="none")
    ref, rl = hs.reference_sgd_step(stack, params, x, y, LR)
    p64 = [{k: v.double() for k, v in q.items()} for q in params]
    ref64, _ = hs.reference_sgd_step(stack, p64, x.double(), y, LR)
    leaves = []
    for i, (p0, ph, pr, pe) in enumerate(zip(p64, hyb, ref, ref64)):
        for k in sorted(p0):
            u_h, u_r, u_e = ph[k].double() - p0[k], pr[k].double() - p0[k], \
                pe[k] - p0[k]
            top = max(float(u_e.abs().max()), 1e-300)
            leaves.append({
                "leaf": f"{stack.cut_meta()[i].name}.{k}",
                "hybrid_vs_ref": float((u_h - u_r).abs().max()) /
                max(float(u_r.abs().max()), 1e-300),
                "hybrid_vs_f64": float((u_h - u_e).abs().max()) / top,
                "ref_vs_f64": float((u_r - u_e).abs().max()) / top})
    worst = max(leaves, key=lambda d: d["hybrid_vs_ref"])
    lgap = abs(float(hl) - float(rl)) / abs(float(rl))
    print(f"  {p.fleet.topology} reference check: loss rel gap "
          f"{lgap!r}; worst leaf {worst}")
    if worst["hybrid_vs_ref"] > REF_UPDATE_RTOL or lgap > REF_LOSS_RTOL:
        fail("wire='none' hybrid step disagrees with vanilla SGD")
    return {"loss_rel_gap": lgap, "leaves": leaves}


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
    from repro_torch.core import hybrid_step as hs
    from repro_torch.kernels import _build
    from repro_torch.kernels import int8_quant as iq
    from repro_torch.kernels import ref
    from repro_torch.models import cnn

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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # 3. kernel vs plain version
    print("int8_quant vs plain version (bitwise):")
    cases = check_quantizer(torch, iq, ref)

    # 4. main path
    print("main path: AlexNet 224x224, B=64, wire=int8")
    runs = {m: run_plan(torch, api, iq, cnn, m) for m in (1, 4)}
    ref_gap = {m: check_reference(torch, hs, runs[m]) for m in (1, 4)}
    int8_gap = {m: check_int8_gap(torch, hs, runs[m]) for m in (1, 4)}
    for m, r in runs.items():
        steady = sorted(r["step_ms"][1:])
        print(f"  M={m} step ms after the first: median "
              f"{statistics.median(steady)!r}, max {steady[-1]!r} "
              f"({len(steady)} steps); first {r['step_ms'][0]!r}")
    print("summary " + json.dumps({
        "step_ms": {str(m): r["step_ms"] for m, r in runs.items()},
        "losses": {str(m): r["losses"] for m, r in runs.items()},
        "launches": {str(m): r["launches"] for m, r in runs.items()},
        "reference": {str(m): g for m, g in ref_gap.items()},
        "int8_loss_gap": {str(m): g for m, g in int8_gap.items()},
        "quantizer_cases": list(cases.values())}))

    # 5. kernels line
    main_case = cases[f"wire_39x{WIRE_SHAPE_N}"]
    print(json.dumps({"kernels": [{
        "name": "int8_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_quant.cu",
        "replaces": "src/repro/kernels/int8_quant.py:29",
        "launches": sum(r["launches"] for r in runs.values()),
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None,
        "shape": main_case["shape"],
        "equal": all(c["equal"] for c in cases.values())}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
