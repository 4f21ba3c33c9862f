"""HierTrain profiling stage (§III): produce ``HierProfile`` objects.

The port of the JAX package's ``core/profiler.py``.  Every entry point
takes any :class:`~repro_torch.core.layerstack.LayerStack` (or a bare
:class:`repro_torch.models.cnn.LayeredModel`).  Two modes:

* :func:`analytic_profile` — per-layer per-worker times from the stack's
  FLOP metadata and per-worker effective throughput.  Deterministic, so
  the port's profiles, and the schedules planned from them, equal the
  JAX package's.
* :func:`measure_profile` — *measure* each cut's forward and backward
  time on the device (CUDA events on the card, ``perf_counter`` on the
  CPU; warm-up, then the mean of repeats), then scale to each worker by
  its relative speed — the paper's run-time profiling.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core.cost_model import WORKERS, HierProfile, MultiProfile
from repro_torch.core.layerstack import as_layerstack
from repro_torch.device import resolve_device
from repro_torch.tree import grad_leaves, leaves


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """Effective capability of one worker tier.

    ``flops_per_sec`` — sustained throughput on this model family.
    ``overhead`` — fixed per-layer dispatch overhead (seconds).
    ``update_flops_per_param`` — optimizer cost model (SGD+momentum ~ 4).
    """
    name: str
    flops_per_sec: float
    overhead: float = 0.0
    update_flops_per_param: float = 4.0


# Defaults calibrated to the paper's §VI-B testbed: Raspberry Pi 3 (device),
# one core of an Intel NUC i3-7100U (edge), Dell T5820 + GTX 1080 Ti (cloud).
# Effective (not peak) throughputs are per-model in reality — the paper's
# profiling stage measures each model on each worker — so the fleets carry
# per-model calibrations (``fleet.TABLE2_TESTBEDS``); this generic set is
# calibrated on LeNet-5.
PAPER_TESTBED: Dict[str, WorkerSpec] = {
    "device": WorkerSpec("device", flops_per_sec=2e9, overhead=1e-4),
    "edge": WorkerSpec("edge", flops_per_sec=2e10, overhead=1e-5),
    "cloud": WorkerSpec("cloud", flops_per_sec=2e11, overhead=5e-6),
}

# AlexNet's big 11x11/5x5 convs run at lower effective FLOP/s on the
# Pi/NUC than LeNet's tiny stacks (Chainer-era im2col); calibrated so the
# HierTrain-vs-All-Edge gap matches the paper's 2.3x.
ALEXNET_TESTBED: Dict[str, WorkerSpec] = {
    "device": WorkerSpec("device", flops_per_sec=4e8, overhead=1e-4),
    "edge": WorkerSpec("edge", flops_per_sec=6e9, overhead=1e-5),
    "cloud": WorkerSpec("cloud", flops_per_sec=2e11, overhead=5e-6),
}

# Transformer blocks are MXU/NEON-friendly dense matmuls: phones and edge
# boxes sustain a far larger fraction of peak than on branchy CNN stacks.
# Calibrated for the LM-fleet benchmark: mobile NPU device tier (~0.2
# effective bf16 TFLOP/s), edge GPU box (~1), cloud accelerator (~5).
LM_TESTBED: Dict[str, WorkerSpec] = {
    "device": WorkerSpec("device", flops_per_sec=2e11, overhead=2e-4),
    "edge": WorkerSpec("edge", flops_per_sec=1e12, overhead=5e-5),
    "cloud": WorkerSpec("cloud", flops_per_sec=5e12, overhead=2e-5),
}


def analytic_profile(model, workers: Dict[str, WorkerSpec] | None = None,
                     sample_bytes: float | None = None,
                     bwd_fwd_ratio: float = 2.0) -> HierProfile:
    """Analytic profile of any :class:`LayerStack` (or ``LayeredModel``).

    Cut-points that expose an explicit ``flops_bwd`` use it; the rest fall
    back to ``bwd_fwd_ratio * flops_fwd`` evaluated in the seed's exact
    operation order, so CNN profiles stay bitwise identical.  ``MG`` comes
    from the cut-points' ``grad_bytes`` (``== act_bytes`` by default).
    """
    stack = as_layerstack(model)
    workers = workers or PAPER_TESTBED
    metas = stack.cut_meta()
    n = len(metas)
    L_f = np.zeros((3, n))
    L_b = np.zeros((3, n))
    L_u = np.zeros((3, n))
    for j, wname in enumerate(WORKERS):
        w = workers[wname]
        for i, m in enumerate(metas):
            L_f[j, i] = m.flops_fwd / w.flops_per_sec + w.overhead
            if m.flops_bwd is None:
                L_b[j, i] = bwd_fwd_ratio * m.flops_fwd / w.flops_per_sec \
                    + w.overhead
            else:
                L_b[j, i] = m.flops_bwd / w.flops_per_sec + w.overhead
            L_u[j, i] = m.param_count * w.update_flops_per_param / \
                w.flops_per_sec + w.overhead
    if sample_bytes is None:
        sample_bytes = stack.default_sample_bytes()
    cols = stack.meta_arrays()
    return HierProfile(
        layer_names=cols["names"],
        L_f=L_f, L_b=L_b, L_u=L_u,
        MP=cols["MP"], MO=cols["MO"], MG=cols["MG"],
        sample_bytes=sample_bytes,
    )


def multi_analytic_profile(model,
                           workers: Dict[str, WorkerSpec] | None = None,
                           device_slowdowns=(1.0,),
                           sample_bytes: float | None = None,
                           bwd_fwd_ratio: float = 2.0) -> MultiProfile:
    """Analytic profile for the M-device star (DESIGN.md §6).

    ``device_slowdowns[i]`` scales the profiled device tier for device *i*
    (1.0 = the testbed's reference device, 2.0 = half its speed) — the
    straggler heterogeneity knob used by ``benchmarks/fig_multidevice``.
    With the default single 1.0 entry this is exactly
    :func:`analytic_profile` lifted to the M=1 star.
    """
    return MultiProfile.from_hier(
        analytic_profile(model, workers, sample_bytes, bwd_fwd_ratio),
        device_slowdowns)


def measure_profile(model, rel_speed: Dict[str, float] | None = None,
                    batch: int = 8, repeats: int = 3,
                    sample_bytes: float | None = None,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> HierProfile:
    """Measure real per-cut fwd/bwd times on ``device`` (default
    ``cuda``; raises when there is no card), scale per worker.

    Each cut's forward runs without autograd; its backward is the
    forward plus the gradient of ``sum(y**2)`` with respect to the cut's
    params AND its input activations — what a mid-stack worker computes.
    An integer input (the LM embed cut's token ids) has no gradient, so
    there the params gradient is the whole backward.  ``rel_speed[worker]``
    divides the measured time (2.0 => 2x faster than this device); the
    default calibrates the measuring device as the "edge" tier.
    """
    stack = as_layerstack(model)
    dev = resolve_device(device)
    rel_speed = rel_speed or {"device": 1 / 13.0, "edge": 1.0, "cloud": 11.0}
    metas = stack.cut_meta()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = stack.init(gen, dev)
    n = stack.num_layers
    seg_f = np.zeros(n)
    seg_b = np.zeros(n)
    x, _ = stack.dummy_batch(gen, batch)
    for i in range(n):
        with torch.no_grad():
            xi = x if i == 0 else stack.apply_segment(params, x, 0, i)
        fwd = functools.partial(_seg_fwd, stack, params, xi, i)
        bwd = functools.partial(_seg_bwd, stack, params, xi, i)
        fwd()
        bwd()
        seg_f[i] = float(np.mean([_time(fwd, dev) for _ in range(repeats)])
                          ) / batch
        seg_b[i] = float(np.mean([_time(bwd, dev) for _ in range(repeats)])
                          ) / batch
    L_f = np.zeros((3, n))
    L_b = np.zeros((3, n))
    L_u = np.zeros((3, n))
    for j, wname in enumerate(WORKERS):
        s = rel_speed[wname]
        L_f[j] = seg_f / s
        L_b[j] = seg_b / s
        L_u[j] = np.array([m.param_count * 4.0 for m in metas]) / \
            (s * 8e9)  # SGD update flops over scaled host throughput
    if sample_bytes is None:
        sample_bytes = stack.default_sample_bytes()
    cols = stack.meta_arrays()
    return HierProfile(
        layer_names=cols["names"],
        L_f=L_f, L_b=L_b, L_u=L_u,
        MP=cols["MP"], MO=cols["MO"], MG=cols["MG"],
        sample_bytes=sample_bytes,
    )


def _time(fn: Callable[[], None], dev: torch.device) -> float:
    """Seconds one ``fn()`` takes on ``dev``: CUDA events around it on
    the card, the host clock on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _seg_fwd(stack, params, x: torch.Tensor, i: int) -> None:
    with torch.no_grad():
        stack.apply_segment(params, x, i, i + 1)


def _seg_bwd(stack, params, x: torch.Tensor, i: int) -> None:
    """Cut ``i``'s forward and the gradient of ``sum(y**2)`` with
    respect to its params and (when floating) its input."""
    ps = list(params)
    ps[i] = grad_leaves(params[i])
    wrt = leaves(ps[i])
    if x.is_floating_point():
        x = x.detach().requires_grad_(True)
        wrt.append(x)
    y = stack.apply_segment(ps, x, i, i + 1)
    torch.autograd.grad((y.float() ** 2).sum(), wrt, allow_unused=True)
