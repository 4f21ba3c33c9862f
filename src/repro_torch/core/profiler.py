"""HierTrain profiling stage (§III): produce ``HierProfile`` objects.

The analytic half of the JAX package's ``core/profiler.py``: every entry
point takes any :class:`~repro_torch.core.layerstack.LayerStack` (or a bare
:class:`repro_torch.models.cnn.LayeredModel`) and derives per-layer
per-worker times from the stack's FLOP metadata and per-worker effective
throughput.  Deterministic, so the port's profiles, and the schedules
planned from them, equal the JAX package's.  The measured mode
(``measure_profile``, timed with CUDA events) comes later.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.cost_model import WORKERS, HierProfile, MultiProfile
from repro_torch.core.layerstack import as_layerstack


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
