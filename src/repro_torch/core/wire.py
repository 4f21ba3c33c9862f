"""Wire compression for cut-point transfers (DESIGN.md §11).

HierTrain's bottleneck is the device uplink: what crosses the
mobile→edge→cloud wire at a cut is the per-sample activation (forward)
and activation-gradient (backward) tensor.  This module makes that wire
compressible — ``wire="int8"`` ships both directions int8-quantized via
the :mod:`repro_torch.kernels.int8_quant` CUDA kernel — and, critically,
makes the *cost model see it*: compressed split-point traffic changes
the optimal cut (arXiv:2403.15815), so the scheduler must plan with the
compressed ``MO``/``MG`` columns, not just apply the codec at runtime.

Two halves, kept consistent by construction:

* **Accounting** — :func:`apply_wire` rewrites a profile's ``MO``/``MG``
  columns to the compressed wire sizes.  One int8 payload byte per
  tensor element plus one f32 row scale per *sample* (the codec
  quantizes per-sample rows), so::

      bytes/sample = elems/sample + 4

  Element counts come from :class:`~repro_torch.core.layerstack.CutMeta`
  (``resolved_act_elems`` / ``resolved_grad_elems``), which is what
  makes the accounting honor *asymmetric* fwd/bwd dtypes: an LM cut
  ships bf16 forward (ratio ≈ 1/2) but f32 backward (ratio ≈ 1/4), and
  both compress to the *same* byte count — the historical symmetric-
  dtype assumption baked into the uncompressed wire sizes drops out.
  Every downstream scorer — ``t_total(_multi)(_batch)``, the three LP
  builders, ``t_period`` and the DES transfer sizes — reads
  ``profile.MO``/``profile.MG``, so this one transform flows through
  all of them in the identical operation order.

* **Execution** — :func:`wire_codec` returns the quantize→dequantize
  round trip the hybrid step applies at each crossing.  Forward it
  compresses the shipped activation; backward (a
  ``torch.autograd.Function``) it compresses the returning cotangent —
  the MG channel.  Rounding is deterministic (round-to-nearest, i.e. the
  kernel's stochastic-rounding noise pinned at 0.5), so a step is a
  pure function of its inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.layerstack import as_layerstack
from repro_torch.kernels import ops as kops

WIRE_MODES = ("none", "int8")

# One f32 absmax scale per quantized row; the codec flattens each
# crossing tensor to one row per sample.
SCALE_BYTES = 4.0


def validate_wire(wire: str) -> str:
    if wire not in WIRE_MODES:
        raise ValueError(f"unknown wire mode {wire!r}; pick one of "
                         f"{WIRE_MODES}")
    return wire


def int8_wire_bytes(elems):
    """Compressed bytes/sample of an ``elems``-element crossing tensor
    (scalar or ndarray): one int8 byte per element + the row scale."""
    return np.asarray(elems, np.float64) * 1.0 + SCALE_BYTES


def wire_act_bytes(meta, wire: str) -> float:
    """Forward wire bytes/sample at one cut under ``wire``."""
    validate_wire(wire)
    if wire == "none":
        return float(meta.act_bytes)
    return float(int8_wire_bytes(meta.resolved_act_elems))


def wire_grad_bytes(meta, wire: str) -> float:
    """Backward wire bytes/sample at one cut under ``wire``."""
    validate_wire(wire)
    if wire == "none":
        return float(meta.resolved_grad_bytes)
    return float(int8_wire_bytes(meta.resolved_grad_elems))


def apply_wire(profile, stack, wire: str):
    """A copy of ``profile`` whose ``MO``/``MG`` columns are the
    compressed wire sizes (``wire="none"`` returns ``profile``
    unchanged — bit-identical to the historical path).

    With a ``stack`` the element counts come from its cut meta, so the
    fwd/bwd directions compress from their *own* dtypes.  Pinned
    profiles (no model) carry bytes only; their payloads are f32 (the
    CNN testbeds), so elements are ``bytes / 4``.
    """
    validate_wire(wire)
    if wire == "none":
        return profile
    if stack is not None:
        metas = as_layerstack(stack).cut_meta()
        assert len(metas) == profile.num_layers, \
            "stack cut-points do not match the profile"
        MO = np.array([wire_act_bytes(m, wire) for m in metas], np.float64)
        MG = np.array([wire_grad_bytes(m, wire) for m in metas], np.float64)
    else:
        MO = int8_wire_bytes(np.asarray(profile.MO, np.float64) / 4.0)
        MG = int8_wire_bytes(np.asarray(profile.MG, np.float64) / 4.0)
    return dataclasses.replace(profile, MO=MO, MG=MG)


# ---------------------------------------------------------------------------
# Execution codec.
# ---------------------------------------------------------------------------


class _Int8Wire(torch.autograd.Function):
    """x -> dequantize(quantize(x)), and the same codec on the cotangent:
    the returning activation-gradient crosses the same wire (the cost
    model's MG channel), so it pays the same codec."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return kops.wire_qdq_int8(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return kops.wire_qdq_int8(g.contiguous())


def wire_codec(wire: str) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The crossing transform for ``wire``: ``None`` for the identity
    wire (so the uncompressed step is untouched), else the differentiable
    ``x -> dequantize(quantize(x))`` round trip."""
    validate_wire(wire)
    if wire == "none":
        return None
    return _Int8Wire.apply
