"""Public wrappers around the port's int8 quantizer kernel.

* :func:`wire_qdq_int8` — the deterministic cut-point wire round trip
  (per-sample rows, round to nearest).
* :func:`quantize_int8` / :func:`dequantize_int8` — unbiased int8
  compression with stochastic rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import int8_quant as iq


def quantize_int8(x: torch.Tensor, generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantizes the rows of ``x [M, N]`` with stochastic rounding, the
    uniform noise drawn from ``generator`` (on ``x``'s device).  Returns
    ``(q int8 [M, N], scale f32 [M])``; :func:`dequantize_int8` inverts."""
    noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                       device=x.device)
    return iq.quantize_int8(x, noise)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return iq.dequantize_int8(q, scale)


def wire_qdq_int8(x: torch.Tensor) -> torch.Tensor:
    """Deterministic int8 wire round trip: per-*sample* rows (leading
    axis), absmax scaling, round to nearest (the noise pinned at 0.5).
    Returns the dequantized tensor in ``x``'s shape and dtype — exactly
    what the receiving worker reconstructs from ``elems + 4`` wire
    bytes/sample (see :mod:`repro_torch.core.wire`)."""
    flat = x.reshape(x.shape[0], -1).contiguous()
    q, scale = iq.quantize_int8(flat, 0.5)
    return iq.dequantize_int8(q, scale).reshape(x.shape).to(x.dtype)
