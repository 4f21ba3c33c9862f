"""Per-row absmax int8 quantizer: the wrapper of ``csrc/int8_quant.cu``.

The port of ``src/repro/kernels/int8_quant.py::_quant_kernel``::

    scale_i = max(max_j |x_ij|, 1e-30) / 127
    q_ij    = clip(floor(x_ij / scale_i + u_ij), -127, 127)

The noise ``u`` is an input: an f32 ``[M, N]`` tensor (stochastic
rounding, unbiased) or one constant (0.5 on the cut-point wire, which
then rounds to nearest without materialising a noise tensor).

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.ref_quantize_int8`); a CUDA tensor
launches the kernel or raises.  ``launches`` counts the kernel's
launches, so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_quantize_int8

launches = 0


@functools.cache
def _kernel():
    """The C entry point, built and typed on first use."""
    lib = _build.library("int8_quant")
    fn = lib.int8_quant_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_int8(x: torch.Tensor, noise: Union[torch.Tensor, float]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [M, N]`` f32 or bf16, contiguous; ``noise`` an f32 ``[M, N]``
    tensor on ``x``'s device, or a constant in [0, 1).  Returns
    ``(q int8 [M, N], scale f32 [M])``."""
    global launches
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"quantize_int8 needs a non-empty [M, N] tensor, "
                         f"got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_int8 takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8 needs a contiguous x")
    u_tensor = isinstance(noise, torch.Tensor)
    if u_tensor and (noise.shape != x.shape or noise.dtype != torch.float32
                     or noise.device != x.device
                     or not noise.is_contiguous()):
        raise ValueError("noise must be a contiguous f32 tensor of x's "
                         "shape on x's device")
    if x.device.type == "cpu":
        return ref_quantize_int8(x, noise)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8 runs on cpu or cuda, not "
                         f"{x.device.type}")
    M, N = x.shape
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                    noise.data_ptr() if u_tensor else None,
                    0.0 if u_tensor else float(noise),
                    q.data_ptr(), scale.data_ptr(), M, N, stream)
    if err != 0:
        raise RuntimeError(f"int8_quant kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse map: a single multiply needs no kernel."""
    return q.float() * scale[:, None]
