"""Per-row absmax int8 quantizer and the int8 wire's fused round trip:
the wrappers of ``csrc/int8_quant.cu``.

The port of ``src/repro/kernels/int8_quant.py::_quant_kernel``::

    scale_i = max(max_j |x_ij|, 1e-30) / 127
    q_ij    = clip(floor(x_ij / scale_i + u_ij), -127, 127)

The noise ``u`` is an input: an f32 ``[M, N]`` tensor (stochastic
rounding, unbiased) or one constant (0.5 on the cut-point wire, which
then rounds to nearest without materialising a noise tensor).
:func:`wire_qdq_int8` is the wire's ``dequantize(quantize(x, 0.5))`` in
``x``'s dtype, computed by one kernel pair that never writes ``q``.

Both kernels split each row into slices (:func:`plan_slices`): a first
launch writes each slice's absmax to an ``[M, S]`` f32 scratch, a second
reduces a row's partials to its scale and maps the slice.

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.ref_quantize_int8`,
:func:`repro_torch.kernels.ref.ref_wire_qdq_int8`); a CUDA tensor
launches the kernel or raises.  ``launches`` counts calls of either
entry that launched the kernels, so a run can show that its main path
went through them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_quantize_int8, ref_wire_qdq_int8

launches = 0

THREADS = 256          # kThreads of csrc/int8_quant.cu
VECTOR_BYTES = 16      # one load or store of x per thread
TARGET_BLOCKS = 4 * 132  # four blocks on each of the H100's 132 SMs


def plan_slices(M: int, N: int, elem_bytes: int) -> Tuple[int, int]:
    """``(S, slice_elems)``: each row of ``[M, N]`` is cut into ``S``
    slices of ``slice_elems`` elements (the last one shorter), one block
    each.  ``S`` brings the grid to about ``TARGET_BLOCKS`` but leaves
    every thread at least one 16-byte load; ``slice_elems`` is a whole
    number of 16-byte vectors, so every slice of a row that starts on a
    16-byte boundary does too."""
    vec = VECTOR_BYTES // elem_bytes
    min_slice = THREADS * vec
    S = max(1, min(-(-TARGET_BLOCKS // M), N // min_slice))
    slice_elems = -(-N // S)
    slice_elems = -(-slice_elems // vec) * vec
    return -(-N // slice_elems), slice_elems


@functools.cache
def _kernels():
    """The C entry points, built and typed on first use."""
    return bind(_build.library("int8_quant"))


def bind(lib: ctypes.CDLL):
    """``(quant, wire, check)``: the typed C entries of a library built
    from ``csrc/int8_quant.cu``."""
    quant = lib.int8_quant_rows
    quant.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    quant.restype = ctypes.c_int
    wire = lib.int8_wire_qdq
    wire.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    wire.restype = ctypes.c_int
    check = lib.int8_check_quotients
    check.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p]
    check.restype = ctypes.c_int
    return quant, wire, check


def _check_x(x: torch.Tensor, name: str,
             devices: Tuple[str, ...] = ("cpu", "cuda")) -> None:
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{name} needs a non-empty [M, N] tensor, got "
                         f"shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous x")
    if x.device.type not in devices:
        raise ValueError(f"{name} runs on {', '.join(devices)}, not "
                         f"{x.device.type}")


def _plan(x: torch.Tensor) -> Tuple[int, int, torch.Tensor, int]:
    """The slice plan of ``x``, its ``[M, S]`` scratch and the stream."""
    M, N = x.shape
    S, slice_elems = plan_slices(M, N, x.element_size())
    partial = torch.empty((M, S), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return S, slice_elems, partial, stream


def _launched(err: int, name: str) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches += 1


def quantize_int8(x: torch.Tensor, noise: Union[torch.Tensor, float]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [M, N]`` f32 or bf16, contiguous; ``noise`` an f32 ``[M, N]``
    tensor on ``x``'s device, or a constant in [0, 1).  Returns
    ``(q int8 [M, N], scale f32 [M])``."""
    _check_x(x, "quantize_int8", ("cpu", "meta", "cuda"))
    u_tensor = isinstance(noise, torch.Tensor)
    if u_tensor and (noise.shape != x.shape or noise.dtype != torch.float32
                     or noise.device != x.device
                     or not noise.is_contiguous()):
        raise ValueError("noise must be a contiguous f32 tensor of x's "
                         "shape on x's device")
    if x.device.type in ("cpu", "meta"):       # meta: shapes only
        return ref_quantize_int8(x, noise)
    M, N = x.shape
    S, slice_elems, partial, stream = _plan(x)
    q = torch.empty((M, N), dtype=torch.int8, device=x.device)
    scale = torch.empty((M,), dtype=torch.float32, device=x.device)
    err = _kernels()[0](x.data_ptr(), int(x.dtype == torch.bfloat16),
                        noise.data_ptr() if u_tensor else None,
                        0.0 if u_tensor else float(noise),
                        q.data_ptr(), scale.data_ptr(), partial.data_ptr(),
                        M, N, S, slice_elems, stream)
    _launched(err, "int8_quant")
    return q, scale


def wire_qdq_int8(x: torch.Tensor) -> torch.Tensor:
    """``x [M, N]`` f32 or bf16, contiguous.  Returns
    ``dequantize(quantize(x, 0.5))`` rounded to ``x``'s dtype, the value
    the receiving end of the int8 wire reconstructs."""
    _check_x(x, "wire_qdq_int8")
    if x.device.type == "cpu":
        return ref_wire_qdq_int8(x)
    M, N = x.shape
    S, slice_elems, partial, stream = _plan(x)
    out = torch.empty_like(x)
    err = _kernels()[1](x.data_ptr(), int(x.dtype == torch.bfloat16),
                        out.data_ptr(), partial.data_ptr(), M, N, S,
                        slice_elems, stream)
    _launched(err, "int8_wire_qdq")
    return out


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse map: a single multiply needs no kernel."""
    return q.float() * scale[:, None]


def check_quotients(divisors: torch.Tensor) -> int:
    """Holds the kernels' ``x / s`` (a reciprocal per row and two FMA
    corrections, ``quotient`` in ``csrc/int8_quant.cu``) against the IEEE
    division on the card: for each divisor (f32, finite, positive, on
    the card), 12 * 2^23 dividends, every significand at six exponents
    and both signs.  Returns the count that differ in any bit."""
    if (divisors.device.type != "cuda" or divisors.dtype != torch.float32
            or divisors.dim() != 1 or not divisors.is_contiguous()
            or not 0 < divisors.numel() <= 65535):
        raise ValueError("check_quotients takes a contiguous 1-D f32 tensor "
                         "of at most 65,535 divisors on the card")
    bad = torch.zeros(1, dtype=torch.int64, device=divisors.device)
    stream = torch.cuda.current_stream(divisors.device).cuda_stream
    err = _kernels()[2](divisors.data_ptr(), divisors.numel(),
                        bad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"check_quotients launch failed: CUDA error {err}")
    return int(bad.item())
