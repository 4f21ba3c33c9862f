"""Chunked gated linear recurrence: the wrapper of ``csrc/gla_scan.cu``.

The port of ``src/repro/kernels/gla_scan.py::_gla_kernel``, with a zero
initial state::

    S_t = exp(a_t) S_{t-1} + k_t^T v_t
    n_t = exp(a_t) n_{t-1} + k_t
    y_t = q_t S_t  [/ max(|q_t n_t|, 1)]

evaluated in chunks of ``chunk`` steps.  Layout is head-major: q/k
``[BH, T, dk]``, v ``[BH, T, dv]``, log_decay f32 ``[BH, T]``.  Unlike
the TPU kernel, ``T`` need not be a multiple of the chunk: the ragged
last chunk is padded as ``chunked_gla`` pads.  Heads up to ``MAX_DK``
wide: bf16 heads whose widths are multiples of 16 take the tensor cores
(up to 128 one kernel, wider another), f32 and other bf16 widths the CUDA
cores (``dispatch`` in ``csrc/gla_scan.cu``, by dtype, shape and alignment
alone).

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.ref_gla`, the step recurrence); a CUDA
tensor launches the kernel or raises.  ``launches`` counts the kernel's
launches, so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_gla

MAX_DK = 512      # xLSTM's mLSTM heads
MAX_CHUNK = 4096  # the chunk's cumsum and weights live in shared memory

launches = 0


@functools.cache
def _kernel():
    """The C entry point, built and typed on first use."""
    fn = _build.library("gla_scan").gla_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gla_scan_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_decay: torch.Tensor, chunk: int = 128,
                 normalize: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q/k ``[BH, T, dk]`` and v ``[BH, T, dv]``, all f32 or all bf16;
    log_decay f32 ``[BH, T]``; all contiguous, on one device.  Returns
    ``(y [BH, T, dv] in v's dtype, S f32 [BH, dk, dv], n f32 [BH, dk])``."""
    global launches
    if q.dim() != 3 or k.shape != q.shape or v.dim() != 3 or \
            v.shape[:2] != q.shape[:2] or \
            tuple(log_decay.shape) != tuple(q.shape[:2]):
        raise ValueError(f"gla_scan_fwd needs q, k [BH, T, dk], v [BH, T, "
                         f"dv] and log_decay [BH, T]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(log_decay.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gla_scan_fwd takes f32 or bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if log_decay.dtype != torch.float32:
        raise TypeError(f"log_decay must be f32, got {log_decay.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v, log_decay)):
        raise ValueError("gla_scan_fwd needs contiguous inputs")
    if any(t.device != q.device for t in (k, v, log_decay)):
        raise ValueError("q, k, v and log_decay must be on one device")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if q.device.type in ("cpu", "meta"):       # meta: shapes only
        return ref_gla(q, k, v, log_decay, normalize=normalize)
    if q.device.type != "cuda":
        raise ValueError(f"gla_scan_fwd runs on cpu, meta or cuda, not "
                         f"{q.device.type}")
    BH, T, dk = q.shape
    dv = v.shape[-1]
    if not 1 <= dk <= MAX_DK:
        raise ValueError(f"the CUDA kernel takes dk <= {MAX_DK}, got {dk}")
    W = min(chunk, T)
    if W > MAX_CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks <= {MAX_CHUNK}, "
                         f"got {W}")
    y = torch.empty_like(v)
    S = torch.zeros((BH, dk, dv), dtype=torch.float32, device=q.device)
    n = torch.zeros((BH, dk), dtype=torch.float32, device=q.device)
    if BH == 0 or T == 0 or dv == 0:
        return y, S, n
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    log_decay.data_ptr(), y.data_ptr(), S.data_ptr(),
                    n.data_ptr(), int(q.dtype == torch.bfloat16), BH, T, dk,
                    dv, W, int(bool(normalize)), stream)
    if err != 0:
        raise RuntimeError(f"gla_scan kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return y, S, n
