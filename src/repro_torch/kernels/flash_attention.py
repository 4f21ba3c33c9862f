"""Flash-attention forward: the wrapper of ``csrc/flash_attention.cu``.

The port of ``src/repro/kernels/flash_attention.py::_fwd_kernel``:
online-softmax attention with GQA (query head ``h`` reads KV head
``h // rep``), causal and sliding-window masks (``kpos > qpos - window``),
-1e30 masking and f32 accumulation, emitting the per-query f32
log-sum-exp the backward consumes.  Layout is head-major:
q ``[BH, T, hd]``, k/v ``[BKV, S, hd]``.

A tensor on the CPU goes to the plain version
(:func:`repro_torch.kernels.ref.ref_flash_attention`); a CUDA tensor
launches the kernel or raises.  A DTensor raises wherever it lies: the
kernel takes each rank's local shard, which
:func:`repro_torch.kernels.ops.flash_attention` passes it, and never
gathers one.  ``launches`` counts the kernel's
launches, so a run can show that its main path went through it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.device import is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ref_flash_attention

# Head widths the kernel is compiled for (zamba2-7b's 112 and gemma3-12b's
# 256 included).
HEAD_DIMS = (64, 112, 128, 256)

launches = 0


def bind(lib: ctypes.CDLL):
    """``lib``'s C entry point, typed."""
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _kernel():
    """The C entry point, built and typed on first use."""
    return bind(_build.library("flash_attention"))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, window: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q ``[BH, T, hd]``; k/v ``[BKV, S, hd]`` with ``BKV`` dividing
    ``BH``; all f32 or all bf16, contiguous, on one device.  Returns
    ``(o [BH, T, hd] in q's dtype, lse f32 [BH, T])``."""
    global launches
    if any(is_dtensor(t) for t in (q, k, v)):
        raise TypeError("flash_attention_fwd takes each rank's local "
                        "tensors, not a DTensor (a wrapper with no storage "
                        "of its own): repro_torch.kernels.ops."
                        "flash_attention runs it on the local shards")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd needs q [BH, T, hd] and k, v "
                         f"[BKV, S, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, T, hd = q.shape
    BKV, S, hd_k = k.shape
    if hd_k != hd or BKV == 0 or BH % BKV:
        raise ValueError(f"head width {hd} vs {hd_k}, or {BKV} KV heads "
                         f"do not divide {BH} query heads")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes f32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd needs contiguous q, k, v")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.device.type in ("cpu", "meta"):       # meta: shapes only
        return ref_flash_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cpu, meta or cuda, "
                         f"not {q.device.type}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head widths {HEAD_DIMS}, "
                         f"got {hd}")
    o = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), int(q.dtype == torch.bfloat16), BH, BKV,
                    T, S, hd, int(bool(causal)), int(window),
                    1.0 / (hd ** 0.5), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return o, lse
