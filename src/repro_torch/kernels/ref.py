"""Plain PyTorch versions of the port's kernels (kernel-native layouts).

Each function is the simplest correct implementation of its kernel's
contract.  The wrappers use it for tensors on the CPU, and the chip
smoke run holds each kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch


def ref_quantize_int8(x: torch.Tensor, noise: Union[torch.Tensor, float]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise absmax int8 quantization of ``x [M, N]`` with supplied
    uniform noise (an f32 ``[M, N]`` tensor, or one constant).  Returns
    ``(q int8 [M, N], scale f32 [M])``.

    Every division is by a tensor: PyTorch turns a division by a Python
    scalar into a multiply by its reciprocal on the card, which is not
    the IEEE quotient the kernel computes."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = absmax.clamp_min(1e-30) / torch.full_like(absmax, 127.0)
    u = noise.float() if isinstance(noise, torch.Tensor) else float(noise)
    q = torch.floor(xf / scale + u).clamp_(-127.0, 127.0).nan_to_num_(0.0)
    return q.to(torch.int8), scale[:, 0]
