"""Where the port runs: the card unless the caller names another device;
and whether a tensor is spread over a mesh's devices (a DTensor)."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card; raise rather than fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device by default "
                           "and none is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor``."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
