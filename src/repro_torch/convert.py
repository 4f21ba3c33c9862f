"""Parameters across the package boundary, as numpy arrays.

The port keeps the JAX package's parameter layouts (a list with one
nested dict of arrays per cut-point for a layer stack; one nested dict
with stacked ``[L, ...]`` leaves for a ``build_model`` model), so
carrying weights over is only a conversion of arrays.  bf16 crosses without ``ml_dtypes``: a numpy array
whose dtype is named ``bfloat16`` (what JAX hands out) is viewed as
``uint16`` bits, carried into an ``int16`` tensor and viewed as
``torch.bfloat16``, so no value is rounded.  numpy has no bf16 of its
own, so :func:`params_to_numpy` widens a bf16 tensor to f32, which holds
every bf16 value exactly (``jnp.asarray(a, jnp.bfloat16)`` restores the
bits).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

Device = Optional[Union[str, torch.device]]


def _to_tensor(arr: Any, device: Device = None) -> torch.Tensor:
    """A tensor on ``device`` (default CPU) with the bits of ``arr``."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_array(t: torch.Tensor) -> np.ndarray:
    """A numpy array of ``t`` (bf16 widened exactly to f32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _tree(fn, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def params_from_numpy(params: Sequence[Dict[str, Any]],
                      device: Device = None
                      ) -> List[Dict[str, Any]]:
    """Tensors on ``device`` (default CPU) from a list of nested dicts of
    array-likes (numpy arrays, or anything ``np.asarray`` accepts)."""
    return [_tree(lambda v: _to_tensor(v, device), p) for p in params]


def params_to_numpy(params: Sequence[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    return [_tree(_to_array, p) for p in params]


def model_params_from_numpy(params: Dict[str, Any], device: Device = None
                            ) -> Dict[str, Any]:
    """Tensors on ``device`` (default CPU) from one nested dict of
    array-likes: the layout of ``build_model(cfg).init``."""
    return _tree(lambda v: _to_tensor(v, device), params)


def model_params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    return _tree(_to_array, params)
