"""Parameters across the package boundary, as numpy arrays.

The port keeps the JAX package's parameter layout (a list with one
``{"w", "b"}`` dict per cut-point, HWIO conv weights), so carrying
weights over is only a conversion of arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def params_from_numpy(params: Sequence[Dict[str, np.ndarray]],
                      device: Optional[Union[str, torch.device]] = None
                      ) -> List[Dict[str, torch.Tensor]]:
    """Tensors on ``device`` (default CPU) from a list of dicts of
    array-likes (numpy arrays, or anything ``np.asarray`` accepts)."""
    return [{k: torch.from_numpy(np.array(v, copy=True)).to(device)
             for k, v in p.items()} for p in params]


def params_to_numpy(params: Sequence[Dict[str, torch.Tensor]]
                    ) -> List[Dict[str, np.ndarray]]:
    return [{k: v.detach().cpu().numpy() for k, v in p.items()}
            for p in params]
