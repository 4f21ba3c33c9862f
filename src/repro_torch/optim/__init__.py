"""Optimizers of the single-process train step."""
from repro_torch.optim.optimizers import (AdamW, Optimizer, OptState,
                                          SGDMomentum, get_optimizer,
                                          global_norm)

__all__ = ["AdamW", "Optimizer", "OptState", "SGDMomentum",
           "get_optimizer", "global_norm"]
