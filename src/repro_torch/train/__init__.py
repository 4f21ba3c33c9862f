"""The hierarchical training loop behind ``Plan.train``."""
from repro_torch.train.loop import HierLoopConfig, InjectedFailure

__all__ = ["HierLoopConfig", "InjectedFailure"]
