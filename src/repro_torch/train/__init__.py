"""Training: the train step (one process, or tiered over the pods of a
mesh), the generic loop around it, and the hierarchical loop behind
``Plan.train``."""
from repro_torch.train.loop import (HierLoopConfig, InjectedFailure,
                                    LoopConfig, run_train_loop)
from repro_torch.train.step import TrainState, init_state, make_train_step

__all__ = ["HierLoopConfig", "InjectedFailure", "LoopConfig",
           "run_train_loop", "TrainState", "init_state", "make_train_step"]
