"""Deterministic synthetic data pipelines (numpy, host side)."""
from repro_torch.data.pipeline import (SyntheticImages, SyntheticTokens,
                                       make_lm_batch_fn)

__all__ = ["SyntheticImages", "SyntheticTokens", "make_lm_batch_fn"]
