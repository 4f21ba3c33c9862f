"""phi3-medium-14b [dense]: RoPE + SwiGLU + GQA.  [arXiv:2404.14219]

The port's copy of ``src/repro/configs/phi3_medium_14b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig

FULL = LMConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5_120, n_heads=40, n_kv_heads=10,
    d_ff=17_920, vocab=100_352, head_dim=128,
)

SMOKE = LMConfig(
    name="phi3-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=128,
    dtype=torch.float32,
)

SPEC = ArchSpec(arch_id="phi3-medium-14b", lm=FULL, smoke=SMOKE)
