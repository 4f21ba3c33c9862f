"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block every 6
layers.  Sub-quadratic => long_500k runs.  [arXiv:2411.15242]

The port's copy of ``src/repro/configs/zamba2_7b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.ssm import SSMConfig

FULL = LMConfig(
    name="zamba2-7b", family="zamba",
    n_layers=81, d_model=3_584, n_heads=32, n_kv_heads=32,
    d_ff=14_336, vocab=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=256),
    shared_attn_every=6, sub_quadratic=True,
)

SMOKE = LMConfig(
    name="zamba2-smoke", family="zamba",
    n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    ssm=SSMConfig(d_state=16, head_dim=16, chunk=32),
    shared_attn_every=3, sub_quadratic=True, dtype=torch.float32,
)

SPEC = ArchSpec(
    arch_id="zamba2-7b", lm=FULL, smoke=SMOKE,
    notes=("One shared attention+MLP block (the paper interleaves two); "
           "81 = 13 groups of 6 + 3 trailing mamba layers.  long_500k "
           "decode state is O(1) in sequence length for the mamba layers; "
           "the 13 shared-attention applications keep per-application KV "
           "caches."),
)
