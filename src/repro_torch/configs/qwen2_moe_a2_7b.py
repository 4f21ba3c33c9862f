"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]

The port's copy of ``src/repro/configs/qwen2_moe_a2_7b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.moe import MoEConfig

FULL = LMConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2_048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab=151_936, qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1_408,
                  n_shared=4, d_ff_shared=5_632),
)

SMOKE = LMConfig(
    name="qwen2-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=128,
    qkv_bias=True,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=32,
                  n_shared=2, d_ff_shared=64, capacity_factor=8.0),
    dtype=torch.float32,
)

SPEC = ArchSpec(arch_id="qwen2-moe-a2.7b", lm=FULL, smoke=SMOKE)
