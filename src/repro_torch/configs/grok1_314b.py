"""grok-1-314b [moe]: 8-expert top-2 MoE decoder.  [hf:xai-org/grok-1]

The port's copy of ``src/repro/configs/grok1_314b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.moe import MoEConfig

FULL = LMConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6_144, n_heads=48, n_kv_heads=8,
    d_ff=32_768, vocab=131_072, head_dim=128,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32_768),
)

SMOKE = LMConfig(
    name="grok-1-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=0, vocab=128,
    # generous capacity so smoke tests see no token dropping (capacity
    # dropping makes prefill/decode batch-context-dependent by design)
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                  capacity_factor=8.0),
    dtype=torch.float32,
)

SPEC = ArchSpec(
    arch_id="grok-1-314b", lm=FULL, smoke=SMOKE, optimizer="sgdm",
    notes=("~86% of parameters live in experts — the strongest case for "
           "HierTrain tiered sync (expert tier crosses the pod axis "
           "int8-quantized).  SGD+momentum optimizer: AdamW f32 state for "
           "314B params would not fit 256x16GB HBM."),
)
