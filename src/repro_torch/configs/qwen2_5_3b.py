"""qwen2.5-3b [dense]: GQA kv=2, QKV bias.  [hf:Qwen/Qwen2.5]

The port's copy of ``src/repro/configs/qwen2_5_3b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig

FULL = LMConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2_048, n_heads=16, n_kv_heads=2,
    d_ff=11_008, vocab=151_936, qkv_bias=True,
)

SMOKE = LMConfig(
    name="qwen2.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    qkv_bias=True, dtype=torch.float32,
)

SPEC = ArchSpec(arch_id="qwen2.5-3b", lm=FULL, smoke=SMOKE)
