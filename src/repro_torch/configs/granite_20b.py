"""granite-20b [dense]: llama-arch code model with MQA (kv=1).
[arXiv:2405.04324]

The port's copy of ``src/repro/configs/granite_20b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig

FULL = LMConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6_144, n_heads=48, n_kv_heads=1,
    d_ff=24_576, vocab=49_152, head_dim=128, mlp="gelu",
)

SMOKE = LMConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=128,
    dtype=torch.float32,
)

SPEC = ArchSpec(
    arch_id="granite-20b", lm=FULL, smoke=SMOKE,
    notes=("MQA: the single KV head cannot shard over the model axis; "
           "decode shards the KV-cache sequence dim instead (LSE-combined "
           "distributed decode attention).  Non-gated GELU MLP "
           "(d_ff = 4*d_model, GPT-bigcode lineage) — a gated MLP at this "
           "d_ff would be a 28B model, not 20B."),
)
