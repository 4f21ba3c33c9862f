"""gemma3-12b [dense]: 5 local : 1 global attention, 262k vocab, GeGLU.
[hf:google/gemma-3]

The port's copy of ``src/repro/configs/gemma3_12b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig

FULL = LMConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3_840, n_heads=16, n_kv_heads=8,
    d_ff=15_360, vocab=262_144, head_dim=256,
    sliding_window=1_024, global_every=6, mlp="geglu",
)

SMOKE = LMConfig(
    name="gemma3-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    sliding_window=16, global_every=3, mlp="geglu", dtype=torch.float32,
)

SPEC = ArchSpec(
    arch_id="gemma3-12b", lm=FULL, smoke=SMOKE,
    notes=("head_dim=256 per the released model (d_model/n_heads would "
           "give 240; 256 is also MXU-aligned).  5:1 pattern realized as "
           "grouped scans with static windows: 8 groups of [5 local + 1 "
           "global].  long_500k skipped: the global layers keep full "
           "attention, so a 524k KV cache is a full-attention cost."),
)
