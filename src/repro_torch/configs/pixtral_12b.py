"""pixtral-12b [vlm]: mistral-nemo decoder backbone; pixtral-ViT patch
frontend STUB (precomputed patch embeddings).  [hf:mistralai/Pixtral-12B]

The port's copy of ``src/repro/configs/pixtral_12b.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig

FULL = LMConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5_120, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab=131_072, head_dim=128,
    n_frontend_tokens=1_024, rope_theta=1e6,
)

SMOKE = LMConfig(
    name="pixtral-12b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
    n_frontend_tokens=8, dtype=torch.float32,
)

SPEC = ArchSpec(
    arch_id="pixtral-12b", lm=FULL, smoke=SMOKE,
    notes=("ViT frontend is a stub: input_specs supplies [B, 1024, d_model] "
           "patch embeddings prepended to the token sequence; prefix "
           "positions carry no LM loss."),
)
