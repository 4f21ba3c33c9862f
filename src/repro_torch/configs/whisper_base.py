"""whisper-base [audio]: enc-dec transformer backbone, conv frontend STUB
(precomputed frame embeddings are inputs).  [arXiv:2212.04356]

The port's copy of ``src/repro/configs/whisper_base.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig

FULL = LMConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51_865,
    encoder_layers=6, norm="layer", mlp="gelu", rope_theta=0.0,
)

SMOKE = LMConfig(
    name="whisper-base-smoke", family="encdec",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128,
    encoder_layers=2, norm="layer", mlp="gelu", rope_theta=0.0,
    dtype=torch.float32,
)

SPEC = ArchSpec(
    arch_id="whisper-base", lm=FULL, smoke=SMOKE,
    notes=("audio frontend (2x conv) is a stub per the assignment: "
           "input_specs supplies [B, T, d_model] frame embeddings. "
           "Sinusoidal positions on both encoder and decoder."),
)
