"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention block every 6
layers (arXiv:2411.15242).  The port's copy of
``src/repro/configs/zamba2_7b.py:9-15`` (``FULL``), dtype as a
``torch.dtype``."""
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.ssm import SSMConfig

FULL = LMConfig(
    name="zamba2-7b", family="zamba",
    n_layers=81, d_model=3_584, n_heads=32, n_kv_heads=32,
    d_ff=14_336, vocab=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, chunk=256),
    shared_attn_every=6, sub_quadratic=True,
)
