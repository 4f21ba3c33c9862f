"""The LM-fleet benchmark's block stacks that the port runs.

Copies of ``benchmarks/fig_lm_fleet.py:47-55`` (``CONFIGS["attention"]``
and ``CONFIGS["gla"]``): ~120M-parameter-class stacks, scheduled at
T=512 and B=64 (``fig_lm_fleet.py:41-42``).  ``fleet-gla`` is the zamba
stack that runs both the flash-attention and the GLA kernels.
"""
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.ssm import SSMConfig

SEQ_LEN = 512
BATCH = 64

FLEET_ATTN = LMConfig(
    name="fleet-attn", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=4, d_ff=1536, vocab=32_000)

FLEET_GLA = LMConfig(
    name="fleet-gla", family="zamba", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=1536, vocab=32_000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
    shared_attn_every=4)
