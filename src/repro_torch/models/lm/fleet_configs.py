"""The LM-fleet benchmark's block stacks that the port runs.

Copies of ``benchmarks/fig_lm_fleet.py:47-63`` (``CONFIGS``, one stack
per block family): ~120M-parameter-class stacks, scheduled at T=512 and
B=64 (``fig_lm_fleet.py:41-42``).  ``fleet-gla`` is the zamba stack that
runs both the flash-attention and the GLA kernels; ``fleet-moe`` runs
flash in every block (routed MoE of 8 experts, top-2, group 1024,
capacity 1.25) and ``fleet-xlstm`` the GLA at mLSTM heads of 256 with an
sLSTM block every 4.
"""
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.ssm import SSMConfig
from repro_torch.models.lm.xlstm import XLSTMConfig

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

FLEET_MOE = LMConfig(
    name="fleet-moe", family="moe", n_layers=10, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=1536, vocab=32_000,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=768))

FLEET_XLSTM = LMConfig(
    name="fleet-xlstm", family="xlstm", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=1536, vocab=32_000,
    xlstm=XLSTMConfig(n_heads=4, expand=2, slstm_every=4, chunk=128))
