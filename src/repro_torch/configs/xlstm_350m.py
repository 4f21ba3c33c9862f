"""xlstm-350m [ssm]: mLSTM blocks with an sLSTM block every 8 (7:1).
Sub-quadratic => long_500k runs.  [arXiv:2405.04517]

The port's copy of ``src/repro/configs/xlstm_350m.py``, dtype as a
``torch.dtype``."""
import torch

from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm.model import LMConfig
from repro_torch.models.lm.xlstm import XLSTMConfig

FULL = LMConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1_024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50_304, rope_theta=0.0,
    xlstm=XLSTMConfig(n_heads=4, expand=2, d_conv=4, slstm_every=8,
                      chunk=256),
    sub_quadratic=True,
)

SMOKE = LMConfig(
    name="xlstm-smoke", family="xlstm",
    n_layers=6, d_model=64, n_heads=2, n_kv_heads=2, d_ff=0, vocab=128,
    rope_theta=0.0,
    xlstm=XLSTMConfig(n_heads=2, slstm_every=3, chunk=32),
    sub_quadratic=True, dtype=torch.float32,
)

SPEC = ArchSpec(
    arch_id="xlstm-350m", lm=FULL, smoke=SMOKE,
    notes="d_ff=0: xLSTM blocks carry their own up/down projections.",
)
