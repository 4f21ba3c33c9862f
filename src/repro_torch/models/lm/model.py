"""LM model zoo: the config dataclass and the blocks the layer stack runs.

The port of the training blocks of :mod:`repro.models.lm.model`:
``LMConfig`` (``dtype`` is a ``torch.dtype``), the norm and MLP
dispatch, and the transformer block that the dense family stacks and
the zamba family interleaves with its Mamba2 blocks.  The MoE block,
``build_model`` and the prefill/decode paths come with their slices
(ROADMAP.md).  Field names and defaults are the JAX config's, so a
config converts field by field (``moe`` and ``xlstm`` hold the JAX
package's sub-configs only as opaque values until those families land).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.common import (Params, apply_geglu,
                                          apply_gelu_mlp, apply_swiglu,
                                          init_gelu_mlp, init_swiglu,
                                          layer_norm, rms_norm)
from repro_torch.models.lm.ssm import SSMConfig


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                     # dense | moe | zamba | xlstm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0         # local attention width (0 = full)
    global_every: int = 0           # gemma3: every k-th layer is global
    moe: Optional[Any] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[Any] = None
    shared_attn_every: int = 0      # zamba
    encoder_layers: int = 0
    n_frontend_tokens: int = 0      # stub prefix length (frames / patches)
    norm: str = "rms"               # rms | layer
    mlp: str = "swiglu"             # swiglu | geglu | gelu
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "none"      # none | dots
    loss_chunk: int = 512
    attn_block_q: int = 512         # blocked-attention q tile (0 = off)
    seq_parallel: bool = False      # Megatron-SP residual (T over model)
    use_flash: bool = False
    use_gla_kernel: bool = False
    sub_quadratic: bool = False     # True => long_500k decode is eligible

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def variant(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# norm / mlp dispatch
# ---------------------------------------------------------------------------

def _init_norm(cfg: LMConfig, device=None) -> Params:
    if cfg.norm == "layer":
        return {"w": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                device=device),
                "b": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                 device=device)}
    return {"w": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)}


def _apply_norm(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layer":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


def _init_mlp(generator: torch.Generator, cfg: LMConfig, device=None
              ) -> Params:
    if cfg.mlp == "gelu":
        return init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype,
                             device)
    return init_swiglu(generator, cfg.d_model, cfg.d_ff, cfg.dtype, device)


def _apply_mlp(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "gelu":
        return apply_gelu_mlp(p, x)
    if cfg.mlp == "geglu":
        return apply_geglu(p, x)
    return apply_swiglu(p, x)


# ---------------------------------------------------------------------------
# transformer block (dense family; also zamba's attention block)
# ---------------------------------------------------------------------------

def _init_block(generator: torch.Generator, cfg: LMConfig, device=None
                ) -> Params:
    return {
        "ln1": _init_norm(cfg, device),
        "attn": attn.init_attention(generator, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, cfg.dtype,
                                    cfg.qkv_bias, device=device),
        "ln2": _init_norm(cfg, device),
        "mlp": _init_mlp(generator, cfg, device),
    }


def _apply_block(cfg: LMConfig, p: Params, x: torch.Tensor, window: int,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True) -> torch.Tensor:
    h = _apply_norm(cfg, p["ln1"], x)
    h = attn.self_attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, causal=causal, rope_theta=cfg.rope_theta,
        window=window, positions=positions, use_flash=cfg.use_flash)
    x = x + h
    h = _apply_norm(cfg, p["ln2"], x)
    return x + _apply_mlp(cfg, p["mlp"], h)


def _group_layout(cfg: LMConfig) -> Tuple[int, int, int]:
    """(n_groups, group_size, n_rest) of the local/global layer pattern.

    group_size == 0 means "uniform window" (no grouping).
    """
    if cfg.sliding_window and cfg.global_every:
        g = cfg.global_every
        return cfg.n_layers // g, g, cfg.n_layers % g
    return 0, 0, cfg.n_layers
