"""Architecture registry: ``--arch <id>`` lookup for every ported
architecture plus the paper's own CNNs (lenet5 / alexnet, which run on
the HierTrain mobile-edge-cloud scheduler rather than the LM runtime).

The port of :mod:`repro.configs`: all ten of the reference's
architectures.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (gemma3_12b, granite_20b, grok1_314b,
                                 phi3_medium_14b, pixtral_12b, qwen2_5_3b,
                                 qwen2_moe_a2_7b, whisper_base, xlstm_350m,
                                 zamba2_7b)
from repro_torch.configs.base import (SHAPES, ArchSpec, ShapeSpec,
                                      decode_token_spec, input_specs)

ARCHS: Dict[str, ArchSpec] = {
    spec.arch_id: spec
    for spec in (
        whisper_base.SPEC, pixtral_12b.SPEC, grok1_314b.SPEC,
        qwen2_moe_a2_7b.SPEC, zamba2_7b.SPEC, xlstm_350m.SPEC,
        phi3_medium_14b.SPEC, gemma3_12b.SPEC, qwen2_5_3b.SPEC,
        granite_20b.SPEC,
    )
}

# The paper's own evaluation models (layered CNNs on the MECC hierarchy).
CNN_ARCHS = ("lenet5", "alexnet")


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}"
                       f" + CNNs {CNN_ARCHS}")
    return ARCHS[arch_id]


__all__ = ["ARCHS", "CNN_ARCHS", "SHAPES", "ArchSpec",
           "ShapeSpec", "get_arch", "input_specs", "decode_token_spec"]
