"""``chip_smoke.SERVE_TOL`` of gemma3-12b (heads of 256, five windowed
layers to one global) and pixtral-12b (a prefix of patch embeddings),
measured as tests/test_torch_serve_kernels.py measures qwen2.5-3b's (its
``CUT`` configs: served depth, heads, KV heads and head widths kept;
d_model, FF and vocab cut; B=2, T=512 positions; the bf16 kernels'
rounding emulated); and ``chip_smoke.py``'s serving phase rehearsed on
the CPU on both archs' smoke twins, through ``run_serve``, prefix and
windows included.  A file of its own, so the serving tests spread over
the workers.
"""
from __future__ import annotations

import types

import pytest
import torch

import chip_smoke
from repro_torch import configs
from repro_torch.configs import (gemma3_12b, granite_20b, phi3_medium_14b,
                                 pixtral_12b)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gs
from repro_torch.kernels import int8_quant as iq
from repro_torch.models.lm import model as tmodel
from repro_torch.serve import engine
from tests.test_torch_serve import one_thread  # noqa: F401
from tests.test_torch_serve_kernels import (DENSE_WIDE,
                                            check_serving_tolerances,
                                            emulated_kernels)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch", DENSE_WIDE)
def test_chip_serving_tolerances_hold_twice_the_emulated_bf16_error(
        arch, emulated_kernels):
    check_serving_tolerances(arch)


@pytest.mark.parametrize("cfg,flash", [
    (gemma3_12b.FULL, 48), (phi3_medium_14b.FULL, 40),
    (granite_20b.FULL, 52), (pixtral_12b.FULL, 40)])
def test_chip_smoke_counts_one_flash_per_layer_per_prefill(cfg, flash):
    assert chip_smoke.serve_launches(cfg) == {
        "int8_quant": 0, "flash_attention": flash, "gla_scan": 0}


def test_pixtral_prompt_is_patch_embeddings_then_tokens():
    """At the card's 2,048 positions: 1,024 embeddings (``input_specs``'
    min(n_frontend_tokens, T // 2)), 1,024 tokens, and room for the new
    tokens after both."""
    cfg = pixtral_12b.FULL
    spec = configs.base.input_specs(
        cfg, configs.base.ShapeSpec("card", chip_smoke.SERVE_T, 1, "prefill"))
    batch, toks, max_len = chip_smoke.serve_inputs(
        torch, cfg, torch.Generator().manual_seed(0), 1, chip_smoke.SERVE_T)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: s for k, (s, _) in spec.items()}
    assert batch["embeds"].dtype == spec["embeds"][1] == torch.bfloat16
    assert chip_smoke.prefix_len(batch) == 1024
    assert tuple(toks.shape) == (1, 1024 + chip_smoke.SERVE_TF)
    assert torch.equal(toks[:, :1024], batch["tokens"])
    assert max_len == chip_smoke.SERVE_T + chip_smoke.SERVE_NEW


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "whisper-base"])
def test_prompts_without_a_frontend_prefix(arch):
    cfg = configs.get_arch(arch).smoke
    batch, toks, max_len = chip_smoke.serve_inputs(
        torch, cfg, torch.Generator().manual_seed(0), 2, 32)
    assert "embeds" not in batch and chip_smoke.prefix_len(batch) == 0
    n_tok = batch["tokens"].shape[1]
    assert tuple(toks.shape) == (2, n_tok + chip_smoke.SERVE_TF)
    if arch == "whisper-base":
        assert n_tok == chip_smoke.WHISPER_T
        assert max_len == chip_smoke.WHISPER_MAX_LEN
    else:
        assert n_tok == 32 and max_len == 32 + chip_smoke.SERVE_NEW


@pytest.mark.parametrize("arch", DENSE_WIDE)
def test_run_serve_rehearsed_on_the_smoke_twin(arch, monkeypatch):
    """``chip_smoke.run_serve`` on the CPU: the smoke twin (f32), the
    card's calls stubbed, the wrappers counting their CPU calls.  Launches
    exact, greedy runs equal, (a) and (b) at the f32 plain paths' level;
    pixtral's decode positions start after its prefix."""
    make = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device=None: make())
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda: 0)
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, fn, label: (
        fn(), {"device_busy_ms": 0.0, "wall_ms": 1.0})[1])
    twin = configs.get_arch(arch).smoke
    monkeypatch.setattr(configs, "get_arch",
                        lambda a: types.SimpleNamespace(lm=twin))
    for name, value in (("SERVE_T", 32), ("SERVE_NEW", 4), ("SERVE_TF", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setitem(chip_smoke.SERVE_TOL, arch, (1e-5, 1e-3))
    kernels = {"int8_quant": iq, "flash_attention": fa, "gla_scan": gs}
    for mod, fn in ((fa, "flash_attention_fwd"), (gs, "gla_scan_fwd")):
        def counted(*args, _mod=mod, _fn=getattr(mod, fn), **kw):
            _mod.launches += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, fn, counted)
    res = chip_smoke.run_serve(torch, kernels, configs, tmodel, engine, arch)
    P = min(twin.n_frontend_tokens, 32 // 2)
    assert (res["prefix"], res["prompt"]) == (P, 32 - P)
    assert res["launches"]["flash_attention"] == twin.n_layers
    assert res["max_len"] == 32 + 4
