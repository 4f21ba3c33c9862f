"""The port's config registry against the JAX package's: all ten
architectures, every ``FULL`` / ``SMOKE`` config equal field by field
(dtype and sub-configs mapped), the specs, shapes and input specs equal;
and ``examples/serve_lm_torch.py`` serving smoke configs on the CPU."""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from tests.test_torch_lm import to_torch_config
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
PORTED = ("qwen2.5-3b", "phi3-medium-14b", "granite-20b", "gemma3-12b",
          "pixtral-12b", "zamba2-7b", "grok-1-314b", "qwen2-moe-a2.7b",
          "xlstm-350m", "whisper-base")


def test_registry_holds_the_ported_archs():
    assert sorted(tconfigs.ARCHS) == sorted(PORTED)
    assert list(tconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert tconfigs.CNN_ARCHS == jconfigs.CNN_ARCHS


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("which", ("lm", "smoke"))
def test_configs_equal_jax_field_by_field(arch, which):
    want = getattr(jconfigs.get_arch(arch), which)
    got = getattr(tconfigs.get_arch(arch), which)
    assert got == to_torch_config(want)
    assert got.dtype == getattr(torch, jnp.dtype(want.dtype).name)


@pytest.mark.parametrize("arch", PORTED)
def test_specs_equal_jax(arch):
    want, got = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    for f in dataclasses.fields(want):
        if f.name not in ("lm", "smoke"):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.shapes == want.shapes and got.skips == want.skips


def test_shapes_and_input_specs_equal_jax():
    assert tbase.SHAPES == {k: tbase.ShapeSpec(**dataclasses.asdict(v))
                            for k, v in jbase.SHAPES.items()}
    for arch in PORTED:
        jcfg, tcfg = jconfigs.get_arch(arch).lm, tconfigs.get_arch(arch).lm
        for name, shape in jbase.SHAPES.items():
            want = jbase.input_specs(jcfg, shape)
            got = tbase.input_specs(tcfg, tbase.SHAPES[name])
            assert {k: (tuple(s.shape), jnp.dtype(s.dtype).name)
                    for k, s in want.items()} == \
                {k: (sh, str(dt).removeprefix("torch."))
                 for k, (sh, dt) in got.items()}
    want = jbase.decode_token_spec(jbase.SHAPES["decode_32k"])
    got = tbase.decode_token_spec(tbase.SHAPES["decode_32k"])
    assert {k: tuple(s.shape) for k, s in want.items()} == \
        {k: sh for k, (sh, _) in got.items()}


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_arch("gpt-5")


def _example():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ("zamba2-7b", "pixtral-12b", "whisper-base",
                                  "xlstm-350m"))
def test_serving_example_runs_a_smoke_config_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
         "--arch", arch, "--device", "cpu", "--batch", "2",
         "--prompt-len", "32", "--new", "4", "--temperature", "0"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"arch={arch} (smoke config" in out.stdout
    assert "generated 2x4 tokens" in out.stdout


def test_serving_example_is_greedy_deterministic_and_needs_a_card(
        monkeypatch):
    mod = _example()
    argv = ["--arch", "qwen2.5-3b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--new", "5", "--temperature", "0"]
    a, b = mod.main(argv), mod.main(argv)
    assert a["tokens"].shape == (2, 5)
    assert torch.equal(a["tokens"], b["tokens"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--arch", "qwen2.5-3b"])
