"""The port's serving path for the moe, xlstm and encdec families against
the JAX package's, on the same inputs (the helpers of
tests/test_torch_serve.py).

The smoke twins of qwen2-moe-a2.7b, grok-1-314b, xlstm-350m and
whisper-base take JAX ``init(PRNGKey(0))`` params carried over leaf by
leaf; prompts and whisper's frames are drawn with numpy from a seed.

* Plain paths: prefill logits, every cache leaf and 4 decode steps, and
  ``hidden_fn`` / ``loss_fn``, within 1e-5 of each leaf's largest
  magnitude; greedy ``generate`` tokens equal.
* Kernel routes (``use_flash``, ``use_gla_kernel``): the port's kernels'
  plain versions (CPU tensors) against JAX's Pallas kernels in interpret
  mode, at the f32 ``flash_o`` (moe, encdec) or ``gla_y`` (xlstm) budget
  taken at each leaf's largest magnitude.
The wide-head xLSTM (mLSTM heads of 512) against JAX is in
tests/test_torch_xlstm.py; ``chip_smoke.SERVE_TOL`` of these families'
served archs in tests/test_torch_serve_tolerances.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm.model import build_model as jax_build_model
from repro_torch.models.lm import model as tmodel
from tests import test_torch_serve as ts
from tests.test_torch_serve import one_thread  # noqa: F401
from tests.test_torch_serve_kernels import budget_close

jax.config.update("jax_platform_name", "cpu")
pytestmark = pytest.mark.usefixtures("one_thread")

FAMILIES = ("qwen2-moe-a2.7b", "grok-1-314b", "xlstm-350m", "whisper-base")
KIND = {"xlstm-350m": "gla_y"}          # the budget of the kernel route


def kind(arch: str) -> str:
    return KIND.get(arch, "flash_o")


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_logits_and_cache_match_jax(arch):
    ts.check(arch, False, [0])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_steps_match_jax(arch):
    ts.check(arch, False, range(1, ts.N_DEC + 1))


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_greedy_tokens_equal_jax(arch):
    out = ts.run(arch, False)
    assert out["port"]["tokens"].shape == (ts.B, ts.N_DEC)
    np.testing.assert_array_equal(out["port"]["tokens"],
                                  out["jax"]["tokens"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_kernel_paths_match_jax_interpret(arch):
    ts.check(arch, True, range(ts.N_DEC + 1), budget_close(kind(arch)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_kernel_path_generate_greedy_tokens_equal_jax(arch):
    out = ts.run(arch, True)
    np.testing.assert_array_equal(out["port"]["tokens"],
                                  out["jax"]["tokens"])


def forward_close(cfg):
    """The kernel budget for ``hidden_fn``'s output, the residual stream
    after every block: one call's budget per block that runs a kernel
    (at most ``n_layers + encoder_layers``), since their errors add."""
    arch = {"moe": "grok-1-314b", "xlstm": "xlstm-350m",
            "encdec": "whisper-base"}[cfg.family]
    return budget_close(kind(arch), cfg.n_layers + cfg.encoder_layers)


@pytest.mark.parametrize("kernels", (False, True), ids=("plain", "kernels"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_hidden_and_loss_match_jax(arch, kernels):
    jcfg, tcfg = ts.smoke_configs(arch, kernels)
    close = forward_close(tcfg) if kernels else None
    ts.hidden_and_loss_match(jcfg, tcfg, arch, close)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    ts.decode_matches_forward(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_has_the_reference_layout_and_counts(arch):
    """Shapes and dtypes of every leaf equal the JAX ``init``'s; the
    generator seeds it; parameter counts (MoE: the active top-k share)
    equal the reference's accounting."""
    from repro.models.lm import model as jmodel
    jcfg, tcfg = ts.smoke_configs(arch)
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    model = tmodel.build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), params,
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert got == jax.tree.map(
        lambda s: (tuple(s.shape), f"torch.{jnp.dtype(s.dtype).name}"),
        want)
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        tmodel._leaves(params), tmodel._leaves(again)))
    jp = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert tmodel.param_count(params) == jmodel.param_count(jp)
    assert tmodel.active_param_count(tcfg, params) == \
        jmodel.active_param_count(jcfg, jp)
    if tcfg.family == "moe":
        assert tmodel.active_param_count(tcfg, params) < \
            tmodel.param_count(params)


def test_encdec_cache_holds_cross_kv_of_the_frames():
    """whisper's cache carries the cross-attention K/V of every frame
    (``init_cache(batch, max_len, enc_len)``); decode leaves them as they
    are and writes its own row of the self-attention K/V in place."""
    out = ts.run("whisper-base", False)
    caches = out["port"]["caches"]
    # sorted leaves: k, v, xk, xv
    assert caches[0][2].shape[2] == ts.FRAMES
    for step in caches[1:]:
        np.testing.assert_array_equal(step[2], caches[0][2])
        np.testing.assert_array_equal(step[3], caches[0][3])
    _, tcfg = ts.smoke_configs("whisper-base")
    empty = tmodel.build_model(tcfg).init_cache(ts.B, 8)
    assert sorted(empty) == ["k", "v"]
