"""The port's serving path (``build_model``, ``prefill``, ``decode_step``,
``generate``) against the JAX package's, on the same inputs.

Params are the JAX ``init(PRNGKey(0))`` of each smoke config, carried
into the port leaf by leaf (``model_params_from_numpy``); prompts and
prefix embeddings are drawn with numpy from a seed.  granite-20b's smoke
twin runs with the full config's ``mlp="gelu"``, so the non-gated MLP
is covered too.

* Plain paths: every leaf (logits, cache) within ``PLAIN_RTOL`` = 1e-5 of
  that leaf's largest magnitude.
* Greedy ``generate`` tokens are equal to the reference's.

The kernel paths (``use_flash``, ``use_gla_kernel``) are held in
tests/test_torch_serve_kernels.py; the moe, xlstm and encdec families in
tests/test_torch_serve_families.py, through the helpers here.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.lm.model import build_model as jax_build_model
from repro.serve import engine as jax_engine
from repro_torch.configs import get_arch
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.models.lm import model as tmodel
from repro_torch.serve import engine

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("qwen2.5-3b", "gemma3-12b", "pixtral-12b", "phi3-medium-14b",
         "granite-20b", "zamba2-7b")
VARIANT = {"granite-20b": {"mlp": "gelu"}}
B, T, N_DEC = 2, 32, 4
FRAMES = 40                      # encoder frames of an encdec prompt
PLAIN_RTOL = 1e-5


@pytest.fixture
def one_thread():
    """One intra-op thread for the test.  Tests of many small operations
    (routing, step loops, tile-by-tile emulations) slow down many-fold
    when several test processes share the cores and each thread pool
    spin-waits at every operation; alone, one thread costs them little."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_configs(arch: str, kernels: bool = False):
    """(JAX config, port config) of ``arch``'s smoke twin."""
    kw = dict(VARIANT.get(arch, {}))
    if kernels:
        kw.update(use_flash=True, use_gla_kernel=True)
    return (jax_get_arch(arch).smoke.variant(**kw),
            get_arch(arch).smoke.variant(**kw))


def prompt(cfg, seed: int = 0):
    """(numpy batch, all tokens [B, T + N_DEC], prefix length); an encdec
    batch also carries ``FRAMES`` frame embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T + N_DEC), dtype=np.int32)
    batch = {"tokens": toks[:, :T]}
    prefix = cfg.n_frontend_tokens
    if prefix:
        batch["embeds"] = rng.standard_normal(
            (B, prefix, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return batch, toks, prefix


def leaves(tree) -> list:
    """Leaves of a nested dict in sorted key order, as numpy."""
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy() if isinstance(t, torch.Tensor)
                     else np.asarray(t), tree,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))]


@functools.lru_cache(maxsize=None)
def run(arch: str, kernels: bool) -> dict:
    """Prefill, ``N_DEC`` teacher-forced decode steps and greedy
    ``generate`` in both packages from the same params and prompt."""
    return run_configs(*smoke_configs(arch, kernels))


def run_configs(jcfg, tcfg) -> dict:
    """``run`` on a (JAX config, port config) pair."""
    jm, tm = jax_build_model(jcfg), tmodel.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp))
    batch, toks, prefix = prompt(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    max_len = prefix + T + N_DEC
    out = {"jax": {"logits": [], "caches": []},
           "port": {"logits": [], "caches": []}}
    jl, jc = jm.prefill(jp, jb, max_len)
    tl, tc = tm.prefill(tp, tb, max_len)
    for i in range(N_DEC + 1):
        out["jax"]["logits"].append(np.asarray(jl))
        out["port"]["logits"].append(tl.numpy().copy())
        out["jax"]["caches"].append(leaves(jc))
        out["port"]["caches"].append([a.copy() for a in leaves(tc)])
        if i == N_DEC:
            break
        tok = toks[:, T + i][:, None]
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc,
                                jnp.int32(prefix + T + i))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc,
                                prefix + T + i)
    out["jax"]["tokens"] = np.asarray(jax_engine.generate(
        jm, jp, jb, max_len=max_len, n_new=N_DEC).tokens)
    engine.clear_decode_cache()
    out["port"]["tokens"] = engine.generate(
        tm, tp, tb, max_len=max_len, n_new=N_DEC).tokens.numpy()
    engine.clear_decode_cache()
    return out


def assert_plain_close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    top = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= PLAIN_RTOL * top, f"{what}: {err:.3e} > 1e-5 of {top:.3e}"


def check(arch: str, kernels: bool, steps, close=None, out=None) -> None:
    """Logits and every cache leaf after prefill (step 0) and each
    decode step in ``steps``, held by ``close(got, want, what)`` (the
    plain rule by default), of ``run(arch, kernels)`` or of ``out``."""
    out = out or run(arch, kernels)
    close = close or assert_plain_close
    for i in steps:
        what = f"{arch} {'prefill' if i == 0 else f'decode step {i}'}"
        pairs = [("logits", out["port"]["logits"][i],
                  out["jax"]["logits"][i])]
        pairs += [(f"cache leaf {j}", g, w) for j, (g, w) in enumerate(
            zip(out["port"]["caches"][i], out["jax"]["caches"][i]))]
        assert len(out["port"]["caches"][i]) == len(out["jax"]["caches"][i])
        for name, g, w in pairs:
            close(g, w, f"{what} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    check(arch, False, [0])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    check(arch, False, range(1, N_DEC + 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_jax(arch):
    out = run(arch, False)
    assert out["port"]["tokens"].shape == (B, N_DEC)
    np.testing.assert_array_equal(out["port"]["tokens"],
                                  out["jax"]["tokens"])


# ---------------------------------------------------------------------------
# decode == forward, within the port (tests/test_serve_consistency.py)
# ---------------------------------------------------------------------------


def hidden_logits(model, cfg, params, batch):
    """Per-position logits from the training-path forward."""
    h = model.hidden_fn(params, batch)
    h = tmodel._apply_norm(cfg, params["final_norm"], h)
    if "embeds" in batch:
        h = h[:, batch["embeds"].shape[1]:]
    return (h @ params["lm_head"]).float()


def decode_matches_forward(arch: str) -> None:
    """The port's decode steps against its own forward (``hidden_fn``) at
    tests/test_serve_consistency.py's 2e-3, on the port's seeded init."""
    cfg = get_arch(arch).smoke
    model = tmodel.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch, toks, prefix = prompt(cfg, seed=1)
    full_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    full_batch["tokens"] = torch.from_numpy(toks)
    with torch.no_grad():
        full = hidden_logits(model, cfg, params, full_batch).numpy()
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        logits, cache = model.prefill(params, tb, prefix + T + N_DEC)
        np.testing.assert_allclose(logits.numpy(), full[:, T - 1],
                                   rtol=2e-3, atol=2e-3)
        for i in range(N_DEC - 1):
            tok = torch.from_numpy(toks[:, T + i][:, None])
            logits, cache = model.decode_step(params, tok, cache,
                                              prefix + T + i)
            np.testing.assert_allclose(
                logits.numpy(), full[:, T + i], rtol=2e-3, atol=2e-3,
                err_msg=f"{arch} decode position {T + i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port of tests/test_serve_consistency.py::test_decode_matches_forward
    at its 2e-3, on the port's own seeded init."""
    decode_matches_forward(arch)


# ---------------------------------------------------------------------------
# training objective, init, params across the boundary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("qwen2.5-3b", "pixtral-12b", "zamba2-7b"))
def test_hidden_and_loss_match_jax(arch):
    hidden_and_loss_match(*smoke_configs(arch), arch)


def hidden_and_loss_match(jcfg, tcfg, arch: str, close=None) -> None:
    """``hidden_fn`` held by ``close`` (the plain rule by default) and
    ``loss_fn`` within 1e-5 of JAX's, from the same params and batch."""
    close = close or assert_plain_close
    jcfg, tcfg = jcfg.variant(loss_chunk=8), tcfg.variant(loss_chunk=8)
    jm, tm = jax_build_model(jcfg), tmodel.build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp))
    batch, _, _ = prompt(jcfg, seed=2)
    rng = np.random.default_rng(3)
    batch["targets"] = rng.integers(0, jcfg.vocab, (B, T), dtype=np.int32)
    batch["mask"] = (rng.random((B, T)) < 0.8).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        close(tm.hidden_fn(tp, tb).numpy(), jm.hidden_fn(jp, jb),
              f"{arch} hidden")
        loss = float(tm.loss_fn(tp, tb))
    want = float(jm.loss_fn(jp, jb))
    assert abs(loss - want) <= PLAIN_RTOL * abs(want), (loss, want)


def test_loss_fn_trains_under_remat():
    """``cfg.remat`` recomputes blocks in the backward: same gradients."""
    _, cfg = smoke_configs("zamba2-7b")
    batch, _, _ = prompt(cfg, seed=4)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["targets"] = torch.from_numpy(prompt(cfg, seed=5)[0]["tokens"])
    grads = []
    for remat in (True, False):
        model = tmodel.build_model(cfg.variant(remat=remat))
        params = model.init(torch.Generator().manual_seed(0))
        leaf = params["mamba"]["m"]["in_proj"].requires_grad_(True)
        model.loss_fn(params, tb).backward()
        grads.append(leaf.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ("gemma3-12b", "zamba2-7b"))
def test_init_has_the_reference_layout_and_per_layer_fan_in(arch):
    """Shapes and dtypes of every leaf equal the JAX ``init``'s; each
    stacked layer is drawn at its own shape (std 0.88 / sqrt(fan_in), not
    / sqrt(n_layers)) and apart from the others; the generator seeds it."""
    jcfg, tcfg = smoke_configs(arch)
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    model = tmodel.build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(0))
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), params,
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert got == jax.tree.map(
        lambda s: (tuple(s.shape), f"torch.{jnp.dtype(s.dtype).name}"),
        want)
    stacked = params["layers"]["attn"]["wq"] if "layers" in params \
        else params["mamba"]["m"]["in_proj"]
    fan_in = stacked.shape[1]
    trunc_std = 0.8796                     # N(0, 1) truncated to [-2, 2]
    for layer in stacked:
        std = float(layer.std()) * fan_in ** 0.5
        assert abs(std - trunc_std) < 0.05, std
    assert not torch.equal(stacked[0], stacked[1])
    again = model.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        tmodel._leaves(params), tmodel._leaves(again)))
    assert tmodel.param_count(params) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    assert tmodel.active_param_count(tcfg, params) == \
        tmodel.param_count(params)


def test_model_params_round_trip_bf16_bitwise():
    jcfg, _ = smoke_configs("zamba2-7b")
    jp = jax_build_model(jcfg.variant(dtype=jnp.bfloat16)).init(
        jax.random.PRNGKey(0))
    tp = model_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["mamba"]["m"]["in_proj"].dtype == torch.bfloat16
    assert tp["mamba"]["m"]["A_log"].dtype == torch.float32
    back = model_params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.asarray(a).dtype.name == jnp.asarray(b, a.dtype).dtype.name
        np.testing.assert_array_equal(
            np.asarray(a).view(np.uint8),
            np.asarray(jnp.asarray(b, a.dtype)).view(np.uint8))

