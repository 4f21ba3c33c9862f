"""The port's layered CNNs against the JAX package's, on the same inputs.

Params have the shapes of the JAX ``LayeredModel.init`` and He-normal
values drawn with numpy from a seed (JAX's own random init takes seconds
per model to compile on the CPU); they cross the package boundary as
numpy arrays, as do the batches.  The
tolerance is rtol 1e-5 plus an atol of 1e-6 per unit of the output's
largest magnitude: the two frameworks sum the terms of a convolution or
a matmul in different f32 orders, and that rounding error scales with
the size of the terms, not with each (possibly cancelled) output
element.  Measured: at most 6e-7 of the largest magnitude (lenet5).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layerstack import as_layerstack as jax_as_layerstack
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.layerstack import as_layerstack
from repro_torch.models import cnn as tcnn
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-6


def assert_close(got, want, rtol: float = RTOL, atol: float = ATOL):
    """``|got - want| <= rtol * |want| + atol * max(1, max |want|)``."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.max(np.abs(want), initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def tiny_mlp(mod, n_dense: int = 4, width: int = 16, num_classes: int = 5):
    """The tiny MLP of tests/test_hybrid_step.py, in either package."""
    specs = tuple(mod.DenseSpec(f"fc{i}", width) for i in range(n_dense - 1)) \
        + (mod.DenseSpec("out", num_classes, relu=False),)
    return mod.LayeredModel("tiny_mlp", specs, (8,), num_classes)


def alexnet_narrow(mod):
    """AlexNet at 64x64 with channels / 8 and fc 512: the stride-4 SAME
    conv1 (asymmetric XLA padding) and every pool stay."""
    s = mod.alexnet().specs
    specs = tuple(
        dataclasses.replace(sp, out_ch=sp.out_ch // 8)
        if isinstance(sp, mod.ConvSpec) else
        dataclasses.replace(sp, out=512) if sp.relu else sp for sp in s)
    return mod.LayeredModel("alexnet_narrow", specs, (64, 64, 3), 200)


MODELS = {
    "lenet5": lambda mod: mod.lenet5(),
    "tiny_mlp": tiny_mlp,
    "alexnet_narrow": alexnet_narrow,
}


def model_pair(name: str):
    """(JAX model, port model) of the same architecture."""
    return MODELS[name](jcnn), MODELS[name](tcnn)


def jax_params(jmodel, seed: int):
    """Params in the shapes of the JAX ``init`` as a numpy list (the
    exchange format): He-normal weights, small nonzero biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    out = []
    for p in shapes:
        w = p["w"].shape
        out.append({
            "w": (rng.normal(size=w) * np.sqrt(2.0 / np.prod(w[:-1])))
            .astype(np.float32),
            "b": (0.1 * rng.normal(size=p["b"].shape)).astype(np.float32)})
    return out


def to_jax(params_np):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params_np]


def batch(model, B: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B,) + tuple(model.input_shape)).astype(np.float32)
    y = rng.integers(0, model.num_classes, size=B).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", ["lenet5", "alexnet", "alexnet_tiny"])
def test_cut_meta_equals_jax(name):
    jm = getattr(jcnn, name)()
    tm = getattr(tcnn, name)()
    jmeta = jax_as_layerstack(jm).cut_meta()
    tmeta = as_layerstack(tm).cut_meta()
    assert [dataclasses.asdict(m) for m in tmeta] == \
        [dataclasses.asdict(m) for m in jmeta]
    assert as_layerstack(tm).default_sample_bytes() == \
        jax_as_layerstack(jm).default_sample_bytes()
    assert [dataclasses.asdict(m) for m in tm.layer_meta()] == \
        [dataclasses.asdict(m) for m in jm.layer_meta()]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_and_sum_loss_match_jax(name):
    jm, tm = model_pair(name)
    p_np = jax_params(jm, seed=3)
    x, y = batch(jm, 5, seed=4)
    jout = np.asarray(jax.jit(jm.apply)(to_jax(p_np), jnp.asarray(x)))
    tout = tm.apply(params_from_numpy(p_np), torch.from_numpy(x))
    assert_close(tout, jout)
    # the loss heads on the same logits
    jloss = float(jax_as_layerstack(jm).sum_loss(jnp.asarray(jout),
                                                 jnp.asarray(y)))
    tloss = float(as_layerstack(tm).sum_loss(torch.from_numpy(jout.copy()),
                                             torch.from_numpy(y)))
    assert tloss == pytest.approx(jloss, rel=RTOL, abs=ATOL)
    assert float(tm.loss(params_from_numpy(p_np), torch.from_numpy(x),
                         torch.from_numpy(y))) == pytest.approx(
        float(jax.jit(jm.loss)(to_jax(p_np), jnp.asarray(x),
                               jnp.asarray(y))), rel=RTOL, abs=ATOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_segments_compose_to_apply(name):
    """Cut-point segments chain to the whole model, and each segment
    matches the JAX segment on the same input."""
    jm, tm = model_pair(name)
    p_np = jax_params(jm, seed=5)
    x, _ = batch(jm, 3, seed=6)
    tp, jp = params_from_numpy(p_np), to_jax(p_np)
    cur_t, cur_j = torch.from_numpy(x), jnp.asarray(x)
    for i in range(tm.num_layers):
        nxt_t = tm.apply_segment(tp, cur_t, i, i + 1)
        nxt_j = np.asarray(jax.jit(jm.apply_layer, static_argnums=2)(
            jp[i], cur_j, i))
        assert_close(nxt_t, nxt_j)
        # feed both packages the same input at every cut
        cur_t, cur_j = torch.from_numpy(nxt_j.copy()), jnp.asarray(nxt_j)
    whole = tm.apply(tp, torch.from_numpy(x))
    chained = tm.apply_segment(tp, tm.apply_segment(tp, torch.from_numpy(x),
                                                    0, 2), 2, tm.num_layers)
    assert torch.equal(whole, chained)


def test_same_padding_is_xla_split():
    """conv1 of AlexNet: 224 at stride 4 with an 11 kernel pads 7 as
    (3, 4); the stride-1 layers pad symmetrically."""
    assert tcnn._same_pads(224, 11, 4) == (3, 4)
    assert tcnn._same_pads(64, 11, 4) == (3, 4)
    assert tcnn._same_pads(27, 5, 1) == (2, 2)
    assert tcnn._same_pads(13, 3, 1) == (1, 1)


def test_init_shapes_seeded_and_round_trip():
    tm = tcnn.lenet5()
    jm = jcnn.lenet5()
    a = tm.init(torch.Generator().manual_seed(0))
    b = tm.init(torch.Generator().manual_seed(0))
    j = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    for pa, pb, pj in zip(a, b, j):
        for k in ("w", "b"):
            assert tuple(pa[k].shape) == pj[k].shape
            assert pa[k].dtype == torch.float32
            assert torch.equal(pa[k], pb[k])
    back = params_from_numpy(params_to_numpy(a))
    assert all(torch.equal(p[k], q[k]) for p, q in zip(a, back) for k in p)
