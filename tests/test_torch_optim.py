"""The port's optimizers: each case of tests/test_optim.py, and five
steps of ``SGDMomentum`` and ``AdamW`` against their JAX twins on the same
numpy params and gradients, with global-norm clipping and weight decay.

The two libraries sum the global norm in different orders, so it and the
clip scale can differ by one ulp (measured: at three of five steps), and
each library takes ``1 - b ** step`` from its own ``pow``.  So f32 params
are held within ``F32_ULPS`` ulps of the leaf's largest magnitude
(measured at most 0.5), the f32 states within ``STATE_ULPS`` (measured:
momentum 2, AdamW's ``v``, which squares the scale, 5), and bf16 params
within one bf16 rounding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import SGDMomentum as JSGDMomentum
from repro_torch.optim import AdamW, SGDMomentum, get_optimizer, global_norm
from repro_torch.tree import leaves as _leaves
from tests._compat import given, settings, st

jax.config.update("jax_platform_name", "cpu")

F32_ULPS = 4
STATE_ULPS = 8


def t(values, dtype=torch.float32):
    return torch.tensor(values, dtype=dtype)


# ---------------------------------------------------------------------------
# tests/test_optim.py, against the port
# ---------------------------------------------------------------------------


def test_sgdm_matches_manual():
    opt = SGDMomentum(lr=0.1, momentum=0.9, clip_norm=0.0)
    p = {"w": t([1.0, 2.0])}
    g = {"w": t([0.5, -1.0])}
    s = opt.init(p)
    p1, s1, _ = opt.update(p, g, s)
    np.testing.assert_allclose(p1["w"], [1 - 0.05, 2 + 0.1], rtol=1e-6)
    p2, s2, _ = opt.update(p1, g, s1)
    # m2 = 0.9*g + g = 1.9g
    np.testing.assert_allclose(p2["w"], p1["w"].numpy() - 0.1 * 1.9 *
                               np.array([0.5, -1.0]), rtol=1e-6)


def test_adamw_first_step_is_lr_sized():
    opt = AdamW(lr=1e-3, weight_decay=0.0, clip_norm=0.0)
    p = {"w": t([0.0, 0.0])}
    g = {"w": t([3.0, -7.0])}
    p1, _, _ = opt.update(p, g, opt.init(p))
    # bias-corrected first Adam step == -lr * sign(g)
    np.testing.assert_allclose(p1["w"], [-1e-3, 1e-3], rtol=1e-4)


def test_weight_decay_decoupled():
    opt = AdamW(lr=1e-2, weight_decay=0.5, clip_norm=0.0)
    p = {"w": t([2.0])}
    g = {"w": t([0.0])}
    p1, _, _ = opt.update(p, g, opt.init(p))
    np.testing.assert_allclose(p1["w"], [2.0 * (1 - 1e-2 * 0.5)],
                               rtol=1e-5)


def test_clip_norm():
    opt = SGDMomentum(lr=1.0, momentum=0.0, clip_norm=1.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 10.0)}     # norm 20 -> scaled to 1
    p1, _, gnorm = opt.update(p, g, opt.init(p))
    np.testing.assert_allclose(float(gnorm), 20.0, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(p1["w"].numpy()), 1.0,
                               rtol=1e-5)


def test_bf16_params_f32_state():
    opt = AdamW(lr=1e-2, clip_norm=0.0, weight_decay=0.0)
    p = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    s = opt.init(p)
    assert s["m"]["w"].dtype == torch.float32
    assert s["step"].dtype == torch.int32 and int(s["step"]) == 0
    g = {"w": torch.full((4,), 0.25, dtype=torch.bfloat16)}
    p1, s1, _ = opt.update(p, g, s)
    assert p1["w"].dtype == torch.bfloat16
    assert int(s1["step"]) == 1


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       lr=st.floats(1e-5, 1e-1), name=st.sampled_from(["sgdm", "adamw"]))
def test_descends_quadratic(seed, lr, name):
    """Property: on f(w) = |w|^2/2 both optimizers reduce the loss."""
    w0 = torch.randn((8,), generator=torch.Generator().manual_seed(seed))
    kw = dict(lr=lr, clip_norm=0.0)
    if name == "adamw":
        kw["weight_decay"] = 0.0
    opt = get_optimizer(name, **kw)
    p = {"w": w0}
    s = opt.init(p)
    for _ in range(10):
        p, s, _ = opt.update(p, {"w": p["w"]}, s)
    assert float(global_norm(p)) < float(torch.linalg.norm(w0)) + 1e-6


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("lamb")


# ---------------------------------------------------------------------------
# Against the JAX twins
# ---------------------------------------------------------------------------

SHAPES = [{"w": (8, 16), "b": (16,)}, {"emb": (32, 8)}]


def draw(rng, scale: float):
    return [{k: (scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in layer.items()} for layer in SHAPES]


def to_port(tree, dtype):
    return [{k: torch.from_numpy(v).to(dtype) for k, v in d.items()}
            for d in tree]


def to_jax(tree, dtype):
    return [{k: jnp.asarray(v, dtype) for k, v in d.items()} for d in tree]


def assert_ulps(got, want, ulps: float, bf16: bool):
    """|got - want| <= ulps * the ulp of the leaf's largest |want| in its
    storage dtype."""
    for a, b in zip(_leaves(got), jax.tree.leaves(want)):
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        spacing = np.spacing(np.abs(b).max())
        if bf16:                       # bf16 keeps 8 of f32's 24 bits
            spacing = spacing * 2.0 ** 16
        assert np.all(np.abs(a - b) <= ulps * spacing), \
            float(np.max(np.abs(a - b) / spacing))


PAIRS = {
    "sgdm": (SGDMomentum(lr=0.05, momentum=0.9, clip_norm=1.0,
                         weight_decay=0.01),
             JSGDMomentum(lr=0.05, momentum=0.9, clip_norm=1.0,
                          weight_decay=0.01)),
    "adamw": (AdamW(lr=1e-2, clip_norm=1.0, weight_decay=0.1),
              JAdamW(lr=1e-2, clip_norm=1.0, weight_decay=0.1)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_five_steps_match_jax(name, dtype):
    """Gradients of norm ~10 (clipped to 1 at every step) and weight
    decay: params, states and the gradient norm after each of five
    steps."""
    opt, jopt = PAIRS[name]
    bf16 = dtype == "bfloat16"
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    rng = np.random.default_rng(0)
    p0 = draw(rng, 1.0)
    p, jp = to_port(p0, tdt), to_jax(p0, jdt)
    s, js = opt.init(p), jopt.init(jp)
    for _ in range(5):
        g0 = draw(rng, 0.5)
        p, s, gnorm = opt.update(p, to_port(g0, tdt), s)
        jp, js, jgnorm = jopt.update(jp, to_jax(g0, jdt), js)
        assert gnorm > 1.0
        np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)
        # one rounding to the storage dtype after f32 arithmetic within
        # a few ulps
        assert_ulps(p, jp, 1.0 if bf16 else F32_ULPS, bf16)
        for k in ("m", "v") if name == "adamw" else ("m",):
            assert_ulps(s[k], js[k], STATE_ULPS, False)
        assert int(s["step"]) == int(js["step"])
    assert all(x.dtype == tdt for x in _leaves(p))
    assert all(x.dtype == torch.float32 for x in _leaves(s["m"]))
