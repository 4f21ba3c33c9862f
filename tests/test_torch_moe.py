"""The port's MoE layer (``models/lm/moe.py``) against the JAX package's,
on the same params and inputs (numpy, from a seed), in f32.

* top-k: planted ties choose the experts ``jax.lax.top_k`` chooses (the
  lower index first), in ``_top_k`` and through ``apply_moe``;
* capacity dropping: a config that drops tokens equals JAX;
* the no-drop configuration (capacity ``G``): the same output at group
  sizes 4 and all tokens, so decode and the forward can be compared;
* ``router_aux_loss`` equals JAX's;
* ``routing``: a hook that returns its argument changes nothing, planted
  choices route each token to the given experts, and ``chip_smoke.Routes``
  replays one run's choices on another and counts the flips.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from repro.models.lm import moe as jmoe
from repro_torch.models.lm import moe as tmoe
from tests.test_torch_serve import one_thread  # noqa: F401

jax.config.update("jax_platform_name", "cpu")
pytestmark = pytest.mark.usefixtures("one_thread")

D = 32
CFG = dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared=1, d_ff_shared=24)
RTOL = 1e-5


def configs(**kw):
    c = dict(CFG, **kw)
    return jmoe.MoEConfig(**c), tmoe.MoEConfig(**c)


def params(cfg, seed: int = 0, tie_experts=()):
    """numpy params in the JAX layout; the router columns of each expert
    in ``tie_experts`` copy the column of expert 0, so their logits tie
    exactly with it at every token."""
    shapes = jax.eval_shape(lambda k: jmoe.init_moe(k, D, cfg, jnp.float32),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda s: (rng.standard_normal(s.shape) /
                                np.sqrt(s.shape[-2] if len(s.shape) > 1
                                        else 1)).astype(np.float32), shapes)
    for e in tie_experts:
        p["router"][:, e] = p["router"][:, 0]
    return p


def both(p):
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(torch.from_numpy, p))


def tokens(B: int, T: int, seed: int = 1):
    return np.random.default_rng(seed).standard_normal(
        (B, T, D)).astype(np.float32)


def assert_close(got, want, what: str, rtol: float = RTOL) -> None:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rtol * top, f"{what}: {err:.3e} > {rtol} of {top:.3e}"


@pytest.mark.parametrize("k", (1, 2, 4))
def test_top_k_breaks_ties_toward_the_lower_index_as_jax(k):
    rng = np.random.default_rng(k)
    probs = rng.integers(0, 4, (64, 60)).astype(np.float32) / 4.0
    probs[0] = 0.5                          # every expert ties
    probs[1, [3, 7, 9, 40]] = 1.0           # a tie at the top
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
    got_v, got_i = tmoe._top_k(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i[0].numpy(), np.arange(k))


@pytest.mark.parametrize("tie", ((1,), (1, 5), (2, 3, 6, 7)))
def test_planted_router_ties_choose_the_jax_experts(tie):
    """Experts whose router columns equal expert 0's tie with it at every
    token: each token's choice among them follows the index order, as in
    JAX, and the outputs agree."""
    jcfg, tcfg = configs(capacity_factor=8.0)
    jp, tp = both(params(jcfg, tie_experts=tie))
    x = tokens(2, 16)
    logits = x.reshape(-1, D) @ params(jcfg, tie_experts=tie)["router"]
    assert all(np.array_equal(logits[:, 0], logits[:, e]) for e in tie)
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    want = np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])
    got = tmoe._top_k(torch.softmax(torch.from_numpy(logits), -1),
                      tcfg.top_k)[1].numpy()
    np.testing.assert_array_equal(got, want)
    assert_close(tmoe.apply_moe(tp, torch.from_numpy(x), tcfg).numpy(),
                 jmoe.apply_moe(jp, jnp.asarray(x), jcfg), f"ties {tie}")


@pytest.mark.parametrize("cf,group", ((0.5, 16), (1.0, 8), (1.25, 32)))
def test_dropping_config_equals_jax(cf, group):
    jcfg, tcfg = configs(capacity_factor=cf, group_size=group)
    jp, tp = both(params(jcfg, seed=2))
    x = tokens(2, 32, seed=3)
    got = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg).numpy()
    want = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    assert_close(got, want, f"capacity_factor {cf}, group {group}")
    # some (token, choice) is dropped: not the no-drop result
    nodrop = tmoe.apply_moe(tp, torch.from_numpy(x), dataclasses.replace(
        tcfg, capacity_factor=tcfg.n_experts / tcfg.top_k)).numpy()
    assert np.abs(got - nodrop).max() > 1e-3


def test_no_drop_output_does_not_depend_on_the_grouping():
    """Capacity G per expert and group drops nothing: groups of 4 tokens
    and one group of every token give the same output (chip_smoke.py's
    check (b) for MoE runs on this)."""
    _, tcfg = configs(capacity_factor=CFG["n_experts"] / CFG["top_k"])
    tp = both(params(configs()[0], seed=4))[1]
    x = torch.from_numpy(tokens(4, 24, seed=5))
    small = tmoe.apply_moe(tp, x, dataclasses.replace(tcfg, group_size=4))
    whole = tmoe.apply_moe(tp, x, dataclasses.replace(tcfg,
                                                      group_size=4 * 24))
    assert_close(small.numpy(), whole.numpy(), "group 4 vs all", 1e-6)
    assert tmoe.capacity(tcfg, 4) == 4


def test_token_count_must_split_into_groups():
    _, tcfg = configs(group_size=16)
    tp = both(params(configs()[0]))[1]
    with pytest.raises(ValueError, match="group"):
        tmoe.apply_moe(tp, torch.from_numpy(tokens(3, 10)), tcfg)


@pytest.mark.parametrize("seed", (0, 1))
def test_router_aux_loss_equals_jax(seed):
    jcfg, tcfg = configs()
    jp, tp = both(params(jcfg, seed=seed, tie_experts=(3,)))
    x = tokens(2, 16, seed=seed + 10)
    got = float(tmoe.router_aux_loss(tp, torch.from_numpy(x), tcfg))
    want = float(jmoe.router_aux_loss(jp, jnp.asarray(x), jcfg))
    assert abs(got - want) <= RTOL * abs(want), (got, want)


def test_init_matches_the_jax_layout():
    jcfg, tcfg = configs()
    want = jax.eval_shape(lambda k: jmoe.init_moe(k, D, jcfg, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    got = tmoe.init_moe(torch.Generator().manual_seed(0), D, tcfg,
                        torch.bfloat16)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), got,
                        is_leaf=lambda t: isinstance(t, torch.Tensor)) == \
        jax.tree.map(lambda s: (tuple(s.shape),
                                f"torch.{jnp.dtype(s.dtype).name}"), want)


NO_DROP = dict(capacity_factor=CFG["n_experts"] / CFG["top_k"])


def test_routing_hook_that_returns_its_argument_changes_nothing():
    """A hook that returns its argument sees each call's choices ``[B, T,
    K]`` (``_top_k``'s) and leaves the output bitwise as it was, with
    dropping too; outside the block no hook is set."""
    _, tcfg = configs(capacity_factor=0.5, group_size=16)
    tp = both(params(configs()[0], seed=6))[1]
    x = torch.from_numpy(tokens(2, 16, seed=7))
    want = tmoe.apply_moe(tp, x, tcfg)
    seen = []
    with tmoe.routing(lambda idx: seen.append(idx.clone()) or idx):
        got = tmoe.apply_moe(tp, x, tcfg)
    assert torch.equal(got, want)
    probs = torch.softmax((x @ tp["router"]).float(), dim=-1)
    assert len(seen) == 1
    assert torch.equal(seen[0], tmoe._top_k(probs, CFG["top_k"])[1])
    assert tmoe._route is None


def test_planted_routing_gates_each_token_by_the_given_experts():
    """Routed by planted choices (no dropping), a token's output is the
    shared expert's plus each given expert's SwiGLU, weighted by its
    probability renormalized over the given ones."""
    _, tcfg = configs(group_size=8, **NO_DROP)
    tp = both(params(configs()[0], seed=8))[1]
    B, T, E, K = 2, 8, CFG["n_experts"], CFG["top_k"]
    x = torch.from_numpy(tokens(B, T, seed=9))
    rng = np.random.default_rng(10)
    planted = torch.from_numpy(np.stack(
        [rng.permutation(E)[:K] for _ in range(B * T)]).reshape(B, T, K))
    with tmoe.routing(lambda own: planted):
        got = tmoe.apply_moe(tp, x, tcfg)
    probs = torch.softmax((x @ tp["router"]).float(), dim=-1)
    want = tmoe.apply_swiglu(tp["shared"], x)
    for b in range(B):
        for t in range(T):
            g = probs[b, t, planted[b, t]]
            for k, e in enumerate(planted[b, t].tolist()):
                h = F.silu(x[b, t] @ tp["w_gate"][e]) * (x[b, t] @
                                                         tp["w_up"][e])
                want[b, t] += g[k] / g.sum() * (h @ tp["w_down"][e])
    assert_close(got.numpy(), want.numpy(), "planted routing")
    own = tmoe.apply_moe(tp, x, tcfg)
    assert np.abs(got.numpy() - own.numpy()).max() > 1e-3


def test_chip_smoke_routes_replay_one_run_on_another():
    """``chip_smoke.Routes``: choices recorded over T tokens, followed at
    position t0 by a one-token run, route it as recorded (``replay``) or
    as it would itself; either way ``flips`` counts the (layer, token)
    whose own choices differ from the recorded ones.  A run with more
    layers than the recorded one fails."""
    _, tcfg = configs(group_size=4, **NO_DROP)
    tp = both(params(configs()[0], seed=11))[1]
    x = torch.from_numpy(tokens(2, 8, seed=12))
    layers = 2
    routes = chip_smoke.Routes()
    with routes.record():
        ref = [tmoe.apply_moe(tp, x, tcfg) for _ in range(layers)]
    t0 = 5
    same = x[:, t0:t0 + 1]
    with routes.follow(t0, replay=True):
        out = tmoe.apply_moe(tp, same, tcfg)
        tmoe.apply_moe(tp, same, tcfg)
    assert_close(out.numpy(), ref[0][:, t0:t0 + 1].numpy(), "replayed", 1e-6)
    # another token: its own experts differ from the recorded ones
    other = -x[:, t0:t0 + 1]
    own_idx = tmoe._top_k(torch.softmax(other @ tp["router"], dim=-1),
                          CFG["top_k"])[1]
    flips = int((own_idx != routes.rec[0][:, t0:t0 + 1]).any(-1).sum())
    assert flips > 0
    for replay in (False, True):
        with routes.follow(t0, replay):
            got = [tmoe.apply_moe(tp, other, tcfg) for _ in range(layers)]
        with tmoe.routing(lambda idx: routes.rec[0][:, t0:t0 + 1]
                          if replay else idx):
            want = tmoe.apply_moe(tp, other, tcfg)
        assert torch.equal(got[0], want)
    assert routes.flips == [0, layers * flips, layers * flips]
    with pytest.raises(SystemExit):
        with routes.follow(t0, replay=True):
            for _ in range(layers + 1):
                tmoe.apply_moe(tp, same, tcfg)
