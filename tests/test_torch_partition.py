"""The dense train step partitioned over DTensor
(:mod:`repro_torch.distrib.partition`) against the reference's
``jax.jit(step, in_shardings, out_shardings)``.

One spawn of 4 gloo ranks (``tests.torch_partition_worker``, one
intra-op thread each) beside JAX subprocesses on 4 host devices
(``tests.jax_partition_twin``), all started together.  Weights come from
JAX's ``init`` (through ``convert.model_params_from_numpy`` on the port's
side), batches from numpy with a seed.  Each rank builds the meshes
``(data=2, model=2)`` and ``(data=1, model=4)``.

* Cases: the qwen2.5-3b smoke config on both meshes at ``fsdp`` both
  ways and microbatches 1 and 2 with ``use_flash=True``; once with
  ``use_flash=False``; granite-20b's smoke config (MQA: one KV head); a
  smoke variant whose 6 heads do not divide ``model`` (the sequence-
  sharded query).  AdamW, 2 steps each.
* Held: losses and params against JAX's partitioned step and against
  the port's unpartitioned step at the ``E2E_*`` tolerances of
  tests/test_kernel_oracle.py; every leaf's placements after each step
  ``==`` ``param_shardings`` / ``opt_state_shardings`` (and
  ``make_train_step`` alone keeps them); each rank's local state bytes
  ``==`` ``launch.dryrun.sharded_bytes``; every rank's ``full_tensor()``
  equal; the flash launcher given plain local shards only.
* The flash route on DTensors with a stub launcher: local shapes, no
  collective when the heads are sharded, o and the gradients equal to
  the plain attention of the full tensors.
* The hints (``_qkv_hints``, ``_resid_hint``, the logits chunk's) give
  the placements of the reference's specs, and are the identity without
  a mesh in scope.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.lm.model import build_model as jax_build_model
from repro_torch.convert import model_params_from_numpy
from repro_torch.distrib import sharding as sh
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.step import make_train_step
from tests.test_kernel_oracle import (E2E_LOSS_RTOL, E2E_PARAM_ATOL,
                                      E2E_PARAM_RTOL)
from tests.torch_partition_worker import case_batches, case_config

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
B = 4              # a microbatch's rows: the global batch is B x mb
OPT_KW = dict(lr=3e-4, weight_decay=0.1)   # AdamW's defaults
MESHES = ((2, 2), (1, 4))
# model key -> (arch, config overrides, T)
MODELS = {
    "qwen": ("qwen2.5-3b", {}, 32),
    "granite": ("granite-20b", {}, 32),
    "odd": ("qwen2.5-3b", dict(n_heads=6, head_dim=16, n_kv_heads=2), 64),
}


def _case(model, mesh, fsdp, mb, use_flash=True):
    arch, variant, _ = MODELS[model]
    name = (f"{model}-{mesh[0]}x{mesh[1]}-{'fsdp' if fsdp else 'tp'}-mb{mb}"
            + ("" if use_flash else "-plain"))
    return dict(name=name, model=model, arch=arch, variant=variant,
                mesh=mesh, fsdp=fsdp, mb=mb, use_flash=use_flash,
                batch=B * mb)


CASES = [_case("qwen", m, f, mb) for m in MESHES for f in (True, False)
         for mb in (1, 2)] + [
    _case("qwen", (1, 4), True, 1, use_flash=False),
    _case("granite", (1, 4), True, 1),
    _case("odd", (1, 4), False, 2)]
NAMES = [c["name"] for c in CASES]
# the flash route's layouts: (name, mesh, q shape, k shape)
ROUTE = (("heads-and-kv-heads", (2, 2), (4, 32, 4, 16), (4, 32, 2, 16)),
         ("gqa-kv-replicated", (1, 4), (4, 32, 4, 16), (4, 32, 2, 16)),
         ("mqa", (1, 4), (4, 32, 4, 16), (4, 32, 1, 16)),
         ("kv-group-straddled", (1, 4), (2, 16, 12, 16), (2, 16, 6, 16)),
         ("sequence", (1, 4), (4, 64, 6, 16), (4, 64, 2, 16)))
HEADS_SHARDED = ROUTE[:4]


def _hints():
    out = []
    for m in MESHES:
        tag = f"{m[0]}x{m[1]}"
        for name, _, q, k in ROUTE + (("decode", None, (4, 1, 6, 16),
                                        (4, 8, 2, 16)),):
            out.append(dict(name=f"qkv-{name}-{tag}", kind="qkv", mesh=m,
                            shapes=[q, k, k]))
        for sp in (False, True):
            out.append(dict(name=f"resid-sp{int(sp)}-{tag}", kind="resid",
                            mesh=m, seq_parallel=sp, shapes=[(4, 32, 64)]))
        for shape in ((4, 32, 128), (2, 32, 130)):
            out.append(dict(name=f"logits-{shape[0]}x{shape[2]}-{tag}",
                            kind="logits", mesh=m, shapes=[shape]))
    return out


HINTS = _hints()


def _inputs():
    rng = np.random.default_rng(0)
    params, batches = {}, {}
    for i, (key, (arch, variant, T)) in enumerate(MODELS.items()):
        model = jax_build_model(jax_get_arch(arch).smoke.variant(**variant))
        params[key] = jax.tree.map(np.asarray, jax.jit(model.init)(
            jax.random.PRNGKey(i)))
        vocab = jax_get_arch(arch).smoke.vocab
        batches[key] = [{n: rng.integers(0, vocab, (2 * B, T)).astype(
            np.int32) for n in ("tokens", "targets")} for _ in range(2)]
    route = []
    for name, mesh, q, k in ROUTE:
        route.append(dict(name=name, mesh=mesh, **{
            n: rng.standard_normal(s).astype(np.float32)
            for n, s in (("q", q), ("k", k), ("v", k), ("do", q))}))
    return dict(opt_kw=OPT_KW, meshes=MESHES, cases=CASES, params=params,
                batches=batches, route=route, hints=HINTS)


def _unpartitioned(inputs, case):
    """The port's plain step on one process, 2 steps."""
    model = build_model(case_config(case))
    opt = get_optimizer("adamw", **OPT_KW)
    p0 = model_params_from_numpy(inputs["params"][case["model"]])
    state = {"params": p0, "opt": opt.init(p0)}
    step = make_train_step(model, opt, microbatches=case["mb"])
    losses = []
    for i, b in enumerate(case_batches(case, inputs)):
        state, met = step(state, b, i)
        losses.append(float(met["loss"]))
    return {"losses": losses, "params": jax.tree.map(
        lambda t: t.numpy(), state["params"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("partition")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-m", "tests.torch_partition_worker", str(r),
             str(WORLD), str(tmp / "store"), str(tmp / "inputs.pkl"),
             str(tmp / f"rank{r}.pkl")] for r in range(WORLD)]
    halves = (NAMES[0::2], NAMES[1::2])
    cmds += [[sys.executable, "-m", "tests.jax_partition_twin",
              str(tmp / "inputs.pkl"), str(tmp / f"jax{i}.pkl"), *names]
             for i, names in enumerate(halves)]
    # started first: their imports overlap JAX's init here, and each
    # waits for the inputs file
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    threads = torch.get_num_threads()
    try:
        inputs = _inputs()
        with open(tmp / "inputs.tmp", "wb") as f:
            pickle.dump(inputs, f)
        os.replace(tmp / "inputs.tmp", tmp / "inputs.pkl")
        torch.set_num_threads(1)      # beside six busy processes
        plain = {}
        for c in CASES:
            key = (c["model"], c["use_flash"], c["mb"])
            if key not in plain:
                plain[key] = _unpartitioned(inputs, c)
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = {"ranks": [], "jax": {"cases": {}}, "inputs": inputs,
           "plain": {c["name"]: plain[(c["model"], c["use_flash"], c["mb"])]
                     for c in CASES}}
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out["ranks"].append(pickle.load(f))
    for i in range(len(halves)):
        with open(tmp / f"jax{i}.pkl", "rb") as f:
            got = pickle.load(f)
        out["jax"]["cases"].update(got["cases"])
        out["jax"]["hints"] = got["hints"]
    return out


def _assert_params_close(got, want):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, atol=E2E_PARAM_ATOL,
                                   rtol=E2E_PARAM_RTOL)


def _by_name(case):
    return next(c for c in CASES if c["name"] == case)


# ---------------------------------------------------------------------------
# The partitioned step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", NAMES)
def test_partitioned_step_matches_jax(runs, case):
    want = runs["jax"]["cases"][case]
    for r in runs["ranks"]:
        got = r["cases"][case]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=E2E_LOSS_RTOL)
        _assert_params_close(got["params"], want["params"])


@pytest.mark.parametrize("case", NAMES)
def test_partitioned_step_matches_unpartitioned(runs, case):
    want = runs["plain"][case]
    for r in runs["ranks"]:
        got = r["cases"][case]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=E2E_LOSS_RTOL)
        _assert_params_close(got["params"], want["params"])


@pytest.mark.parametrize("case", NAMES)
def test_placements_kept_and_local_bytes(runs, case):
    for r in runs["ranks"]:
        got = r["cases"][case]
        assert got["kept"] == [True, True]
        assert got["local_bytes"] == [got["sharded_bytes"]] * 2
        # loss, grad_norm and step come back as plain tensors
        assert got["metric_types"] == [["Tensor"]] * 2
    # the state is smaller than whole on every rank that shards
    total = sum(a.nbytes for a in jax.tree.leaves(
        runs["inputs"]["params"][_by_name(case)["model"]]))
    assert runs["ranks"][0]["cases"][case]["sharded_bytes"] < 3 * total


@pytest.mark.parametrize("case", NAMES)
def test_ranks_hold_one_state(runs, case):
    first = runs["ranks"][0]["cases"][case]
    for r in runs["ranks"][1:]:
        got = r["cases"][case]
        assert got["losses"] == first["losses"]
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(first["params"])):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", [c for c in NAMES if "plain" not in c])
def test_launcher_gets_local_shards(runs, case):
    """Every launch of the step's flash kernel sees this rank's batch
    slice and local heads: the model's hints put q's heads over
    ``model`` (all of them where they do not divide it), and the KV
    heads that local query heads read."""
    c = _by_name(case)
    arch, variant, T = MODELS[c["model"]]
    cfg = case_config(c)
    data, model = c["mesh"]
    bl = B // data
    heads = cfg.n_heads // model if cfg.n_heads % model == 0 \
        else cfg.n_heads
    rep = cfg.n_heads // cfg.n_kv_heads
    kv = cfg.n_kv_heads // model if cfg.n_kv_heads % model == 0 \
        else max(heads // rep, 1)
    want = ((bl * heads, T, cfg.hd), (bl * kv, T, cfg.hd))
    n = 2 * c["mb"] * cfg.n_layers * (2 if cfg.remat else 1)
    for r in runs["ranks"]:
        assert r["cases"][case]["launcher_shapes"] == [want] * n


def test_raw_step_keeps_placements(runs):
    for r in runs["ranks"]:
        assert r["raw_step_keeps_placements"] == {str(m): True
                                                  for m in MESHES}


def test_launcher_refuses_a_dtensor(runs):
    for r in runs["ranks"]:
        assert "not a DTensor" in r["launcher_refuses"]


# ---------------------------------------------------------------------------
# The flash route on local shards
# ---------------------------------------------------------------------------


def _plain_attention(q, k, v, do):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = attn.mha(qt, kt, vt, causal=True)
    o.backward(torch.from_numpy(do))
    return o.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("layout", [r[0] for r in ROUTE])
def test_flash_route_runs_on_local_shards(runs, layout):
    spec = next(r for r in ROUTE if r[0] == layout)
    _, (data, model), (b, t, h, hd), (_, s, kvh, _) = spec
    sharded = spec in HEADS_SHARDED
    heads = h // model if sharded else h
    rep = h // kvh
    if kvh % model == 0:
        kv = kvh // model
    elif sharded and layout != "kv-group-straddled":
        kv = max(heads // rep, 1)
    else:
        kv = heads if sharded else kvh
    want_seen = [((b // data * heads, t, hd), (b // data * kv, s, hd))]
    inp = next(r for r in runs["inputs"]["route"] if r["name"] == layout)
    o_ref, g_ref = _plain_attention(inp["q"], inp["k"], inp["v"], inp["do"])
    for r in runs["ranks"]:
        got = next(x for x in r["route"] if x["name"] == layout)
        assert got["seen"] == want_seen
        assert got["o_layout"] == got["q_layout"]
        np.testing.assert_allclose(got["o"], o_ref, atol=1e-5, rtol=1e-5)
        for g, w in zip(got["grads"], g_ref):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        if sharded:
            assert got["fwd_comms"] == 0, got
        else:
            assert got["fwd_comms"] > 0      # the gather of q's sequence
        if kvh % model == 0:
            assert got["bwd_comms"] == 0, got


# ---------------------------------------------------------------------------
# The hints
# ---------------------------------------------------------------------------


def _placement_names(mesh_shape, spec):
    mesh = sh.MeshShape(tuple(mesh_shape), ("data", "model"))
    return [str(p) for p in sh.placements(mesh, spec)]


@pytest.mark.parametrize("hint", [h["name"] for h in HINTS])
def test_hints_give_the_reference_placements(runs, hint):
    h = next(x for x in HINTS if x["name"] == hint)
    specs = next(x for x in runs["jax"]["hints"]
                 if x["name"] == hint)["specs"]
    want = [_placement_names(h["mesh"], s) for s in specs]
    assert len(want) == len(h["shapes"])
    for r in runs["ranks"]:
        got = next(x for x in r["hints"] if x["name"] == hint)
        assert got["identity_without_mesh"]
        assert got["placements"] == want


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_logits_chunk_takes_the_hint(runs, mesh):
    """Inside ``chunked_softmax_xent`` on the qwen smoke config (one
    ``[4, 32, 128]`` chunk), as the reference's spec of that shape."""
    tag = f"{mesh[0]}x{mesh[1]}"
    specs = next(x for x in runs["jax"]["hints"]
                 if x["name"] == f"logits-4x128-{tag}")["specs"]
    for r in runs["ranks"]:
        assert r["logits_hint"][str(mesh)] == [
            _placement_names(mesh, s) for s in specs]


def test_hints_are_the_identity_on_plain_tensors():
    """With a mesh in scope, a plain tensor (each rank's own shard, as
    inside the reference's ``shard_map``) passes every hint unchanged."""
    from repro_torch.distrib import compat
    from repro_torch.models.lm.model import _resid_hint
    cfg = case_config(CASES[0])
    q, k = torch.zeros(4, 32, 4, 16), torch.zeros(4, 32, 2, 16)
    with compat.set_mesh(sh.MeshShape((2, 2), ("data", "model"))):
        got = attn._qkv_hints(q, k, k)
        assert all(a is b for a, b in zip(got, (q, k, k)))
        x = torch.zeros(4, 32, 64)
        assert _resid_hint(cfg, x) is x
