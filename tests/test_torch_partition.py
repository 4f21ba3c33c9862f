"""The train step of every family partitioned over DTensor
(:mod:`repro_torch.distrib.partition`) against the reference's
``jax.jit(step, in_shardings, out_shardings)``.

One spawn of 4 gloo ranks (``tests.torch_partition_worker``, one
intra-op thread each) beside JAX subprocesses on 4 host devices
(``tests.jax_partition_twin``), all started together.  Weights come from
JAX's ``init`` (through ``convert.model_params_from_numpy`` on the port's
side; the zamba, moe, xlstm and whisper twins' from the port's ``init``,
as numpy, which spares a JAX compile per model), batches from
numpy with a seed.  Each rank builds the meshes
``(data=2, model=2)`` and ``(data=1, model=4)``.

* Cases: the qwen2.5-3b smoke config on both meshes at ``fsdp`` both
  ways and microbatches 1 and 2 with ``use_flash=True``; once with
  ``use_flash=False``; granite-20b's smoke config (MQA: one KV head); a
  smoke variant whose 6 heads do not divide ``model`` (the sequence-
  sharded query).  The zamba2-7b (one group and a trailing layer),
  qwen2-moe-a2.7b, xlstm-350m (one group; at T=48: the sLSTM's ``n``
  carry drifts at T=32) and whisper-base smoke configs on ``(2, 2)``
  with ``fsdp=True`` and on ``(1, 4)`` with
  ``fsdp=False``, moe also at microbatches 2; xlstm-smoke's 2 heads on
  ``model=4`` take the replicated-heads routes.  AdamW (the xlstm cases
  SGD with momentum: ``OPTS``), 2 steps each.
  The port runs the GLA kernel's route (``use_gla_kernel``; its plain
  version on the CPU); the JAX twin runs the plain ``chunked_gla``, which
  the reference's own tests hold to its interpret-mode Pallas kernel,
  since that kernel under ``jit(in_shardings)`` would make the twin the
  slowest part of the file.
* Held: losses and params against JAX's partitioned step and against
  the port's unpartitioned step at the ``E2E_*`` tolerances of
  tests/test_kernel_oracle.py; every leaf's placements after each step
  ``==`` ``param_shardings`` / ``opt_state_shardings`` (and
  ``make_train_step`` alone keeps them); each rank's local state bytes
  ``==`` ``launch.dryrun.sharded_bytes``; every rank's ``full_tensor()``
  equal; the flash and GLA launchers given plain local shards only, as
  many launches as ``chip_smoke.flat_launches`` counts.
* The flash route on DTensors with a stub launcher: local shapes, no
  collective when the heads are sharded, o and the gradients equal to
  the plain attention of the full tensors.
* The GLA route on DTensors with a stub launcher (heads dividing
  ``model``, heads replicated, Mamba2's head-broadcast q and k,
  ``normalize=True``): local shapes, no collective in the forward, y, S,
  n and the four gradients equal to the plain ``chunked_gla`` of the
  full tensors.
* The sLSTM's local route equal, with every gradient, to its loop on
  the full tensors; the MoE routing hook and ``router_aux_loss`` on
  DTensors equal to the plain model's; the mLSTM and MoE blocks on a
  sequence-parallel input equal, with every gradient, to the blocks on
  the full tensors.
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

import chip_smoke
from repro.configs import get_arch as jax_get_arch
from repro.models.lm.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.convert import (model_params_from_numpy,
                                 model_params_to_numpy)
from repro_torch.distrib import sharding as sh
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import xlstm as xlstm_mod
from repro_torch.models.lm.gla import chunked_gla
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
# The xlstm cases run SGD with momentum (tests/test_torch_train_step.py's
# settings).  AdamW's first updates are about lr * sign(g): a gradient
# element within rounding of zero moves its param by up to 2 lr a step,
# and the sLSTM's recurrence rounds its gradients furthest (at lr 3e-4
# one element of 8,192 moved 2.2e-4 from JAX's in xlstm-2x2-fsdp-mb1, and
# one of 32,768 8.5e-5 from the unpartitioned step's in xlstm-1x4-tp-mb1;
# with SGD the largest difference from the unpartitioned step was
# 2.4e-7).  SGD holds the gradients themselves, where AdamW holds their
# signs; phase 16 of chip_smoke.py runs the xlstm step with AdamW.
OPTS = {"xlstm": ("sgdm", dict(lr=0.05, weight_decay=0.01))}
MESHES = ((2, 2), (1, 4))
# model key -> (arch, config overrides, T)
MODELS = {
    "qwen": ("qwen2.5-3b", {}, 32),
    "granite": ("granite-20b", {}, 32),
    "odd": ("qwen2.5-3b", dict(n_heads=6, head_dim=16, n_kv_heads=2), 64),
    # the file's time, not its checks: zamba's smoke twin cut to one
    # group of 3 Mamba2 layers, the shared block and a trailing layer,
    # xlstm's to one group of 2 mLSTM blocks and an sLSTM, and the four
    # without remat (the dense cases and phase 16 on the card run it)
    "zamba": ("zamba2-7b", dict(n_layers=4, remat=False), 32),
    "moe": ("qwen2-moe-a2.7b", dict(remat=False), 32),
    "xlstm": ("xlstm-350m", dict(n_layers=3, remat=False), 48),
    "whisper": ("whisper-base", dict(remat=False), 32),
}
FAMILIES = ("zamba", "moe", "xlstm", "whisper")


def _case(model, mesh, fsdp, mb, use_flash=True):
    arch, variant, _ = MODELS[model]
    name = (f"{model}-{mesh[0]}x{mesh[1]}-{'fsdp' if fsdp else 'tp'}-mb{mb}"
            + ("" if use_flash else "-plain"))
    opt, opt_kw = OPTS.get(model, ("adamw", OPT_KW))
    return dict(name=name, model=model, arch=arch, variant=variant,
                mesh=mesh, fsdp=fsdp, mb=mb, use_flash=use_flash,
                batch=B * mb, opt=opt, opt_kw=opt_kw)


CASES = [_case("qwen", m, f, mb) for m in MESHES for f in (True, False)
         for mb in (1, 2)] + [
    _case("qwen", (1, 4), True, 1, use_flash=False),
    _case("granite", (1, 4), True, 1),
    _case("odd", (1, 4), False, 2)] + [
    _case(f, m, fsdp, 1) for f in FAMILIES
    for m, fsdp in (((2, 2), True), ((1, 4), False))] + [
    _case("moe", (2, 2), True, 2)]
NAMES = [c["name"] for c in CASES]
# the flash route's layouts: (name, mesh, q shape, k shape)
ROUTE = (("heads-and-kv-heads", (2, 2), (4, 32, 4, 16), (4, 32, 2, 16)),
         ("gqa-kv-replicated", (1, 4), (4, 32, 4, 16), (4, 32, 2, 16)),
         ("mqa", (1, 4), (4, 32, 4, 16), (4, 32, 1, 16)),
         ("kv-group-straddled", (1, 4), (2, 16, 12, 16), (2, 16, 6, 16)),
         ("sequence", (1, 4), (4, 64, 6, 16), (4, 64, 2, 16)))
HEADS_SHARDED = ROUTE[:4]
# the GLA route's layouts: (name, mesh, B, T, H, dk, dv, heads over
# model, q and k broadcast over heads, normalize)
GLA_ROUTE = (("heads", (2, 2), 4, 32, 4, 16, 16, True, False, False),
             ("heads-replicated", (1, 4), 4, 32, 2, 16, 8, False, False,
              False),
             ("broadcast", (1, 4), 4, 32, 4, 16, 8, True, True, False),
             ("normalize", (2, 2), 4, 32, 4, 16, 16, True, False, True))
GLA_CHUNK = 16
# the sLSTM route's layouts: (name, mesh, heads); d_model 64, T 16
SLSTM_ROUTE = (("heads", (2, 2), 2), ("heads-replicated", (1, 4), 2),
               ("four-heads", (1, 4), 4))
SLSTM_D, SLSTM_T = 64, 16
# the blocks run on a sequence-parallel input: (model key, mesh)
SP_BLOCKS = (("xlstm", (1, 4)), ("moe", (2, 2)))


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
        if key in FAMILIES:     # the port's init: no JAX compile to wait on
            params[key] = model_params_to_numpy(build_model(
                configs.get_arch(arch).smoke.variant(**variant)).init(
                    torch.Generator().manual_seed(i), "cpu"))
        else:
            model = jax_build_model(jax_get_arch(arch).smoke.variant(
                **variant))
            params[key] = jax.tree.map(np.asarray, jax.jit(model.init)(
                jax.random.PRNGKey(i)))
        smoke = jax_get_arch(arch).smoke
        batches[key] = [{n: rng.integers(0, smoke.vocab, (2 * B, T)).astype(
            np.int32) for n in ("tokens", "targets")} for _ in range(2)]
        if smoke.family == "encdec":
            for b in batches[key]:
                b["frames"] = rng.standard_normal(
                    (2 * B, T, smoke.d_model)).astype(np.float32)
    route = []
    for name, mesh, q, k in ROUTE:
        route.append(dict(name=name, mesh=mesh, **{
            n: rng.standard_normal(s).astype(np.float32)
            for n, s in (("q", q), ("k", k), ("v", k), ("do", q))}))
    gla_route = []
    for name, mesh, b, t, h, dk, dv, sharded, bcast, norm in GLA_ROUTE:
        hq = 1 if bcast else h
        shapes = (("q", (b, t, hq, dk)), ("k", (b, t, hq, dk)),
                  ("v", (b, t, h, dv)), ("dy", (b, t, h, dv)),
                  ("dS", (b, h, dk, dv)), ("dn", (b, h, dk)))
        gla_route.append(dict(
            name=name, mesh=mesh, sharded=sharded, broadcast=bcast,
            normalize=norm, chunk=GLA_CHUNK,
            a=-rng.uniform(0.0, 0.5, (b, t, h)).astype(np.float32),
            **{n: (rng.standard_normal(s) / 2).astype(np.float32)
               for n, s in shapes}))
    slstm_route = []
    for name, mesh, heads in SLSTM_ROUTE:
        D, hd = SLSTM_D, SLSTM_D // heads

        def normal(*shape, fan):
            return (rng.standard_normal(shape) / np.sqrt(fan)).astype(
                np.float32)
        bias = np.zeros(4 * D, np.float32)
        bias[D:2 * D] = 3.0
        slstm_route.append(dict(
            name=name, mesh=mesh, heads=heads,
            x=normal(B, SLSTM_T, D, fan=1), dy=normal(B, SLSTM_T, D, fan=1),
            params={"w_in": normal(D, 4 * D, fan=D),
                    "r": normal(heads, hd, 4 * hd, fan=hd),
                    "b": bias, "norm_w": normal(D, fan=10),
                    "out_proj": normal(D, D, fan=D)}))
    sp_blocks = []
    for model, mesh in SP_BLOCKS:
        T, D = MODELS[model][2], jax_get_arch(MODELS[model][0]).smoke.d_model
        sp_blocks.append(dict(
            name=f"{model}-{mesh[0]}x{mesh[1]}", model=model, mesh=mesh,
            **{n: rng.standard_normal((B, T, D)).astype(np.float32)
               for n in ("x", "dy")}))
    moe_x = rng.standard_normal(
        (B, MODELS["moe"][2], jax_get_arch("qwen2-moe-a2.7b").smoke.d_model)
    ).astype(np.float32)
    return dict(meshes=MESHES, cases=CASES, params=params,
                batches=batches, route=route, gla_route=gla_route,
                slstm_route=slstm_route, moe_x=moe_x, sp_blocks=sp_blocks,
                hints=HINTS)


def _unpartitioned(inputs, case):
    """The port's plain step on one process, 2 steps."""
    model = build_model(case_config(case))
    opt = get_optimizer(case["opt"], **case["opt_kw"])
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


def _gla_heads(cfg):
    """(heads, dk, dv) of a family's GLA blocks: Mamba2's SSD heads, or
    the mLSTM's."""
    if cfg.family == "zamba":
        nh = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
        return nh, cfg.ssm.d_state, cfg.ssm.head_dim
    hd = cfg.xlstm.expand * cfg.d_model // cfg.xlstm.n_heads
    return cfg.xlstm.n_heads, hd, hd


@pytest.mark.parametrize("case", [c for c in NAMES if "plain" not in c])
def test_launcher_gets_local_shards(runs, case):
    """Every launch of the step's flash and GLA kernels sees this rank's
    batch slice and local heads: the model's hints put q's heads over
    ``model`` (all of them where they do not divide it), and the KV
    heads that local query heads read; the GLA heads go over ``model``
    where they divide it.  Each kernel launches as often as the flat
    step's count, ``chip_smoke.flat_launches``, says."""
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
    per_step = chip_smoke.flat_launches(cfg)
    n = 2 * c["mb"] * per_step["flash_attention"]
    gla = []
    if per_step["gla_scan"]:
        h, dk, dv = _gla_heads(cfg)
        hl = h // model if h % model == 0 and h >= model else h
        gla = [((bl * hl, T, dk), (bl * hl, T, dv))] * (
            2 * c["mb"] * per_step["gla_scan"])
    for r in runs["ranks"]:
        assert r["cases"][case]["launcher_shapes"] == [want] * n
        assert r["cases"][case]["gla_shapes"] == gla


def test_raw_step_keeps_placements(runs):
    for r in runs["ranks"]:
        assert r["raw_step_keeps_placements"] == {str(m): True
                                                  for m in MESHES}


def test_launcher_refuses_a_dtensor(runs):
    for r in runs["ranks"]:
        assert sorted(r["launcher_refuses"]) == ["flash_attention",
                                                 "gla_scan"]
        for msg in r["launcher_refuses"].values():
            assert "not a DTensor" in msg


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
# The GLA route and the sLSTM on local shards; MoE on DTensors
# ---------------------------------------------------------------------------


def _plain_gla(inp):
    """``chunked_gla`` of the full tensors: y, S, n and the gradients of
    q, k (before the broadcast over heads), v and log_decay."""
    ins = {n: torch.from_numpy(inp[n]).requires_grad_(True)
           for n in ("q", "k", "v", "a")}
    H = inp["v"].shape[2]
    q, k = (ins[n].expand(-1, -1, H, -1) for n in "qk")
    y, (S, n) = chunked_gla(q, k, ins["v"], ins["a"], chunk=inp["chunk"],
                            normalize=inp["normalize"])
    torch.autograd.backward([y, S, n], [torch.from_numpy(inp[g])
                                        for g in ("dy", "dS", "dn")])
    return ([t.detach().numpy() for t in (y, S, n)],
            [ins[n].grad.numpy() for n in ("q", "k", "v", "a")])


@pytest.mark.parametrize("layout", [r[0] for r in GLA_ROUTE])
def test_gla_route_runs_on_local_shards(runs, layout):
    spec = next(r for r in GLA_ROUTE if r[0] == layout)
    _, (data, model), b, t, h, dk, dv, sharded, bcast, _ = spec
    hl = h // model if sharded else h
    inp = next(r for r in runs["inputs"]["gla_route"] if r["name"] == layout)
    outs, grads = _plain_gla(inp)
    m = "model" if sharded else None
    want_layouts = [_placement_names((data, model), spec) for spec in (
        ("data", None, m, None), ("data", m, None, None), ("data", m, None))]
    for r in runs["ranks"]:
        got = next(x for x in r["gla_route"] if x["name"] == layout)
        assert got["seen"] == [((b // data * hl, t, dk),
                                (b // data * hl, t, dv))]
        assert got["fwd_comms"] == 0, got
        assert got["layouts"] == want_layouts
        for g, w in zip(got["outs"] + got["grads"], outs + grads):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        if bcast:     # q and k's gradients summed over the model ranks
            assert got["bwd_comms"] > 0


@pytest.mark.parametrize("layout", [r[0] for r in SLSTM_ROUTE])
def test_slstm_route_equals_the_plain_loop(runs, layout):
    inp = next(r for r in runs["inputs"]["slstm_route"]
               if r["name"] == layout)
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in inp["params"].items()}
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = xlstm_mod.apply_slstm(p, x, xlstm_mod.XLSTMConfig(
        n_heads=inp["heads"]))
    y.backward(torch.from_numpy(inp["dy"]))
    want = {"x": x.grad.numpy(), **{k: t.grad.numpy() for k, t in p.items()}}
    for r in runs["ranks"]:
        got = next(s for s in r["slstm_route"] if s["name"] == layout)
        np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-5,
                                   rtol=1e-5)
        assert sorted(got["grads"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["grads"][k], w, atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("block", [f"{m}-{a}x{b}" for m, (a, b) in
                                   SP_BLOCKS])
def test_blocks_take_a_sequence_parallel_input(runs, block):
    """The mLSTM (2 heads on ``model=4``: views of a dim sharded over
    ranks that do not divide the heads) and MoE (routing groups of the
    global batch out of a sharded T) on an input with T over ``model``:
    y and every gradient equal to the block's on the full tensors, each
    gradient within 1e-5 of its largest entry (f32 sums over the 128 or
    192 tokens, reordered by the partition: 2e-7 to 3e-6 of it
    measured)."""
    from tests.torch_partition_worker import (apply_block, block_params,
                                              leaves_named)
    inp = next(r for r in runs["inputs"]["sp_blocks"] if r["name"] == block)
    model = inp["model"]
    cfg = case_config(next(c for c in CASES if c["model"] == model))
    p = jax.tree.map(lambda t: t.detach().requires_grad_(True),
                     block_params(model, model_params_from_numpy(
                         runs["inputs"]["params"][model])))
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y = apply_block(model, cfg, p, x)
    y.backward(torch.from_numpy(inp["dy"]))
    want = {"x": x.grad.numpy(), **{k: t.grad.numpy()
                                    for k, t in leaves_named(p)}}
    for r in runs["ranks"]:
        got = next(b for b in r["sp_blocks"] if b["name"] == block)
        np.testing.assert_allclose(got["y"], y.detach().numpy(), atol=1e-5,
                                   rtol=1e-5)
        assert sorted(got["grads"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["grads"][k], w,
                                       atol=1e-5 * np.abs(w).max(),
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("group", [1024, 32])
def test_moe_routing_hook_and_aux_loss_on_dtensors(runs, group):
    """On the (2, 2) mesh, in one group that ``data`` splits (the smoke
    config's 1,024, capped at the 128 tokens) and in groups of 32 that
    it does not, the hook sees the global ``[B, T, K]`` ids the plain
    model's sees, and a planted routing moves both losses alike;
    ``router_aux_loss`` on DTensors equals its plain value."""
    for r in runs["ranks"]:
        got = r["moe"]
        for label in ("own", "planted"):
            plain = got[f"{label}_plain_g{group}"]
            part = got[f"{label}_partitioned_g{group}"]
            np.testing.assert_allclose(part["loss"], plain["loss"],
                                       rtol=E2E_LOSS_RTOL)
            assert len(part["ids"]) == len(plain["ids"]) == 2
            for a, b in zip(part["ids"], plain["ids"]):
                assert a.shape == (B, MODELS["moe"][2], 4)
                assert np.array_equal(a, b)
        assert got[f"planted_plain_g{group}"]["loss"] != \
            got[f"own_plain_g{group}"]["loss"]
        np.testing.assert_allclose(got["aux"][1], got["aux"][0], rtol=1e-6)


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
