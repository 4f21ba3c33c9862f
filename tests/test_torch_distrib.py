"""The port's ``distrib/`` and its multi-process paths against the JAX
package.

* The sharding rules (``param_spec``, ``param_spec_named``,
  ``batch_spec``, ``cache_spec``, ``fsdp_needed``) ``==`` JAX's on
  ``AbstractMesh((2, 16, 16), ...)`` and ``((16, 16), ...)``, over the
  shape and batch sets of tests/test_distrib.py:22-49 and its fixed
  cases; the ``*_shardings`` as DTensor placements.
* ``choose_tiers`` / ``dcn_bytes_per_step`` ``==`` JAX's, and the bytes
  the int8 tier ships ``==`` ``int8_leaf_bytes`` (tests/test_distrib.py:
  96-127).
* On gloo at world size 2 (one spawn of ``tests.torch_distrib_worker``,
  two ranks), beside one JAX subprocess on a 2-device ``("pod",)`` mesh
  (``tests.jax_distrib_twin``), both started together:
  ``tiered_grad_sync(tiers=None)`` equals JAX's bitwise; the int8 tier
  stays within one quantization step of the exact mean; the hier step
  (``make_train_step(hier_sync=True, tiers=None)``) on the qwen2.5-3b
  smoke config in f32 from the same params matches JAX's hier step, the
  loss at rtol 1e-6 and the params at the end-to-end f32 tolerance of
  tests/test_kernel_oracle.py (``E2E_PARAM_ATOL`` / ``E2E_PARAM_RTOL``,
  the one tests/test_torch_train_step.py holds training steps to); the
  ``cloud_mesh`` tree step equals the single-rank tree step on the tiny
  MLP and schedule of tests/test_distrib.py:207-224 at that test's
  tolerances (the all-reduce reorders sums), and its 23-sample guard
  fires; every rank ends with the same params.
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

from repro.core.wire import int8_leaf_bytes as jax_int8_leaf_bytes
from repro.distrib import sharding as jsh
from repro.distrib import tiered_sync as jts
from repro.configs import get_arch as jax_get_arch
from repro.models.lm.model import build_model as jax_build_model
from repro_torch import configs
from repro_torch.convert import model_params_to_numpy, params_to_numpy
from repro_torch.core.cost_model import MultiSchedule
from repro_torch.core.hybrid_step import tree_hybrid_step_from_schedule
from repro_torch.core.wire import int8_leaf_bytes
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.distrib import compat
from repro_torch.distrib import sharding as sh
from repro_torch.distrib import tiered_sync as ts
from repro_torch.kernels import ops as kops
from repro_torch.models.lm.common import ambient_abstract_mesh, shard_hint
from repro_torch.models.lm.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train import init_state
from repro_torch.tree import leaves
from tests._compat import given, settings, st
from tests.test_kernel_oracle import E2E_PARAM_ATOL, E2E_PARAM_RTOL
from tests.test_torch_smoke_training import (KERNELS, cpu_card,  # noqa: F401
                                             deterministic_imported)
from tests.torch_distrib_worker import tiny_mlp

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2


def abstract_mesh(sizes, names):
    """jax's device-free mesh under either ``AbstractMesh`` signature."""
    try:
        return jax.sharding.AbstractMesh(sizes, names)
    except TypeError:
        return jax.sharding.AbstractMesh(tuple(zip(names, sizes)))


NAMES3, NAMES2 = ("pod", "data", "model"), ("data", "model")
MESHES = ((sh.MeshShape((2, 16, 16), NAMES3),
           abstract_mesh((2, 16, 16), NAMES3)),
          (sh.MeshShape((16, 16), NAMES2), abstract_mesh((16, 16), NAMES2)))
MESH, SINGLE = MESHES[0][0], MESHES[1][0]
LEAF_NAMES = ("wq", "wo", "w_down", "lm_head", "embed", "bq", "norm")


def spec(p) -> tuple:
    return tuple(p)


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------


@settings(max_examples=80, deadline=None)
@given(shape=st.lists(st.sampled_from(
    [1, 2, 3, 8, 16, 32, 60, 112, 128, 151936, 4096]),
    min_size=1, max_size=4).map(tuple))
def test_param_specs_equal_jax(shape):
    for mesh, jmesh in MESHES:
        for fsdp in (True, False):
            got = sh.param_spec(mesh, shape, fsdp)
            assert got == spec(jsh.param_spec(jmesh, shape, fsdp))
            for name in LEAF_NAMES:
                assert sh.param_spec_named(mesh, name, shape, fsdp) == \
                    spec(jsh.param_spec_named(jmesh, name, shape, fsdp))
        # the properties tests/test_distrib.py asserts
        got = sh.param_spec(mesh, shape)
        assert len(got) in (0, len(shape))
        used = [a for a in got if a is not None]
        assert len(set(used)) == len(used), "axis used twice"
        for i, a in enumerate(got):
            assert a is None or shape[i] % sh.axis_size(mesh, a) == 0
        if len(shape) >= 3:
            assert got[0] is None, "layer-stack dim sharded"


@settings(max_examples=50, deadline=None)
@given(batch=st.sampled_from([1, 2, 16, 32, 128, 256, 255]),
       ndim=st.integers(1, 4))
def test_batch_spec_equals_jax(batch, ndim):
    for mesh, jmesh in MESHES:
        got = sh.batch_spec(mesh, batch, ndim)
        assert got == spec(jsh.batch_spec(jmesh, batch, ndim))
        if got[0] is not None:
            names = got[0] if isinstance(got[0], tuple) else (got[0],)
            prod = int(np.prod([sh.axis_size(mesh, a) for a in names]))
            assert batch % prod == 0


@settings(max_examples=60, deadline=None)
@given(shape=st.lists(st.sampled_from([1, 2, 4, 16, 24, 64, 128, 32768]),
                      min_size=1, max_size=5).map(tuple),
       batch=st.sampled_from([1, 16, 32, 128]))
def test_cache_spec_equals_jax(shape, batch):
    for mesh, jmesh in MESHES:
        assert sh.cache_spec(mesh, shape, batch) == \
            spec(jsh.cache_spec(jmesh, shape, batch))


def test_fixed_cases_of_the_reference():
    """tests/test_distrib.py:52-94 on the port's rules."""
    s = sh.cache_spec(SINGLE, (24, 128, 32768, 16, 128), 128)
    assert s[3] == "model" and s[2] is None
    s = sh.cache_spec(SINGLE, (52, 128, 32768, 1, 128), 128)
    assert s[2] == "model" and s[3] is None
    for mesh in (MESH, SINGLE):
        assert sh.batch_spec(mesh, 1, 2) == (None, None)
    assert sh.batch_spec(MESH, 16, 2) == ("data", None)
    assert sh.batch_spec(MESH, 64, 3) == (("pod", "data"), None, None)
    assert sh.cache_spec(MESH, (40, 32, 4096, 1, 64), 32) == \
        (None, ("pod", "data"), "model", None, None)
    assert sh.cache_spec(MESH, (40, 32, 4096, 16, 64), 32) == \
        (None, ("pod", "data"), None, "model", None)
    assert sh.param_spec(SINGLE, (24, 4096, 1024)) == (None, "model", "data")
    assert sh.param_spec(SINGLE, (24, 1024, 4096)) == (None, "data", "model")
    assert sh.param_spec(SINGLE, (24, 1024, 4096), fsdp=False) == \
        (None, None, "model")
    assert sh.param_spec(SINGLE, (24, 151, 4096)) == (None, None, "model")
    for mesh, jmesh in MESHES:
        assert sh.dp_axes(mesh) == jsh.dp_axes(jmesh)
        for n, opt in ((3_000_000_000, 8), (100_000_000, 8), (10**9, 2)):
            assert sh.fsdp_needed(mesh, n, opt) == \
                jsh.fsdp_needed(jmesh, n, opt)


def test_shardings_are_the_specs_as_placements():
    from torch.distributed.tensor import Replicate, Shard
    params = {"layers": [{"wq": (24, 1024, 4096), "wo": (24, 4096, 1024)}],
              "embed": torch.empty((151936, 2048), device="meta"),
              "norm": (2048,)}
    got = sh.param_shardings(MESH, params)
    assert got["layers"][0]["wq"] == (Replicate(), Shard(1), Shard(2))
    assert got["layers"][0]["wo"] == (Replicate(), Shard(2), Shard(1))
    assert got["embed"] == sh.placements(MESH, sh.param_spec(
        MESH, (151936, 2048)))
    assert got["norm"] == sh.replicated(MESH) == (Replicate(),) * 3
    opt = sh.opt_state_shardings(MESH, {"m": params, "step": ()})
    assert opt["m"] == got and opt["step"] == sh.replicated(MESH)
    batch = sh.batch_shardings(MESH, {"tokens": (64, 512), "one": (1, 8)})
    assert batch == {"tokens": (Shard(0), Shard(0), Replicate()),
                     "one": sh.replicated(MESH)}
    cache = sh.cache_shardings(MESH, {"k": (40, 32, 4096, 1, 64)}, 32)
    assert cache["k"] == (Shard(1), Shard(1), Shard(2))


# ---------------------------------------------------------------------------
# Tier choice and the int8 bytes
# ---------------------------------------------------------------------------


def test_int8_sync_bytes_single_source():
    """The bytes the int8 tier ships per leaf (codes + row scales of
    ``_as_2d``) ``==`` ``int8_leaf_bytes``, the JAX package's too; the tier
    chooser and ``dcn_bytes_per_step`` charge the same formula."""
    shapes = {"w2d": (64, 32), "b1d": (128,), "stack3d": (4, 16, 8)}
    g = torch.Generator().manual_seed(0)
    for k, s in shapes.items():
        a2, shape = ts._as_2d(torch.randn(s, generator=g))
        q, scale = kops.quantize_int8(a2, g)
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        shipped = q.numel() * q.element_size() + \
            scale.numel() * scale.element_size()
        assert shipped == int8_leaf_bytes(s) == jax_int8_leaf_bytes(s), k
    tiers = ts.choose_tiers(shapes, n_pods=2, dcn_bytes_per_s=1.0,
                            compute_seconds=1e-12)     # force all-int8
    assert all(leaves(tiers.quantized))
    want_wire = sum(int8_leaf_bytes(s) for s in shapes.values())
    assert tiers.back_wire_bytes == want_wire
    assert ts.dcn_bytes_per_step(tiers, 2) == want_wire * 0.5
    assert tiers.sync_seconds == want_wire * 0.5


def _smoke_shapes():
    cfg = configs.get_arch("qwen2.5-3b").smoke
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.eval_shape(jax_build_model(
        jax_get_arch("qwen2.5-3b").smoke).init, jax.random.PRNGKey(0))
    return params, jshapes


@pytest.mark.parametrize("n_pods", [2, 4])
def test_choose_tiers_equals_jax(n_pods):
    params, jshapes = _smoke_shapes()
    assert [tuple(t.shape) for t in leaves(params)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jshapes)]
    for dcn, compute in ((25e9, 1.0), (1e6, 1.0), (1e6, 0.5),
                         (1.0, 1e-12)):
        got = ts.choose_tiers(params, n_pods=n_pods, dcn_bytes_per_s=dcn,
                              compute_seconds=compute)
        want = jts.choose_tiers(jshapes, n_pods=n_pods, dcn_bytes_per_s=dcn,
                                compute_seconds=compute)
        assert leaves(got.quantized) == jax.tree.leaves(want.quantized)
        assert (got.front_bytes, got.back_bytes, got.back_wire_bytes,
                got.sync_seconds) == (want.front_bytes, want.back_bytes,
                                      want.back_wire_bytes,
                                      want.sync_seconds)
        assert got.describe() == want.describe()
        assert ts.dcn_bytes_per_step(got, n_pods) == \
            jts.dcn_bytes_per_step(want, n_pods)
    mixed = ts.choose_tiers(params, n_pods=n_pods, dcn_bytes_per_s=1e6,
                            compute_seconds=1.0)
    assert 0 < sum(leaves(mixed.quantized)) < len(leaves(params))


# ---------------------------------------------------------------------------
# The ambient mesh off the process group
# ---------------------------------------------------------------------------


def test_shard_hint_is_the_identity_on_plain_tensors():
    x = torch.ones(4, 3)
    assert compat.current_mesh() is None and ambient_abstract_mesh() is None
    assert shard_hint(x, ("pod", "data"), None) is x
    with compat.set_mesh(MESH) as m:
        assert compat.current_mesh() is m and ambient_abstract_mesh() is m
        assert shard_hint(x, ("pod", "data"), "model") is x
        with compat.set_mesh(SINGLE):
            assert compat.current_mesh() is SINGLE
        assert compat.current_mesh() is m
    assert compat.current_mesh() is None
    with compat.set_mesh(sh.MeshShape((), ())):
        assert ambient_abstract_mesh() is None


def test_tiered_sync_needs_the_axis():
    g = {"w": torch.ones(2, 2)}
    with pytest.raises(ValueError, match="'pod'"):
        ts.tiered_grad_sync(g, None, 0)
    with compat.set_mesh(SINGLE), pytest.raises(ValueError, match="'pod'"):
        ts.tiered_grad_sync(g, None, 0)


# ---------------------------------------------------------------------------
# Two ranks on gloo beside the JAX twin on a 2-device mesh
# ---------------------------------------------------------------------------

OPT_KW = dict(lr=0.05, weight_decay=0.01)
TREE_SCHED = dict(worker_o="cloud", worker_l="device_3",
                  s_workers=("device_0", "device_1", "device_2", "edge_0",
                             "edge_1"),
                  m_s=(2, 2, 1, 2, 1), m_l=3, b_o=6, b_s=(4, 3, 3, 5, 3),
                  b_l=0)
TREE_EDGES = (0, 0, 1, 0, 1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distrib")
    rng = np.random.default_rng(0)
    grads = {"big": rng.standard_normal((8, 64, 32)).astype(np.float32),
             "small": rng.standard_normal((8, 8)).astype(np.float32)}
    cfg = configs.get_arch("qwen2.5-3b").smoke
    opt = get_optimizer("sgdm", **OPT_KW)
    state = init_state(build_model(cfg), opt,
                       torch.Generator().manual_seed(0), "cpu")
    data = SyntheticTokens(cfg.vocab, 16, 4, seed=1)
    mlp_params = tiny_mlp().init(torch.Generator().manual_seed(1), "cpu")
    inputs = {
        "grads": grads, "opt_kw": OPT_KW,
        "lm_params": model_params_to_numpy(state["params"]),
        "batches": [data.batch(i) for i in range(2)],
        "tree": {"params": params_to_numpy(mlp_params),
                 "x": rng.standard_normal((24, 8)).astype(np.float32),
                 "y": rng.integers(0, 5, 24).astype(np.int64),
                 "sched": TREE_SCHED, "edges": TREE_EDGES,
                 "bad": dict(TREE_SCHED, b_o=5)}}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-m", "tests.torch_distrib_worker", str(r),
             str(WORLD), str(tmp / "store"), str(tmp / "inputs.pkl"),
             str(tmp / f"rank{r}.pkl")] for r in range(WORLD)]
    cmds.append([sys.executable, "-m", "tests.jax_distrib_twin",
                 str(tmp / "inputs.pkl"), str(tmp / "jax.pkl")])
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        logs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    out = {}
    for name in [f"rank{r}" for r in range(WORLD)] + ["jax"]:
        with open(tmp / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    out["inputs"] = inputs
    return out


def _ranks(runs):
    return [runs[f"rank{r}"] for r in range(WORLD)]


def test_tiered_sync_full_width_equals_jax(runs):
    grads = runs["inputs"]["grads"]
    for r in _ranks(runs):
        for k, g in grads.items():
            halves = g.reshape(WORLD, -1, *g.shape[1:])
            assert np.array_equal(r["sync_none"][k], runs["jax"]["sync_none"]
                                  [k])
            assert np.array_equal(r["sync_none"][k],
                                  (halves[0] + halves[1]) / np.float32(2))
        # a strided leaf goes to the collective dense (NCCL's rule)
        assert np.array_equal(r["sync_strided"]["big_t"],
                              r["sync_none"]["big"].transpose(0, 2, 1))


def test_int8_tier_stays_within_one_quantization_step(runs):
    grads = runs["inputs"]["grads"]
    for r in _ranks(runs):
        assert all(leaves(r["sync_int8_tiers"].quantized))
        for k, g in grads.items():
            per_pod = g.reshape(WORLD, -1, *g.shape[1:])
            step = np.abs(per_pod).max() / 127.0
            err = np.abs(r["sync_int8"][k] - per_pod.mean(0))
            assert err.max() <= step + 1e-6, (k, err.max(), step)
    a, b = _ranks(runs)
    for k in grads:
        assert np.array_equal(a["sync_int8"][k], b["sync_int8"][k])


def test_hier_step_matches_jax(runs):
    want = runs["jax"]["hier_none"]
    for r in _ranks(runs):
        got = r["hier_none"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(want["params"])):
            np.testing.assert_allclose(a, b, atol=E2E_PARAM_ATOL,
                                       rtol=E2E_PARAM_RTOL)
        assert "does not divide" in r["hier_indivisible"]


def test_ranks_end_with_the_same_params(runs):
    a, b = _ranks(runs)
    for key in ("hier_none", "hier_int8", "cloud_data",
                "cloud_pod_data_model"):
        for x, y in zip(jax.tree.leaves(a[key]["params"]),
                        jax.tree.leaves(b[key]["params"])):
            assert np.array_equal(x, y), key
    # the int8 tier moved the step, but only by its rounding
    for x, y in zip(jax.tree.leaves(a["hier_int8"]["params"]),
                    jax.tree.leaves(a["hier_none"]["params"])):
        assert np.all(np.isfinite(x))
        np.testing.assert_allclose(x, y, atol=0.05, rtol=0)


def test_cloud_mesh_tree_step_equals_the_single_rank_step(runs):
    tree = runs["inputs"]["tree"]
    from repro_torch.convert import params_from_numpy
    p_ref, l_ref = tree_hybrid_step_from_schedule(
        tiny_mlp(), params_from_numpy(tree["params"]),
        torch.from_numpy(tree["x"]), torch.from_numpy(tree["y"]),
        MultiSchedule(**TREE_SCHED), 0.05, stream_edge=TREE_EDGES)
    want = params_to_numpy(p_ref)
    for r in _ranks(runs):
        for key in ("cloud_data", "cloud_pod_data_model"):
            np.testing.assert_allclose(r[key]["loss"], float(l_ref),
                                       rtol=1e-6)
            for a, b in zip(jax.tree.leaves(r[key]["params"]),
                            jax.tree.leaves(want)):
                np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)
        # one dp axis of 2, or pod 2 x data 1: the same shards and sums
        for a, b in zip(jax.tree.leaves(r["cloud_data"]["params"]),
                        jax.tree.leaves(r["cloud_pod_data_model"]
                                        ["params"])):
            assert np.array_equal(a, b)
        assert "divisible" in r["cloud_indivisible"]


def test_shard_hint_redistributes_a_dtensor(runs):
    for rank, r in enumerate(_ranks(runs)):
        placed, local, whole = r["shard_hint"]["sharded"]
        assert placed and whole
        full = np.arange(4 * WORLD * 3, dtype=np.float32).reshape(-1, 3)
        assert np.array_equal(local, full[rank * 4:(rank + 1) * 4])
        assert r["shard_hint"]["dropped"] and r["shard_hint"]["plain"]


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 13 rehearsed on a one-rank gloo group
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group (the card's phase uses NCCL), destroyed
    after; yields its ``("pod",)`` and ``("data",)`` meshes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield (init_device_mesh("cpu", (1,), mesh_dim_names=("pod",)),
               init_device_mesh("cpu", (1,), mesh_dim_names=("data",)))
    finally:
        dist.destroy_process_group()


@pytest.fixture
def counted_quantizer(monkeypatch):
    from repro_torch.kernels import int8_quant as iq
    real = iq.quantize_int8

    def counted(*args, **kw):
        iq.launches += 1
        return real(*args, **kw)
    monkeypatch.setattr(iq, "quantize_int8", counted)


def test_run_hier_rehearsed(deterministic_imported, cpu_card,
                            counted_quantizer, one_rank, monkeypatch):
    """``run_hier`` on qwen2.5-3b's smoke twin in bf16 (B=2, T=16): the
    full-width step bitwise the flat step, both int8 settings bitwise the
    plain-quantizer composition, the launch counts, and the rows phase 3
    must hold."""
    import chip_smoke
    from repro_torch import optim, train
    from repro_torch.data.pipeline import make_lm_batch_fn
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ref
    from repro_torch.models.lm import model as lm_model
    from repro_torch.train import step as step_mod
    monkeypatch.setattr(chip_smoke, "HIER_STEPS", 2)
    monkeypatch.setattr(chip_smoke, "HIER_MIXED",
                        dict(dcn_bytes_per_s=1e6, compute_seconds=0.5))
    cfg = configs.get_arch("qwen2.5-3b").smoke.variant(
        dtype=torch.bfloat16, use_flash=True)
    rows = chip_smoke.hier_sync_rows(torch, lm_model, ts, cfg)
    with chip_smoke.deterministic(torch):
        run = chip_smoke.run_hier(
            torch, KERNELS, ref, lm_model, optim, train, step_mod, ts,
            compat, make_lm_batch_fn, ShapeSpec("hier", 16, 2, "train"),
            cfg, one_rank[0], rows)
    n_leaves = len(leaves(build_model(cfg).init(torch.Generator(), "cpu")))
    demoted = {k: len(r["demoted"]) for k, r in run["tiers"].items()}
    assert demoted["none"] == 0 < demoted["mixed"] < demoted["int8"] == \
        n_leaves
    for k, r in run["tiers"].items():
        assert r["equal"] and len(r["step_ms"]) == 2
        assert r["launches"] == {"int8_quant": demoted[k],
                                 "flash_attention": 2 * cfg.n_layers,
                                 "gla_scan": 0}
    with pytest.raises(SystemExit):       # a row phase 3 did not hold
        chip_smoke.run_hier(
            torch, KERNELS, ref, lm_model, optim, train, step_mod, ts,
            compat, make_lm_batch_fn, ShapeSpec("hier", 16, 2, "train"),
            cfg, one_rank[0], rows[1:])


def test_run_cloud_rehearsed(cpu_card, one_rank, monkeypatch):
    """``run_cloud`` on the narrow AlexNet of tests/test_torch_cnn.py over
    phase 8's E=2 tree (B=16): bitwise the step without ``cloud_mesh`` at
    one rank, the same launches, and the guard."""
    import types
    import chip_smoke
    import repro_torch.api as api
    from repro_torch.models import cnn
    from tests.test_torch_cnn import alexnet_narrow
    monkeypatch.setattr(chip_smoke, "B", 16)
    monkeypatch.setattr(chip_smoke, "TIMED_STEPS", 1)
    g = torch.Generator().manual_seed(0)
    monkeypatch.setattr(chip_smoke, "batch", lambda torch: (
        torch.randn((16, 64, 64, 3), generator=g),
        torch.randint(0, 200, (16,), generator=g)))
    run = chip_smoke.run_cloud(
        torch, api, types.SimpleNamespace(alexnet=lambda: alexnet_narrow(
            cnn)), KERNELS, sh, one_rank[1])
    assert run["bitwise"] and "divisible" in run["guard"]
    assert run["launches"]["int8_quant"] > 0
    assert [len(v) for v in run["step_ms"].values()] == [1, 1]


@pytest.mark.parametrize("arch", ["zamba2-7b", "qwen2-moe-a2.7b",
                                  "xlstm-350m", "whisper-base"])
def test_run_partition_family_rehearsed(arch, deterministic_imported,
                                        cpu_card, one_rank, monkeypatch):
    """Phase 16's ``run_partition_family`` on a one-rank gloo group and a
    ``(1, 1)`` ``(data, model)`` mesh, on each family's smoke twin in
    bf16 with both kernel routes (B=2 x 32): the flat and partitioned
    runs launch flash and the GLA ``flat_launches`` times a step,
    placements are kept, no collective runs, and the losses and params
    are bitwise the flat run's.  The card holds the AdamW moments
    bitwise too; on the CPU the xlstm twin's ``b_fgate`` moments came out
    a rounding apart, so they are not held here."""
    import chip_smoke
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch import optim, train
    from repro_torch.data.pipeline import make_lm_batch_fn
    from repro_torch.distrib import partition
    from repro_torch.models.lm import model as lm_model
    assert arch in dict(chip_smoke.PART_FAMILIES)
    monkeypatch.setattr(chip_smoke, "PART_B", 2)
    monkeypatch.setattr(chip_smoke, "PART_T", 32)
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda v, device=None, **kw:
                        as_tensor(v, **kw))
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = configs.get_arch(arch).smoke.variant(
        dtype=torch.bfloat16, use_flash=True, use_gla_kernel=True)
    run = chip_smoke.run_partition_family(
        torch, KERNELS, mesh, lm_model, optim, train, partition, sh,
        make_lm_batch_fn, cfg, {})
    per_step = chip_smoke.flat_launches(cfg)
    assert run["launches_per_step"] == per_step
    assert run["launches"] == {k: chip_smoke.PART_STEPS * v
                               for k, v in per_step.items()}
    assert run["flat"]["launches"] == [per_step] * chip_smoke.PART_STEPS
    assert run["kept"] == [True] * chip_smoke.PART_STEPS
    assert run["comms"] == [{}] * chip_smoke.PART_STEPS
    assert run["losses"] == run["flat"]["losses"]
    assert run["differing_params"] == []
    assert run["bitwise"] or arch == "xlstm-350m"
    assert len(run["step_ms"]) == chip_smoke.PART_TIMED
