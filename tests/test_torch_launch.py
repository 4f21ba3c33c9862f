"""The port's ``launch/`` against the JAX package's, and its meta routes.

* The dry run's decisions and state bytes ``==`` the reference's for
  every arch, every cell of its ``shapes`` and both production meshes:
  total and active params, model FLOPs, ``fsdp``, ``seq_parallel``, the
  microbatch count, the per-device bytes of the sharded params and
  optimizer state, and the multi-pod train cells' ``choose_tiers``
  assignment against the port's H100 figures.  The JAX side runs in a
  subprocess on 512 placeholder host devices (``tests.jax_launch_twin``),
  started beside the port's side; the port's side lowers each cell on
  the production meshes over the fake backend (a train cell's state and
  batch are DTensors there).
* ``Roofline.row()`` ``==`` the reference's on the same inputs.
* The micro cell of tests/test_distrib.py:248-295 through ``lower_cell``
  / ``analyse`` on a ``(2, 2, 2)`` mesh over the fake backend: the
  qwen2.5-3b smoke config, 8 x 64 tokens, 2 microbatches, every leaf on
  the int8 tier.  Its collectives equal the sum worked out from the
  parameter shapes: per leaf an all-gather of the int8 codes (rows x
  cols bytes) and one of the f32 row scales (4 rows bytes), by
  ``_as_2d``'s rows, and the loss's all-reduce; the microbatch-multiply
  rule equals a full trace; the counted FLOPs equal ``FlopCounterMode``'s.
* The partitioned program: a smoke train cell through ``lower_cell`` /
  ``analyse`` on a fake ``(2, 2)`` mesh records one device (``chips``
  the mesh's, arguments the state shards and the batch block, TP / FSDP
  collectives, FLOPs between 1/``model`` and 1 of the whole-weight
  rank's); the microbatch split of a batch over several ranks (the
  regression of the strided-shard failure) on ``(2, 2, 2)`` and
  ``(4, 2)``; ``Tally`` on DTensors counts the local work and DTensor's
  collectives.
* ``block_flops`` inside the reference's bands (tests/test_lm_layerstack.py:
  195-213) on its four tiny configs, the head within 1 %.
* The meta routes: initialisers draw nothing, the kernel wrappers return
  meta tensors and count no launch, the production meshes and the CLI
  leave no process group behind.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
# imported before cpu_card replaces torch.Generator: its annotations
# read that name when the module loads
import torch.distributed.tensor  # noqa: F401

from repro.launch import hlo_analysis as jha
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.distrib import MeshShape
from repro_torch.distrib import tiered_sync as ts
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gs
from repro_torch.kernels import int8_quant as iq
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as ha
from repro_torch.launch import mesh as lmesh
from repro_torch.models import cnn
from repro_torch.models.lm import layerstack as tls
from repro_torch.models.lm.common import truncated_normal_init
from repro_torch.models.lm.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves
from tests.test_lm_layerstack import CFGS as JAX_TINY
from tests.test_lm_layerstack import T as TINY_T
from tests.test_torch_lm import to_torch_config
from tests.test_torch_serve import one_thread  # noqa: F401
from tests.test_torch_smoke_training import KERNELS, cpu_card  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": MeshShape((16, 16), ("data", "model")),
          "multi": MeshShape((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s, m) for a in sorted(configs.ARCHS)
         for s in configs.get_arch(a).shapes for m in MESHES]
EXACT = ("total_params", "active_params", "model_flops", "fsdp",
         "seq_parallel", "microbatches", "sharded_state_bytes")


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """(port fields, JAX fields) of every cell, keyed ``arch|shape|mesh``;
    the JAX twin runs while the port's side is built."""
    tmp = tmp_path_factory.mktemp("launch")
    with open(tmp / "hw.json", "w") as f:
        json.dump({"peak_flops": lmesh.H100.peak_flops,
                   "dcn_bw": lmesh.H100.dcn_bw}, f)
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tests.jax_launch_twin", str(tmp / "hw.json"),
         str(tmp / "jax.json")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        port = {}
        for m in MESHES:
            mesh = lmesh.make_production_mesh(multi_pod=m == "multi")
            for arch, shape, _ in (c for c in CELLS if c[2] == m):
                hier = m == "multi" and configs.SHAPES[shape].kind == "train"
                _, meta = dryrun.lower_cell(arch, shape, mesh, hier=hier)
                port[f"{arch}|{shape}|{m}"] = meta
        log = proc.communicate(timeout=300)[0]
    finally:
        lmesh.release_production_mesh()
        proc.kill()
    assert proc.returncode == 0, log
    with open(tmp / "jax.json") as f:
        return port, json.load(f)


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_cell_fields_equal_jax(twin, arch, shape, mesh):
    port, jax_out = twin
    key = f"{arch}|{shape}|{mesh}"
    got, want = port[key], jax_out[key]
    assert {k: got[k] for k in EXACT} == {k: want[k] for k in EXACT}
    assert got.get("tiers") == want.get("tiers")


def test_every_cell_was_compared(twin):
    port, jax_out = twin
    assert sorted(port) == sorted(jax_out) and len(port) == len(CELLS)
    assert any("tiers" in v for v in jax_out.values())


@pytest.mark.parametrize("inputs", [
    (3.2e15, 7.1e12, 4.4e9, 256, 2.0e16),
    (1.0e12, 9.9e13, 0.0, 512, 0.0),
    (5.0e14, 1.0e12, 3.0e12, 32, 1.2e17)])
def test_roofline_equals_the_reference(inputs):
    flops, nbytes, coll, chips, model_flops = inputs
    hw = lmesh.H100
    kw = dict(flops_per_device=flops, bytes_per_device=nbytes,
              collective_bytes_per_device=coll, chips=chips,
              peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, link_bw=hw.ici_bw,
              model_flops=model_flops)
    assert ha.Roofline(**kw).row() == jha.Roofline(**kw).row()
    stats = {"all-gather": 3_000_000_000, "all-reduce": 4}
    counts = {"all-gather": 6, "all-reduce": 1}
    assert ha.CollectiveStats(stats, counts).describe() == \
        jha.CollectiveStats(stats, counts).describe()


def test_h100_constants():
    hw = lmesh.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.dcn_bw) == \
        (989e12, 3.35e12, 450e9, 50e9)
    assert hw.hbm_bytes == 81_559 * 2 ** 20
    assert [f.name for f in dataclasses.fields(hw)] == \
        ["peak_flops", "hbm_bw", "ici_bw", "dcn_bw", "hbm_bytes"]


# ---------------------------------------------------------------------------
# The micro cell on a (2, 2, 2) mesh over the fake backend
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_mesh():
    """A ``(2, 2, 2)`` ``("pod", "data", "model")`` mesh over an 8-rank
    fake group, destroyed after."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (2, 2, 2),
                               mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def _all_int8(cfg):
    params = build_model(cfg).init(torch.Generator(), "meta")
    tiers = ts.choose_tiers(params, n_pods=2, dcn_bytes_per_s=1e3,
                            compute_seconds=1e-9)
    assert all(leaves(tiers.quantized))
    return params, tiers


def _micro(mesh, global_batch: int, microbatches: int):
    cfg = configs.get_arch("qwen2.5-3b").smoke
    params, tiers = _all_int8(cfg)
    return params, dryrun.lower_cell(
        "qwen2.5-3b", ShapeSpec("micro", 64, global_batch, "train"), mesh,
        hier=True, microbatches=microbatches, smoke=True, tiers=tiers)


def test_micro_cell_collectives_equal_the_shapes_sum(fake_mesh, one_thread):
    params, (program, meta) = _micro(fake_mesh, 8, 2)
    assert meta["tiers"] and meta["ranks"] == 4
    tokens = program.args[1]["tokens"]
    assert tokens.shape == (4, 64) and tokens.device.type == "meta"
    out = dryrun.analyse(program, meta)
    assert out["xla_cost"]["flops_per_dev"] > 0
    assert out["xla_cost"]["bytes_per_dev"] > 0
    assert out["memory"]["peak_gb"] > 0
    assert out["memory"]["argument_gb"] > 0
    rows_cols = [ts._as_2d(p)[0].shape for p in leaves(params)]
    gather = sum(r * c + 4 * r for r, c in rows_cols)
    want_gb = {"all-gather": gather / 1e9, "all-reduce": 4 / 1e9}
    assert out["collectives"]["counts"] == {"all-gather": 2 * len(rows_cols),
                                            "all-reduce": 1}
    assert out["collectives"]["by_kind_gb"] == want_gb
    assert out["collectives"]["loop_aware_gb"] == \
        out["collectives"]["static_total_gb"] == pytest.approx(
            (gather + 4) / 1e9, rel=1e-15)
    from repro_torch.distrib import compat
    with compat.set_mesh(fake_mesh):
        stats = ha.collective_bytes(program.fn, *program.args)
    assert stats.bytes_by_kind == {"all-gather": gather, "all-reduce": 4}
    assert stats.count_by_kind == out["collectives"]["counts"]
    hw = lmesh.H100                   # the record rounds to 6 decimals
    roof = ha.Roofline(out["xla_cost"]["flops_per_dev"],
                       out["xla_cost"]["bytes_per_dev"], gather + 4, 4,
                       hw.peak_flops, hw.hbm_bw, hw.ici_bw,
                       meta["model_flops"])
    assert all(np.isfinite(t) and t > 0 for t in
               (roof.compute_s, roof.memory_s, roof.collective_s))
    assert out["roofline"] == {k: (round(v, 6) if isinstance(v, float)
                                   else v) for k, v in roof.row().items()}


def test_microbatch_multiply_equals_a_full_trace(fake_mesh, one_thread):
    """Four microbatches of one sequence: the first traced once and the
    second three times equals tracing all four."""
    got = {}
    for trips in (True, False):
        _, (program, meta) = _micro(fake_mesh, 16, 4)
        got[trips] = dryrun.measure(program, model_flops=meta["model_flops"],
                                    ranks=meta["ranks"], trips=trips)
    full, mult = got[False], got[True]
    assert mult["ops"] < full["ops"]
    assert mult["xla_cost"] == full["xla_cost"]
    assert mult["collectives"] == full["collectives"]
    assert mult["memory"]["peak_gb"] == full["memory"]["peak_gb"]


def test_counted_flops_equal_flop_counter_mode(one_thread):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = configs.get_arch("qwen2.5-3b").smoke
    model, opt = build_model(cfg), get_optimizer("adamw")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    state = {"params": params, "opt": opt.init(params)}
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), dtype=torch.int32,
                              generator=torch.Generator().manual_seed(1))
             for k in ("tokens", "targets")}
    step = make_train_step(model, opt, microbatches=2)
    flops, nbytes, coll = ha.step_cost(step, state, batch, 0)
    counter = FlopCounterMode(display=False)
    with counter:
        step(state, batch, 0)
    assert flops == counter.get_total_flops() > 0
    assert nbytes > 0 and coll == 0


# ---------------------------------------------------------------------------
# The partitioned program: a train cell's state and batch as DTensors
# ---------------------------------------------------------------------------


def _whole_rank_flops(cfg, shape, mb: int, data: int) -> float:
    """FLOPs of the unpartitioned step of one data-parallel rank holding
    whole weights, on its block of the batch, traced on meta."""
    model, opt = build_model(cfg), get_optimizer("adamw")
    params = model.init(torch.Generator(), "meta")
    batch = {k: torch.empty((shape.global_batch // data, shape.seq_len),
                            dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    return ha.step_cost(make_train_step(model, opt, microbatches=mb),
                        {"params": params, "opt": opt.init(params)},
                        batch, 0)[0]


@pytest.mark.parametrize("fsdp", [False, True])
def test_train_cell_traces_the_partitioned_program(fsdp, one_thread):
    """qwen2.5-3b's smoke config, 8 x 64 tokens in 2 microbatches, on a
    fake ``(data, model) = (2, 2)`` mesh: the record is per device of the
    partitioned program (``chips`` the mesh's 4 devices, the arguments
    the state shards and the batch block, TP / FSDP collectives), its
    FLOPs between 1/``model`` and 1 of the whole-weight rank's."""
    shape = ShapeSpec("micro", 64, 8, "train")
    mesh = lmesh.make_fake_mesh((2, 2), ("data", "model"))
    try:
        program, meta = dryrun.lower_cell("qwen2.5-3b", shape, mesh,
                                          microbatches=2, smoke=True,
                                          fsdp=fsdp)
        state, batch = program.args[:2]
        assert all(x.to_local().device.type == "meta"
                   for x in leaves([state, batch]))
        out = dryrun.analyse(program, meta)
    finally:
        lmesh.release_production_mesh()
    assert out["partitioned"] and out["ranks"] == 4
    batch_bytes = 2 * (8 // 2) * 64 * 4        # tokens, targets: int32
    assert out["memory"]["argument_gb"] * 1e9 == pytest.approx(
        out["sharded_state_bytes"] + batch_bytes, rel=1e-12)
    assert out["collectives"]["counts"]["all-reduce"] > 0
    if fsdp:
        assert out["collectives"]["counts"]["all-gather"] > 0
    hw = lmesh.H100                   # the record rounds to 6 decimals
    roof = ha.Roofline(out["xla_cost"]["flops_per_dev"],
                       out["xla_cost"]["bytes_per_dev"],
                       out["collectives"]["loop_aware_gb"] * 1e9, 4,
                       hw.peak_flops, hw.hbm_bw, hw.ici_bw,
                       meta["model_flops"])
    assert all(np.isfinite(t) and t > 0 for t in
               (roof.compute_s, roof.memory_s, roof.collective_s))
    assert out["roofline"]["hlo_flops_global"] == pytest.approx(
        4 * out["xla_cost"]["flops_per_dev"], rel=1e-12)
    whole = _whole_rank_flops(configs.get_arch("qwen2.5-3b").smoke, shape,
                              2, 2)
    assert whole / 2 <= out["xla_cost"]["flops_per_dev"] <= whole


def _tiny_step(mb: int):
    """A one-matrix model's train step (SGD with momentum): the gather of
    ``w``'s rows at the tokens, squared, averaged."""
    import types
    model = types.SimpleNamespace(loss_fn=lambda p, b: (
        p["w"][b["tokens"]].float() ** 2).mean())
    opt = get_optimizer("sgdm", lr=0.1)
    w = torch.empty((32, 16), dtype=torch.float32, device="meta")
    return (make_train_step(model, opt, microbatches=mb),
            {"params": {"w": w}, "opt": opt.init({"w": w})})


@pytest.mark.parametrize("shape,names", [
    ((2, 2, 2), ("pod", "data", "model")), ((4, 2), ("data", "model"))])
def test_microbatches_of_a_batch_over_several_ranks(shape, names,
                                                    one_thread):
    """Regression: a train step's microbatch split (a view of the batch
    dim into microbatches x rows) of a batch that ``batch_shardings``
    lays over ``("pod", "data")`` or over more ``data`` ranks than
    microbatches.  DTensor's view came out with local shards of the wrong
    shape on the first (``shape '[1, 4, 4]' is invalid for input of size
    8``) and refused the second; ``common.split_shardable`` now gathers
    the mesh dims whose ranks, major first, do not divide the
    microbatches.  Then the step traces, 8 rows of 4 tokens in 2
    microbatches."""
    from repro_torch.distrib.sharding import batch_shardings
    from repro_torch.models.lm.common import split_shardable
    mesh = lmesh.make_fake_mesh(shape, names)
    try:
        x = dryrun.placed_on_meta(mesh, {"t": torch.empty(
            (8, 4), dtype=torch.int32, device="meta")},
            batch_shardings(mesh, {"t": (8, 4)}))["t"]
        y = split_shardable(x, 0, 2).reshape(2, 4, 4)
        assert tuple(y.to_local().shape) == dryrun.local_shape(
            mesh, y.shape, y.placements)
        step, state = _tiny_step(2)
        program = dryrun.partitioned_program(
            step, mesh, state, {"tokens": ((8, 4), torch.int32)}, True)
        tally = ha.Tally()
        tally.run(program.fn, *program.args)
    finally:
        lmesh.release_production_mesh()
    assert tally.collectives.count_by_kind["all-gather"] > 0


def test_tally_counts_a_dtensor_program_locally(one_thread):
    """On DTensors the counter lets DTensor dispatch first and counts the
    local operations and the collectives it issues: a ``[8, 6] @ [6, 4]``
    product with the rows over 2 ``data`` ranks and the contraction over
    2 ``model`` ranks is one local ``[4, 3] @ [3, 4]`` product and, to
    replicate it, one all-reduce over ``model`` and one all-gather over
    ``data``; the arguments are the local shards; the shape inference of
    DTensor's sharding propagation (global shapes, on fake tensors) is
    not counted."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = lmesh.make_fake_mesh((2, 2), ("data", "model"))
    try:
        a, b = dryrun.placed_on_meta(
            mesh, [torch.empty((8, 6), device="meta"),
                   torch.empty((6, 4), device="meta")],
            [(Shard(0), Shard(1)), (Replicate(), Shard(0))])
        tally = ha.Tally()
        tally.run(lambda a, b: (a @ b).full_tensor(), a, b)
    finally:
        lmesh.release_production_mesh()
    assert tally.flops == 2 * 4 * 3 * 4
    assert tally.argument_bytes == 4 * (4 * 3 + 3 * 4)
    assert tally.collectives.count_by_kind == {"all-reduce": 1,
                                               "all-gather": 1}
    assert tally.collectives.bytes_by_kind == {"all-reduce": 4 * 4 * 4,
                                               "all-gather": 4 * 4 * 4}


# ---------------------------------------------------------------------------
# block_flops against the analytic meta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,lo,hi", [
    ("attention", 0.95, 1.05), ("gla", 0.9, 1.1), ("xlstm", 0.9, 1.1),
    ("moe", 0.6, 1.4)])
def test_block_flops_within_the_reference_bands(family, lo, hi, one_thread):
    stack = tls.lm_layerstack(to_torch_config(JAX_TINY[family]), TINY_T)
    analytic, counted = tls.crosscheck_flops(stack, 1, batch=2,
                                             device="cpu")
    assert counted > 0
    assert lo <= analytic / counted <= hi, (analytic, counted)
    assert tls.block_flops(stack, 1, 2, "meta") == counted


def test_block_flops_head_exact(one_thread):
    stack = tls.lm_layerstack(to_torch_config(JAX_TINY["attention"]), TINY_T)
    analytic, counted = tls.crosscheck_flops(stack, stack.num_layers - 1,
                                             batch=2, device="cpu")
    assert analytic == pytest.approx(counted, rel=0.01)
    assert "block_flops" in tls.__doc__ and "no counterpart" not in tls.__doc__


# ---------------------------------------------------------------------------
# Meta routes
# ---------------------------------------------------------------------------


def test_initialisers_draw_nothing_on_meta():
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    t = truncated_normal_init(g, (7, 5), 1.0, torch.bfloat16, "meta")
    assert t.device.type == "meta" and t.shape == (7, 5) and \
        t.dtype == torch.bfloat16
    params = build_model(configs.get_arch("zamba2-7b").lm).init(g, "meta")
    assert all(x.device.type == "meta" for x in leaves(params))
    net = cnn.alexnet()
    cparams = net.init(g, "meta")
    real = net.init(torch.Generator().manual_seed(0), "cpu")
    assert [(x.shape, x.dtype) for x in leaves(cparams)] == \
        [(x.shape, x.dtype) for x in leaves(real)]
    assert all(x.device.type == "meta" for x in leaves(cparams))
    assert torch.equal(g.get_state(), state)


def test_kernel_wrappers_on_meta_count_no_launch():
    before = (fa.launches, gs.launches, iq.launches)
    m = torch.device("meta")
    q = torch.empty((8, 40, 64), dtype=torch.bfloat16, device=m)
    kv = torch.empty((2, 40, 64), dtype=torch.bfloat16, device=m)
    o, lse = fa.flash_attention_fwd(q, kv, kv, True, 0)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) == \
        ((8, 40, 64), torch.bfloat16, (8, 40), torch.float32)
    k = torch.empty((3, 16, 32), dtype=torch.bfloat16, device=m)
    v = torch.empty((3, 16, 48), dtype=torch.bfloat16, device=m)
    a = torch.empty((3, 16), dtype=torch.float32, device=m)
    y, S, n = gs.gla_scan_fwd(k, k, v, a, 8, True)
    assert (y.shape, y.dtype, S.shape, S.dtype, n.shape) == \
        ((3, 16, 48), torch.bfloat16, (3, 32, 48), torch.float32, (3, 32))
    x = torch.empty((6, 10), dtype=torch.float32, device=m)
    codes, scale = iq.quantize_int8(x, torch.empty_like(x))
    assert (codes.shape, codes.dtype, scale.shape, scale.dtype) == \
        ((6, 10), torch.int8, (6,), torch.float32)
    codes, scale = kops.quantize_int8(x)          # the tier's noise draw
    assert codes.device.type == "meta" and scale.shape == (6,)
    assert all(t.device.type == "meta" for t in (o, lse, y, S, n))
    assert (fa.launches, gs.launches, iq.launches) == before


def test_production_meshes_over_the_fake_backend():
    assert not dist.is_initialized()
    try:
        for multi, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16),
                                     ("pod", "data", "model"))):
            mesh = lmesh.make_production_mesh(multi_pod=multi)
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == names
            assert lmesh.mesh_chips(mesh) == int(np.prod(shape))
            assert dist.get_backend() == "fake"
        assert lmesh.mesh_chips(MESHES["multi"]) == 512
    finally:
        lmesh.release_production_mesh()
    assert not dist.is_initialized()


def test_production_mesh_refuses_a_real_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="real default process group"):
            lmesh.make_production_mesh(multi_pod=True)
        lmesh.release_production_mesh()           # not the fake group
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_cli_runs_and_releases_the_group(tmp_path, capsys, one_thread):
    out = tmp_path / "cells.json"
    rc = dryrun.main(["--arch", "whisper-base", "--shape",
                      "decode_32k,long_500k", "--mesh", "both",
                      "--out", str(out)])
    assert rc == 0 and not dist.is_initialized()
    cells = json.loads(out.read_text())
    assert [c["status"] for c in cells] == ["OK", "OK", "SKIP"]
    for c in cells[:2]:
        r = c["roofline"]
        assert c["memory"]["fits_80gb"] and r["dominant"] == "memory"
        assert all(np.isfinite(r[k]) and r[k] > 0
                   for k in ("compute_s", "memory_s"))
    rc = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "train_4k",
                      "--mesh", "single", "--hier"])
    assert rc == 0 and not dist.is_initialized()
    text = capsys.readouterr().out
    assert "[OK]  whisper-base x decode_32k x 2x16x16" in text
    assert "[SKIP] qwen2.5-3b x train_4k x 16x16 [hier]" in text


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 14 rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_phase14_rehearsed(cpu_card, monkeypatch, one_thread, tmp_path):
    """(a) one dry-run process on a cheap cell, (b) the flat step of a
    qwen2.5-3b smoke twin with flash (its plain version counted as a
    launch) traced on meta and run on the CPU in place of the card, (c)
    the cross-check of the three fleet stacks' block 1 at T=32 on meta
    (``block_flops`` counts the same there as on the CPU: above)."""
    import chip_smoke
    from repro_torch import optim, train
    from repro_torch.data.pipeline import make_lm_batch_fn
    from repro_torch.models.lm import fleet_configs
    from repro_torch.models.lm import model as lm_model
    monkeypatch.setattr(chip_smoke, "DRYRUN_CELLS", (
        ("--arch", "whisper-base", "--shape", "decode_32k", "--mesh",
         "both"),))
    procs = chip_smoke.start_dryruns(ROOT, tmp_path)
    try:
        # the stubbed card has no allocator to read
        monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 1)
        monkeypatch.setattr(chip_smoke, "DRYRUN_PEAK", (0.0, float("inf")))
        cfg = configs.get_arch("qwen2.5-3b").smoke.variant(use_flash=True)
        got = chip_smoke.dryrun_vs_card(
            torch, KERNELS, lm_model, optim, train, dryrun,
            make_lm_batch_fn, ShapeSpec("flat", 16, 2, "train"), cfg)
        assert got["launches"] == {"int8_quant": 0, "gla_scan": 0,
                                   "flash_attention": 2 * cfg.n_layers}
        assert got["traced"]["xla_cost"]["flops_per_dev"] == \
            got["card"]["xla_cost"]["flops_per_dev"]
        assert got["traced"]["memory"]["peak_gb"] == pytest.approx(
            got["card"]["memory"]["peak_gb"], rel=0.25)
        monkeypatch.setattr(chip_smoke, "LM_T", 32)
        cross = chip_smoke.crosscheck_fleets(
            torch, tls.lm_layerstack, tls.crosscheck_flops, fleet_configs,
            "meta")
        assert sorted(cross) == ["fleet-gla", "fleet-moe", "fleet-xlstm"]
        cells = chip_smoke.finish_dryruns(procs, tmp_path)
    finally:
        for _, p in procs:
            p.kill()
    assert [c["status"] for c in cells] == ["OK", "OK"]
