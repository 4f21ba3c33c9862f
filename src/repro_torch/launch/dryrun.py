"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta
device and count what one device's program does.

The port of :mod:`repro.launch.dryrun`.  The reference lowers and
compiles each cell on 512 placeholder host devices and reads XLA's
``memory_analysis()``, ``cost_analysis()`` and its post-SPMD HLO.  The
port has no compiled module, so it runs the cell's step once on
``torch.device("meta")`` (shapes only: no number is drawn or computed)
under :class:`repro_torch.launch.hlo_analysis.Tally`, with the
production mesh a ``DeviceMesh`` over the ``fake`` backend (this process
rank 0 of 256 or 512).  For each cell it records:

* the reference's decisions by the reference's rules: sequence
  parallelism, ``fsdp_needed``, the microbatch count and, for
  ``--hier`` train cells, ``choose_tiers`` against the H100 constants
  (:data:`repro_torch.launch.mesh.H100`);
* ``partitioned``: whether the traced program is the partitioned one;
* ``memory``: the argument, output, temp and peak bytes of the traced
  device (live storages, :class:`Tally`), whether that peak fits the
  card, and ``sharded_state_gb``: each param and optimizer-state leaf's
  local shard under ``param_shardings`` / ``opt_state_shardings``;
* ``xla_cost`` (the reference's key): the traced FLOPs and bytes;
* ``collectives``: operand bytes and counts by kind;
* ``roofline``: :class:`Roofline` with the H100's peak, HBM and NVLink
  rates, ``chips`` the devices that run the program.

A train cell traces the partitioned program, the counterpart of the
reference's ``jit(step, in_shardings=..., out_shardings=...)``:
:func:`repro_torch.distrib.partition.partitioned_step` over
``make_train_step``, its state and batch DTensors over the whole mesh,
each made from this device's local shard on meta
(:func:`placed_on_meta`: nothing is cut or copied).  DTensor's dispatch
runs each operation on the local shards with the tensor-parallel and
FSDP collectives its sharding propagation chooses, and the
:class:`Tally` counts those local operations and collectives: so
``chips`` is the mesh's devices, ``memory.argument_gb`` is the local
state (``sharded_state_gb``) plus the local batch, and ``collectives``
are the TP / FSDP ones.  The mesh is a CPU ``DeviceMesh``: where DTensor
would send an all-to-all it gathers and slices (its CPU route), which
hands the transport the same operand bytes under another kind.

Two kinds of cell are not partitioned (``partitioned: false``):

* ``--hier`` train cells trace ``make_train_step(hier_sync=True)``: one
  pod rank holding whole weights on its pod's block of the batch, its
  tiered sync the real ``torch.distributed`` calls on the fake mesh's
  ``pod`` group (TP / FSDP inside a pod is not ported yet);
* prefill and decode cells trace one data-parallel rank holding whole
  weights on its block of the batch (the port has no partitioned
  serving yet); ``chips`` are the data-parallel ranks.

A train cell's microbatch loop is traced through
:func:`repro_torch.launch.hlo_analysis.trip_range` (first microbatch
once, the second for the other ``k - 1``), which is exact: the
microbatches have one shape.  The three CUDA kernels are opaque to the
counter on the card, as a Pallas call is to the reference's dot count;
on meta and on the CPU their wrappers run the plain versions, which are
counted.

Usage::

    python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
    python -m repro_torch.launch.dryrun --mesh both --out dryrun.json
    python -m repro_torch.launch.dryrun --hier --arch grok-1-314b \\
        --mesh multi                   # tiered sync over the pod axis
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import ARCHS, SHAPES, get_arch, input_specs
from repro_torch.configs.base import ShapeSpec
from repro_torch.distrib import (batch_shardings, choose_tiers, compat,
                                 opt_state_shardings, param_shardings)
from repro_torch.distrib.partition import partitioned_step
from repro_torch.distrib.sharding import axis_names, axis_size, fsdp_needed
from repro_torch.distrib.tiered_sync import TierAssignment
from repro_torch.launch.hlo_analysis import Roofline, Tally
from repro_torch.launch.mesh import (H100, Hardware, make_production_mesh,
                                     mesh_chips, release_production_mesh)
from repro_torch.models.lm.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, tree_map

META = torch.device("meta")


def _tokens_per_step(cfg, shape) -> float:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch * 1.0            # decode: one token


def _model_flops(cfg, shape, n_params_active: int) -> float:
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    return mult * n_params_active * _tokens_per_step(cfg, shape)


def _active_params(cfg, param_shapes) -> int:
    total = sum(int(np.prod(s.shape)) for s in leaves(param_shapes))
    if cfg.family == "moe" and cfg.moe is not None:
        expert = 0
        moe_leaves = param_shapes["layers"]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            expert += int(np.prod(moe_leaves[name].shape))
        total = total - expert + int(expert * cfg.moe.top_k
                                     / cfg.moe.n_experts)
    return total


def local_shape(mesh, shape, placements) -> Tuple[int, ...]:
    """One rank's shard of a tensor of ``shape`` under DTensor
    ``placements`` over ``mesh`` (the rules shard only even splits)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] //= int(mesh.size(i))
    return tuple(out)


def sharded_bytes(mesh, shapes, shardings) -> int:
    """Bytes of each leaf's local shard, summed (the reference's
    ``NamedSharding(mesh, spec).shard_shape`` x itemsize)."""
    return sum(int(np.prod(local_shape(mesh, t.shape, pl))) * t.element_size()
               for t, pl in zip(leaves(shapes), leaves(shardings)))


@dataclasses.dataclass
class Program:
    """One rank's step and its arguments (the reference's ``Lowered``):
    ``fn(*args)`` under the mesh."""
    fn: Callable
    args: Tuple[Any, ...]
    mesh: Any = None


def measure(program: Program, *, model_flops: float, ranks: int = 1,
            hw: Hardware = H100, trips: bool = True) -> Dict[str, Any]:
    """Runs ``program`` once under a :class:`Tally` on whatever device its
    arguments are (meta for the dry run) and returns ``trace_s``,
    ``memory``, ``xla_cost``, ``collectives`` and ``roofline`` (``ranks``
    run it, ``model_flops`` is the whole step's)."""
    tally = Tally(trips=trips)
    t0 = time.perf_counter()
    with compat.set_mesh(program.mesh):
        out = tally.run(program.fn, *program.args)
    del out
    trace_s = time.perf_counter() - t0
    peak = tally.peak
    roof = Roofline(
        flops_per_device=tally.flops, bytes_per_device=tally.bytes,
        collective_bytes_per_device=tally.collective_bytes, chips=ranks,
        peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, link_bw=hw.ici_bw,
        model_flops=model_flops)
    stats = tally.collectives
    return {
        "trace_s": round(trace_s, 1), "ops": tally.ops,
        "memory": {
            "argument_gb": tally.argument_bytes / 1e9,
            "output_gb": tally.output_bytes / 1e9,
            "temp_gb": max(peak - tally.argument_bytes
                           - tally.output_bytes, 0) / 1e9,
            "peak_gb": peak / 1e9,
            "fits_80gb": peak < hw.hbm_bytes},
        "xla_cost": {"flops_per_dev": float(tally.flops),
                     "bytes_per_dev": float(tally.bytes)},
        "collectives": {"by_kind_gb": {k: v / 1e9 for k, v in
                                       stats.bytes_by_kind.items()},
                        "counts": stats.count_by_kind,
                        "static_total_gb": tally.coll_static / 1e9,
                        "loop_aware_gb": tally.collective_bytes / 1e9},
        "roofline": {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in roof.row().items()},
    }


def placed_on_meta(mesh, shapes, shardings):
    """Each leaf of ``shapes`` (global shapes on meta) as a DTensor over
    ``mesh`` with the matching leaf of ``shardings``: this rank's local
    shard, on meta, made as such (``DTensor.from_local``), so that nothing
    is cut, copied or sent: the state and batch that the reference's
    ``in_shardings`` hand its program."""
    from torch.distributed.tensor import DTensor

    def one(t, pl):
        local = torch.empty(local_shape(mesh, t.shape, pl), dtype=t.dtype,
                            device=META)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return tree_map(one, shapes, shardings)


def partitioned_program(step: Callable, mesh, state_shapes,
                        specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                        fsdp: bool) -> Program:
    """``step(state, batch, 0)`` through ``partitioned_step`` over
    ``mesh``: the state (global shapes on meta) laid out by
    ``param_shardings`` / ``opt_state_shardings`` and the global batch of
    ``specs`` by ``batch_shardings``, each as this device's local shards
    (:func:`placed_on_meta`)."""
    shard = {"params": param_shardings(mesh, state_shapes["params"],
                                       fsdp=fsdp),
             "opt": opt_state_shardings(mesh, state_shapes["opt"],
                                        fsdp=fsdp)}
    batch = {k: torch.empty(s, dtype=dtype, device=META)
             for k, (s, dtype) in specs.items()}
    bshard = batch_shardings(mesh, batch)
    return Program(partitioned_step(step, mesh, shard, bshard), (
        placed_on_meta(mesh, state_shapes, shard),
        placed_on_meta(mesh, batch, bshard), 0), mesh)


def _meta_batch(mesh, specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                pods: int = 1) -> Dict[str, torch.Tensor]:
    """One rank's block of the batch whose ``(shape, dtype)`` are
    ``specs``, on meta; ``pods`` blocks of it for the hier step, which
    takes its own pod's block."""
    shard = batch_shardings(mesh, {k: s for k, (s, _) in specs.items()})
    out = {}
    for k, (s, dtype) in specs.items():
        loc = local_shape(mesh, s, shard[k])
        out[k] = torch.empty((loc[0] * pods,) + loc[1:], dtype=dtype,
                             device=META)
    return out


def _no_grad(fn: Callable) -> Callable:
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run


def lower_cell(arch_id: str, shape_name: Union[str, ShapeSpec], mesh, *,
               hier: bool = False, use_flash: Optional[bool] = None,
               microbatches: Optional[int] = None,
               remat_policy: Optional[str] = None,
               fsdp: Optional[bool] = None, smoke: bool = False,
               tiers: Optional[TierAssignment] = None
               ) -> Tuple[Program, Dict[str, Any]]:
    """Builds one cell on meta.  Returns ``(program, meta)``; trace it
    with :func:`analyse`.  ``shape_name`` is a ``SHAPES`` key or a
    ``ShapeSpec``; ``smoke`` takes the arch's smoke config; ``tiers``
    replaces the hier cell's ``choose_tiers``."""
    spec = get_arch(arch_id)
    shape = shape_name if isinstance(shape_name, ShapeSpec) \
        else SHAPES[shape_name]
    cfg = spec.smoke if smoke else spec.lm
    if use_flash is not None:
        cfg = cfg.variant(use_flash=use_flash)
    if remat_policy is not None:
        cfg = cfg.variant(remat_policy=remat_policy)
    names = axis_names(mesh)
    # the reference's rules (its dryrun.py:86-117)
    mb = microbatches if microbatches is not None else spec.microbatches
    if shape.kind == "prefill":
        cfg = cfg.variant(seq_parallel=True)
    elif shape.kind == "train":
        dp = int(np.prod([axis_size(mesh, a) for a in ("pod", "data")
                          if a in names]))
        stack_gb = (cfg.n_layers * (shape.global_batch / dp / mb)
                    * shape.seq_len * cfg.d_model * 6) / 1e9
        if stack_gb > 4.0:
            cfg = cfg.variant(seq_parallel=True)
    model = build_model(cfg)
    param_shapes = model.init(torch.Generator(), META)
    total_params = sum(t.numel() for t in leaves(param_shapes))
    if fsdp is None:
        opt_bpp = 4 if spec.optimizer == "sgdm" else 8
        fsdp = (shape.kind == "train" and
                fsdp_needed(mesh, total_params, opt_bpp))
    pshard = param_shardings(mesh, param_shapes, fsdp=fsdp)
    active = _active_params(cfg, param_shapes)
    ranks = int(np.prod([axis_size(mesh, a) for a in ("pod", "data")
                         if a in names]))
    meta: Dict[str, Any] = {
        "arch": arch_id, "shape": shape.name, "kind": shape.kind,
        "mesh": {n: axis_size(mesh, n) for n in names}, "hier": hier,
        "fsdp": fsdp, "seq_parallel": cfg.seq_parallel, "microbatches": mb,
        "active_params": active, "total_params": total_params,
        "ranks": ranks, "model_flops": _model_flops(cfg, shape, active),
        "partitioned": False,
    }
    specs = input_specs(cfg, shape)

    if shape.kind == "train":
        opt = get_optimizer(spec.optimizer)
        opt_shapes = opt.init(param_shapes)
        meta["sharded_state_bytes"] = (
            sharded_bytes(mesh, param_shapes, pshard)
            + sharded_bytes(mesh, opt_shapes, opt_state_shardings(
                mesh, opt_shapes, fsdp=fsdp)))
        pods = 1
        if hier:
            if "pod" not in names:
                raise ValueError(f"hier_sync needs a mesh with a 'pod' "
                                 f"axis; got {names}")
            pods = axis_size(mesh, "pod")
            if tiers is None:
                est_compute = (meta["model_flops"]
                               / (mesh_chips(mesh) * H100.peak_flops * 0.4))
                tiers = choose_tiers(param_shapes, n_pods=pods,
                                     dcn_bytes_per_s=H100.dcn_bw,
                                     compute_seconds=est_compute)
            meta["tiers"] = tiers.describe()
        step = make_train_step(model, opt, microbatches=mb,
                               hier_sync=hier, tiers=tiers)
        state = {"params": param_shapes, "opt": opt_shapes}
        if hier:
            return Program(step, (state, _meta_batch(mesh, specs, pods), 0),
                           mesh), meta
        meta.update(partitioned=True, ranks=mesh_chips(mesh))
        return partitioned_program(step, mesh, state, specs, fsdp), meta

    meta["sharded_state_bytes"] = sharded_bytes(mesh, param_shapes, pshard)
    if shape.kind == "prefill":
        step = make_prefill_step(model, max_len=shape.seq_len)
        return Program(_no_grad(step), (param_shapes,
                                        _meta_batch(mesh, specs)),
                       mesh), meta

    # decode: one new token against a seq_len cache
    S = shape.seq_len
    tok = _meta_batch(mesh, {"t": ((shape.global_batch, 1),
                                   torch.int32)})["t"]
    kw = {"enc_len": S} if cfg.family == "encdec" else {}
    cache = model.init_cache(tok.shape[0], S, device=META, **kw)
    step = make_decode_step(model)
    return Program(_no_grad(step), (param_shapes, tok, cache, S - 1),
                   mesh), meta


def analyse(program: Program, meta: Dict[str, Any], hw: Hardware = H100
            ) -> Dict[str, Any]:
    """Traces ``program`` and fills ``meta`` with ``trace_s``, ``memory``
    (with ``sharded_state_gb``), ``xla_cost``, ``collectives`` and
    ``roofline``."""
    meta.update(measure(program, model_flops=meta["model_flops"],
                        ranks=meta["ranks"], hw=hw))
    meta["memory"]["sharded_state_gb"] = meta["sharded_state_bytes"] / 1e9
    return meta


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, *,
             hier: bool = False, **kw) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod)
    program, meta = lower_cell(arch_id, shape_name, mesh, hier=hier, **kw)
    return analyse(program, meta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--hier", action="store_true",
                    help="use HierTrain tiered gradient sync (train cells "
                         "of the multi-pod mesh)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--use-flash", action="store_true", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []
    failures = 0
    try:
        for arch_id in archs:
            spec = get_arch(arch_id)
            shapes = (list(spec.shapes) + sorted(spec.skips)
                      if args.shape == "all" else args.shape.split(","))
            for shape_name in shapes:
                if shape_name in spec.skips:
                    results.append({"arch": arch_id, "shape": shape_name,
                                    "status": "SKIP",
                                    "reason": spec.skips[shape_name]})
                    print(f"[SKIP] {arch_id} x {shape_name}", flush=True)
                    continue
                for multi in meshes:
                    tag = f"{arch_id} x {shape_name} x " \
                          f"{'2x16x16' if multi else '16x16'}" \
                          + (" [hier]" if args.hier else "")
                    if args.hier and not multi and \
                            SHAPES[shape_name].kind == "train":
                        reason = "hier_sync needs the pod axis"
                        results.append({"arch": arch_id,
                                        "shape": shape_name,
                                        "multi_pod": multi, "hier": True,
                                        "status": "SKIP", "reason": reason})
                        print(f"[SKIP] {tag}: {reason}", flush=True)
                        continue
                    try:
                        t0 = time.perf_counter()
                        meta = run_cell(arch_id, shape_name, multi,
                                        hier=args.hier,
                                        use_flash=args.use_flash,
                                        microbatches=args.microbatches)
                        meta["status"] = "OK"
                        dt = time.perf_counter() - t0
                        meta["wall_s"] = round(dt, 1)
                        r = meta["roofline"]
                        unit = "dev" if meta["partitioned"] else "rank"
                        print(f"[OK]  {tag}: trace={meta['trace_s']}s "
                              f"peak={meta['memory']['peak_gb']:.2f}GB/"
                              f"{unit} "
                              f"sharded={meta['memory']['sharded_state_gb']:.2f}"
                              f"GB/dev dominant={r['dominant']} "
                              f"terms(c/m/n)={r['compute_s']:.4f}/"
                              f"{r['memory_s']:.4f}/{r['collective_s']:.4f}s "
                              f"useful={r['useful_ratio']:.2f} "
                              f"({dt:.0f}s)", flush=True)
                        results.append(meta)
                    except Exception as e:
                        failures += 1
                        print(f"[FAIL] {tag}: {type(e).__name__}: {e}",
                              flush=True)
                        traceback.print_exc()
                        results.append({"arch": arch_id,
                                        "shape": shape_name,
                                        "multi_pod": multi, "status": "FAIL",
                                        "error": f"{type(e).__name__}: {e}"})
    finally:
        release_production_mesh()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out} ({len(results)} cells)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
