"""The JAX twin of tests/test_torch_launch.py's exact dry-run fields, on
the production meshes of 512 placeholder host devices.

    python -m tests.jax_launch_twin INPUTS OUT

INPUTS is a JSON file: ``{"peak_flops": ..., "dcn_bw": ...}``, the
port's H100 figures that the hier cells' ``choose_tiers`` is fed.  For
every arch, every cell of its ``shapes`` and both production meshes it
writes to OUT (JSON) what the reference's ``lower_cell``
(src/repro/launch/dryrun.py:74-150) decides before it lowers: the total
and active params, the model FLOPs, ``fsdp``, ``seq_parallel``, the
microbatch count, the per-device bytes of the sharded state (params,
and the optimizer state of train cells: each leaf's
``NamedSharding(mesh, spec).shard_shape`` times its itemsize) and, for
the multi-pod train cells, ``choose_tiers(...).describe()``.  It lowers
nothing, and it does not import ``repro.launch.dryrun`` (that module
sets ``XLA_FLAGS`` at import): the rules of its :74-117 are copied
below with their line numbers.
"""
from __future__ import annotations

import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=512")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro.distrib import (choose_tiers, opt_state_shardings,  # noqa: E402
                           param_shardings)
from repro.distrib.sharding import fsdp_needed  # noqa: E402
from repro.models.lm.model import build_model  # noqa: E402
from repro.optim import get_optimizer  # noqa: E402


# src/repro/launch/dryrun.py:49-71
def _tokens_per_step(cfg, shape) -> float:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch * 1.0


def _model_flops(cfg, shape, n_params_active: int) -> float:
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.kind]
    return mult * n_params_active * _tokens_per_step(cfg, shape)


def _active_params(cfg, param_shapes) -> int:
    total = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(param_shapes))
    if cfg.family == "moe" and cfg.moe is not None:
        expert = 0
        moe_leaves = param_shapes["layers"]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            expert += int(np.prod(moe_leaves[name].shape))
        total = total - expert + int(expert * cfg.moe.top_k
                                     / cfg.moe.n_experts)
    return total


def _sharded_bytes(shapes, shardings) -> int:
    return sum(int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
               for s, sh in zip(jax.tree.leaves(shapes),
                                jax.tree.leaves(shardings, is_leaf=lambda x:
                                                isinstance(x, NamedSharding))))


def cell(arch_id, shape_name, mesh, multi, hw):
    spec = get_arch(arch_id)
    shape = SHAPES[shape_name]
    cfg = spec.lm
    # src/repro/launch/dryrun.py:89-99
    mb = spec.microbatches
    if shape.kind == "prefill":
        cfg = cfg.variant(seq_parallel=True)
    elif shape.kind == "train":
        dp = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                          if a in mesh.axis_names]))
        stack_gb = (cfg.n_layers * (shape.global_batch / dp / mb)
                    * shape.seq_len * cfg.d_model * 6) / 1e9
        if stack_gb > 4.0:
            cfg = cfg.variant(seq_parallel=True)
    model = build_model(cfg)
    param_shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    total_params = sum(int(np.prod(s.shape))
                       for s in jax.tree.leaves(param_shapes))
    # :110-117
    opt_bpp = 4 if spec.optimizer == "sgdm" else 8
    fsdp = (shape.kind == "train" and
            fsdp_needed(mesh, total_params, opt_bpp))
    active = _active_params(cfg, param_shapes)
    out = {"total_params": total_params, "active_params": active,
           "model_flops": _model_flops(cfg, shape, active), "fsdp": fsdp,
           "seq_parallel": cfg.seq_parallel, "microbatches": mb}
    state = _sharded_bytes(param_shapes,
                           param_shardings(mesh, param_shapes, fsdp=fsdp))
    if shape.kind == "train":
        opt = get_optimizer(spec.optimizer)
        opt_shapes = jax.eval_shape(opt.init, param_shapes)
        state += _sharded_bytes(opt_shapes, opt_state_shardings(
            mesh, opt_shapes, fsdp=fsdp))
        if multi:
            # :128-136, with the port's H100 figures
            chips = int(np.prod(list(mesh.shape.values())))
            est = out["model_flops"] / (chips * hw["peak_flops"] * 0.4)
            out["tiers"] = choose_tiers(
                param_shapes, n_pods=mesh.shape["pod"],
                dcn_bytes_per_s=hw["dcn_bw"],
                compute_seconds=est).describe()
    out["sharded_state_bytes"] = state
    return out


def main(argv) -> int:
    inputs, path = argv
    with open(inputs) as f:
        hw = json.load(f)
    devices = jax.devices()
    meshes = {
        "single": jax.make_mesh((16, 16), ("data", "model"),
                                devices=devices[:256]),
        "multi": jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                               devices=devices)}
    out = {}
    for arch_id in sorted(ARCHS):
        for shape_name in get_arch(arch_id).shapes:
            for name, mesh in meshes.items():
                out[f"{arch_id}|{shape_name}|{name}"] = cell(
                    arch_id, shape_name, mesh, name == "multi", hw)
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
