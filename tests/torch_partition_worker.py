"""One rank of the partitioned-step checks (tests/test_torch_partition.py).

    python -m tests.torch_partition_worker RANK WORLD STORE INPUTS OUT

Joins a gloo group of WORLD processes through the FileStore at STORE,
reads the pickled numpy INPUTS, builds the ``(data, model)`` meshes the
cases name, and pickles to OUT what this rank computed: per case the
losses of ``repro_torch.distrib.partition.partitioned_step`` over
``make_train_step``, whether every leaf kept its placements after each
step, the local state bytes beside ``launch.dryrun.sharded_bytes``, and
the full params; the shapes the flash launcher was given; the flash
route on DTensors with a stub launcher under ``CommDebugMode``; and the
placements the model's hints give.  It imports torch and the port only.
"""
from __future__ import annotations

import os
import pickle
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.debug import CommDebugMode

from repro_torch import configs
from repro_torch.convert import model_params_from_numpy
from repro_torch.distrib import compat
from repro_torch.distrib.partition import (distribute_tree,
                                           partitioned_step, place)
from repro_torch.distrib.sharding import (batch_shardings,
                                          opt_state_shardings,
                                          param_shardings)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.launch.dryrun import sharded_bytes
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import common
from repro_torch.models.lm.model import _resid_hint, build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, tree_map


def case_config(case: dict):
    """The port's config of a case (shared with the test's JAX twin)."""
    return configs.get_arch(case["arch"]).smoke.variant(
        use_flash=case["use_flash"], **case.get("variant", {}))


def case_batches(case: dict, inputs: dict) -> list:
    """A case's batches: the first ``case["batch"]`` rows of its model's."""
    return [{k: torch.from_numpy(v[:case["batch"]]) for k, v in b.items()}
            for b in inputs["batches"][case["model"]]]


def numpy_tree(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def full_tree(tree):
    return tree_map(lambda t: t.full_tensor(), tree)


def names(placements) -> list:
    return [str(p) for p in placements]


class LauncherLog:
    """Wraps the flash launcher: refuses a DTensor (as the launcher does)
    and records the shapes it is given."""

    def __init__(self):
        self.shapes, self.orig = [], fa.flash_attention_fwd

    def __call__(self, q, k, v, causal, window=0):
        for t in (q, k, v):
            assert type(t) is torch.Tensor, type(t)
        self.shapes.append((tuple(q.shape), tuple(k.shape)))
        return self.orig(q, k, v, causal, window)


def run_case(case, inputs, mesh, log):
    cfg = case_config(case)
    model = build_model(cfg)
    opt = get_optimizer("adamw", **inputs["opt_kw"])
    p0 = model_params_from_numpy(inputs["params"][case["model"]])
    state0 = {"params": p0, "opt": opt.init(p0)}
    shard = {"params": param_shardings(mesh, p0, case["fsdp"]),
             "opt": opt_state_shardings(mesh, state0["opt"], case["fsdp"])}
    batches = case_batches(case, inputs)
    step = partitioned_step(
        make_train_step(model, opt, microbatches=case["mb"]), mesh, shard,
        batch_shardings(mesh, batches[0]))
    state = distribute_tree(state0, mesh, shard)
    out = {"losses": [], "kept": [], "local_bytes": [], "metric_types": []}
    want = sharded_bytes(mesh, state0, shard)
    del log.shapes[:]
    for i, b in enumerate(batches):
        state, met = step(state, b, i)
        out["losses"].append(float(met["loss"]))
        out["metric_types"].append(sorted({type(v).__name__
                                           for v in met.values()}))
        out["kept"].append(all(
            x.placements == tuple(p) for x, p in
            zip(leaves(state), leaves(shard))))
        out["local_bytes"].append(sum(
            x.to_local().numel() * x.element_size() for x in leaves(state)))
    out["sharded_bytes"] = want
    out["grad_norm"] = float(met["grad_norm"])
    out["params"] = numpy_tree(full_tree(state["params"]))
    out["launcher_shapes"] = list(log.shapes)
    return out


def raw_step_keeps_placements(inputs, mesh) -> bool:
    """``make_train_step`` alone (no re-layout after it) under the mesh
    and implicit replication returns the placements it was given (on
    the first case's model at 2 microbatches)."""
    from torch.distributed.tensor.experimental import implicit_replication
    case = dict(inputs["cases"][0], batch=2 * inputs["cases"][0]["batch"])
    model = build_model(case_config(case))
    opt = get_optimizer("adamw", **inputs["opt_kw"])
    p0 = model_params_from_numpy(inputs["params"][case["model"]])
    state0 = {"params": p0, "opt": opt.init(p0)}
    shard = {"params": param_shardings(mesh, p0, True),
             "opt": opt_state_shardings(mesh, state0["opt"], True)}
    batch = case_batches(case, inputs)[0]
    state = distribute_tree(state0, mesh, shard)
    step = make_train_step(model, opt, microbatches=2)
    with compat.set_mesh(mesh), implicit_replication():
        new, _ = step(state, distribute_tree(
            batch, mesh, batch_shardings(mesh, batch)), 0)
    return all(x.placements == y.placements
               for x, y in zip(leaves(new), leaves(state)))


def flash_route(inputs, meshes) -> list:
    """Each layout of ``inputs["route"]``: q, k, v hinted as the model
    hints them, through ``kops.flash_attention`` with a stub launcher,
    forward then backward under ``CommDebugMode``."""
    seen = []

    def stub(q, k, v, causal, window=0):
        for t in (q, k, v):
            assert type(t) is torch.Tensor and t.is_contiguous(), type(t)
        seen.append((tuple(q.shape), tuple(k.shape)))
        from repro_torch.kernels.ref import ref_flash_attention
        return ref_flash_attention(q, k, v, causal=causal, window=window)

    out = []
    fa.flash_attention_fwd, orig = stub, fa.flash_attention_fwd
    try:
        for r in inputs["route"]:
            mesh = meshes[r["mesh"]]
            full = [torch.from_numpy(r[n]) for n in ("q", "k", "v")]
            dts = [place(t, mesh, [Replicate()] * 2) for t in full]
            with compat.set_mesh(mesh):
                q, k, v = attn._qkv_hints(*dts)
                q, k, v = (t.detach().requires_grad_(True)
                           for t in (q, k, v))
                del seen[:]
                with CommDebugMode() as fwd:
                    o = kops.flash_attention(q, k, v, causal=True)
                do = place(torch.from_numpy(r["do"]), mesh, o.placements)
                with CommDebugMode() as bwd:
                    o.backward(do)
            out.append({
                "name": r["name"], "seen": list(seen),
                "fwd_comms": fwd.get_total_counts(),
                "bwd_comms": bwd.get_total_counts(),
                "o_layout": names(o.placements),
                "q_layout": names(q.placements),
                "o": o.full_tensor().detach().numpy(),
                "grads": [t.grad.full_tensor().numpy()
                          for t in (q, k, v)]})
    finally:
        fa.flash_attention_fwd = orig
    return out


def hints(inputs, meshes) -> list:
    """The placements the model's hints give on each mesh, beside the
    identity with no mesh in scope."""
    out = []
    for h in inputs["hints"]:
        mesh = meshes[h["mesh"]]
        xs = [place(torch.zeros(s), mesh, [Replicate()] * 2)
              for s in h["shapes"]]
        if h["kind"] == "qkv":
            got = attn._qkv_hints(*xs)
            same = all(a is b for a, b in zip(got, xs))
            with compat.set_mesh(mesh):
                got = attn._qkv_hints(*xs)
        else:
            if h["kind"] == "resid":
                cfg = configs.get_arch("qwen2.5-3b").smoke.variant(
                    seq_parallel=h["seq_parallel"])
                fn = lambda x: _resid_hint(cfg, x)     # noqa: E731
            else:
                fn = lambda x: common.shard_hint(      # noqa: E731
                    x, ("pod", "data"), None, "model")
            same = fn(xs[0]) is xs[0]
            with compat.set_mesh(mesh):
                got = [fn(xs[0])]
        out.append({"name": h["name"], "identity_without_mesh": same,
                    "placements": [names(t.placements) for t in got]})
    return out


def logits_hint_in_loss(inputs, mesh) -> list:
    """The placements of the logits chunk inside ``chunked_softmax_xent``
    (the hint's output there, recorded)."""
    from torch.distributed.tensor.experimental import implicit_replication
    case = inputs["cases"][0]
    cfg = case_config(case)
    p0 = model_params_from_numpy(inputs["params"][case["model"]])
    batch = case_batches(case, inputs)[0]
    params = distribute_tree(p0, mesh, param_shardings(mesh, p0))
    batch = distribute_tree(batch, mesh, batch_shardings(mesh, batch))
    hidden = place(torch.zeros(tuple(batch["tokens"].shape)
                               + (cfg.d_model,)), mesh,
                   batch["tokens"].placements)
    got = []
    orig = common.shard_hint

    def spy(x, *axes):
        y = orig(x, *axes)
        got.append(names(y.placements))
        return y

    common.shard_hint = spy
    try:
        with compat.set_mesh(mesh), implicit_replication():
            common.chunked_softmax_xent(hidden, params["lm_head"],
                                        batch["targets"])
    finally:
        common.shard_hint = orig
    return got


def launcher_refuses(mesh) -> str:
    """The flash launcher given a DTensor: its error."""
    q = place(torch.zeros(4, 8, 16), mesh, [Replicate()] * 2)
    try:
        fa.flash_attention_fwd(q, q, q, True)
    except TypeError as e:
        return str(e)
    return "no error"


def wait_for(path: str, timeout: float = 300.0) -> None:
    """Waits for ``path``: the test starts this process before it writes
    the inputs, so that the imports overlap its own work."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)


def run(rank: int, world: int, store: str, inputs: dict) -> dict:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {"cases": {}}
    log = LauncherLog()
    fa.flash_attention_fwd = log
    try:
        meshes = {tuple(s): init_device_mesh("cpu", tuple(s),
                                             mesh_dim_names=("data",
                                                             "model"))
                  for s in inputs["meshes"]}
        for case in inputs["cases"]:
            out["cases"][case["name"]] = run_case(
                case, inputs, meshes[tuple(case["mesh"])], log)
        fa.flash_attention_fwd = log.orig
        out["raw_step_keeps_placements"] = {
            str(s): raw_step_keeps_placements(inputs, m)
            for s, m in meshes.items()}
        out["route"] = flash_route(inputs, meshes)
        out["launcher_refuses"] = launcher_refuses(meshes[(1, 4)])
        out["hints"] = hints(inputs, meshes)
        out["logits_hint"] = {str(s): logits_hint_in_loss(inputs, m)
                              for s, m in meshes.items()}
        dist.barrier()
    finally:
        fa.flash_attention_fwd = log.orig
        dist.destroy_process_group()
    return out


def main(argv) -> int:
    rank, world, store, inputs, path = argv
    wait_for(inputs)
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    out = run(int(rank), int(world), store, data)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
