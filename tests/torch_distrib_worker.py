"""One rank of the port's multi-process checks (tests/test_torch_distrib.py).

    python -m tests.torch_distrib_worker RANK WORLD STORE INPUTS OUT

Joins a gloo group of WORLD processes through the FileStore at STORE,
reads the pickled numpy INPUTS, and pickles to OUT what this rank
computed: the tiered gradient sync (full width and all-int8), the hier
train step (both tier settings), the tree step with its cloud tail over a
``("data",)`` mesh and over a ``(pod, data, model)`` mesh, the
divisibility guard, and ``shard_hint`` on a DTensor.  It imports torch
and the port only.
"""
from __future__ import annotations

import pickle
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch import configs
from repro_torch.convert import model_params_from_numpy, params_from_numpy
from repro_torch.convert import model_params_to_numpy, params_to_numpy
from repro_torch.core.cost_model import MultiSchedule
from repro_torch.core.hybrid_step import tree_hybrid_step_from_schedule
from repro_torch.distrib import compat
from repro_torch.distrib.tiered_sync import (choose_tiers, sync_seed,
                                             tiered_grad_sync)
from repro_torch.models.cnn import DenseSpec, LayeredModel
from repro_torch.models.lm.common import shard_hint
from repro_torch.models.lm.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.step import make_train_step


def tiny_mlp() -> LayeredModel:
    """The tiny MLP of tests/test_distrib.py's cloud-tier test."""
    specs = tuple(DenseSpec(f"fc{i}", 16) for i in range(4)) + \
        (DenseSpec("out", 5, relu=False),)
    return LayeredModel("tiny_mlp", specs, (8,), 5)


def numpy_tree(tree):
    return {k: numpy_tree(v) if isinstance(v, dict) else
            v.detach().numpy().copy() for k, v in tree.items()}


def dense_only(fn):
    """``fn`` refusing strided tensors, as NCCL does (gloo takes them)."""
    def call(t, *args, **kw):
        for x in (t if isinstance(t, list) else [t]) + \
                [a for a in args if isinstance(a, torch.Tensor)]:
            assert x.is_contiguous(), f"{fn.__name__} of a strided tensor"
        return fn(t, *args, **kw)
    return call


def run(rank: int, world: int, store: str, inputs: dict) -> dict:
    torch.set_num_threads(1)
    dist.all_reduce = dense_only(dist.all_reduce)
    dist.all_gather = dense_only(dist.all_gather)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    out = {}
    try:
        pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        data = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        pdm = init_device_mesh("cpu", (world, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))

        # tiered sync: this pod's contiguous half of each gradient
        n = inputs["grads"]["big"].shape[0] // world
        grads = {k: torch.from_numpy(v[rank * n:(rank + 1) * n].copy())
                 for k, v in inputs["grads"].items()}
        tiers = choose_tiers(grads, n_pods=world, dcn_bytes_per_s=1.0,
                             compute_seconds=1e-12)    # force all-int8
        with compat.set_mesh(pod):
            out["sync_none"] = numpy_tree(tiered_grad_sync(grads, None, 0))
            strided = {"big_t": grads["big"].transpose(1, 2)}
            out["sync_strided"] = numpy_tree(tiered_grad_sync(
                strided, None, 0))
            out["sync_int8"] = numpy_tree(tiered_grad_sync(
                grads, tiers, sync_seed(0, rank)))
        out["sync_int8_tiers"] = tiers

        # the hier train step on the qwen2.5-3b smoke config
        cfg = configs.get_arch("qwen2.5-3b").smoke
        model = build_model(cfg)
        opt = get_optimizer("sgdm", **inputs["opt_kw"])
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in inputs["batches"]]
        p0 = model_params_from_numpy(inputs["lm_params"])
        for name, t in (("none", None), ("int8", choose_tiers(
                p0, n_pods=world, dcn_bytes_per_s=1.0,
                compute_seconds=1e-12))):
            step = make_train_step(model, opt, hier_sync=True, tiers=t)
            state = {"params": p0, "opt": opt.init(p0)}
            losses = []
            with compat.set_mesh(pod):
                for i, b in enumerate(batches):
                    state, met = step(state, b, i)
                    losses.append(float(met["loss"]))
            out[f"hier_{name}"] = {
                "losses": losses,
                "params": model_params_to_numpy(state["params"])}
        try:
            with compat.set_mesh(pod):
                step(state, {k: v[:world + 1] for k, v in batches[0].items()},
                     0)
        except ValueError as e:
            out["hier_indivisible"] = str(e)

        # the tree step with its cloud tail data-parallel
        tree = inputs["tree"]
        mlp = tiny_mlp()
        params = params_from_numpy(tree["params"])
        x, y = torch.from_numpy(tree["x"]), torch.from_numpy(tree["y"])
        for name, mesh in (("data", data), ("pod_data_model", pdm)):
            p, loss = tree_hybrid_step_from_schedule(
                mlp, params, x, y, MultiSchedule(**tree["sched"]), 0.05,
                stream_edge=tree["edges"], cloud_mesh=mesh)
            out[f"cloud_{name}"] = {"params": params_to_numpy(p),
                                    "loss": float(loss)}
        try:
            tree_hybrid_step_from_schedule(
                mlp, params, x[:23], y[:23], MultiSchedule(**tree["bad"]),
                0.05, stream_edge=tree["edges"], cloud_mesh=data)
        except ValueError as e:
            out["cloud_indivisible"] = str(e)

        # shard_hint: a DTensor is redistributed, a plain tensor kept
        full = torch.arange(4 * world * 3, dtype=torch.float32).reshape(
            4 * world, 3)
        dt = distribute_tensor(full, pod, [Replicate()])
        with compat.set_mesh(pod):
            sharded = shard_hint(dt, ("pod", "data"), None)
            dropped = shard_hint(dt, "model", None)
            plain = shard_hint(full, "pod", None)
        out["shard_hint"] = {
            "sharded": (sharded.placements == (Shard(0),),
                        sharded.to_local().numpy().copy(),
                        torch.equal(sharded.full_tensor(), full)),
            "dropped": dropped.placements == (Replicate(),),
            "plain": plain is full}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


def main(argv) -> int:
    rank, world, store, inputs, path = argv
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    out = run(int(rank), int(world), store, data)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
