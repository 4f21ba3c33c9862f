"""One rank of the partitioned-step checks (tests/test_torch_partition.py).

    python -m tests.torch_partition_worker RANK WORLD STORE INPUTS OUT

Joins a gloo group of WORLD processes through the FileStore at STORE,
reads the pickled numpy INPUTS, builds the ``(data, model)`` meshes the
cases name, and pickles to OUT what this rank computed: per case the
losses of ``repro_torch.distrib.partition.partitioned_step`` over
``make_train_step``, whether every leaf kept its placements after each
step, the local state bytes beside ``launch.dryrun.sharded_bytes``, and
the full params; the shapes the flash and GLA launchers were given; the
flash and GLA routes on DTensors with stub launchers under
``CommDebugMode``; the sLSTM's local route beside its plain loop; the
MoE routing hook and ``router_aux_loss`` on DTensors; and the placements
the model's hints give.  It imports torch and the port only.
"""
from __future__ import annotations

import os
import pickle
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
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
from repro_torch.kernels import gla_scan as gs
from repro_torch.kernels import ops as kops
from repro_torch.launch.dryrun import sharded_bytes
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import common
from repro_torch.models.lm import moe as moe_mod
from repro_torch.models.lm import xlstm as xlstm_mod
from repro_torch.models.lm.model import _resid_hint, build_model
from repro_torch.optim import get_optimizer
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, tree_map


def case_config(case: dict):
    """The port's config of a case: the GLA kernel's route on (its plain
    version on the CPU) wherever the family has a GLA block."""
    return configs.get_arch(case["arch"]).smoke.variant(
        use_flash=case["use_flash"], use_gla_kernel=True,
        **case.get("variant", {}))


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
    """Wraps the flash and GLA launchers: refuses a DTensor (as the
    launchers do) and records the shapes each is given."""

    def __init__(self):
        self.shapes, self.gla = [], []
        self.orig, self.orig_gla = fa.flash_attention_fwd, gs.gla_scan_fwd

    def __call__(self, q, k, v, causal, window=0):
        for t in (q, k, v):
            assert type(t) is torch.Tensor, type(t)
        self.shapes.append((tuple(q.shape), tuple(k.shape)))
        return self.orig(q, k, v, causal, window)

    def gla_fwd(self, q, k, v, log_decay, chunk=128, normalize=False):
        for t in (q, k, v, log_decay):
            assert type(t) is torch.Tensor, type(t)
        self.gla.append((tuple(q.shape), tuple(v.shape)))
        return self.orig_gla(q, k, v, log_decay, chunk, normalize)

    def install(self):
        fa.flash_attention_fwd, gs.gla_scan_fwd = self, self.gla_fwd

    def remove(self):
        fa.flash_attention_fwd, gs.gla_scan_fwd = self.orig, self.orig_gla


def run_case(case, inputs, mesh, log):
    cfg = case_config(case)
    model = build_model(cfg)
    opt = get_optimizer(case["opt"], **case["opt_kw"])
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
    del log.shapes[:], log.gla[:]
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
    out["gla_shapes"] = list(log.gla)
    return out


def raw_step_keeps_placements(inputs, mesh) -> bool:
    """``make_train_step`` alone (no re-layout after it) under the mesh
    and implicit replication returns the placements it was given (on
    the first case's model at 2 microbatches)."""
    from torch.distributed.tensor.experimental import implicit_replication
    case = dict(inputs["cases"][0], batch=2 * inputs["cases"][0]["batch"])
    model = build_model(case_config(case))
    opt = get_optimizer(case["opt"], **case["opt_kw"])
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


def gla_route(inputs, meshes) -> list:
    """Each layout of ``inputs["gla_route"]``: q, k, v, log_decay laid
    out as the layout names (heads over ``model``, or replicated; q and
    k an ``expand`` of one head over all of them, as Mamba2's), through
    ``kops.gla_scan`` with a stub launcher, forward then backward of y,
    S and n under ``CommDebugMode``."""
    seen = []

    def stub(q, k, v, log_decay, chunk=128, normalize=False):
        for t in (q, k, v, log_decay):
            assert type(t) is torch.Tensor and t.is_contiguous(), type(t)
        seen.append((tuple(q.shape), tuple(v.shape)))
        from repro_torch.kernels.ref import ref_gla
        return ref_gla(q, k, v, log_decay, normalize=normalize)

    out = []
    gs.gla_scan_fwd, orig = stub, gs.gla_scan_fwd
    try:
        for r in inputs["gla_route"]:
            mesh = meshes[r["mesh"]]
            heads = [Shard(0), Shard(2)] if r["sharded"] else \
                [Shard(0), Replicate()]
            ins = {n: place(torch.from_numpy(r[n]), mesh,
                            [Shard(0), Replicate()] if r["broadcast"]
                            and n in "qk" else heads).requires_grad_(True)
                   for n in ("q", "k", "v", "a")}
            H = r["v"].shape[2]
            q, k = (ins[n].expand(-1, -1, H, -1) if r["broadcast"]
                    else ins[n] for n in "qk")
            del seen[:]
            with CommDebugMode() as fwd:
                y, (S, n) = kops.gla_scan(q, k, ins["v"], ins["a"],
                                          chunk=r["chunk"],
                                          normalize=r["normalize"])
            ups = [place(torch.from_numpy(r[g]), mesh, t.placements)
                   for g, t in (("dy", y), ("dS", S), ("dn", n))]
            with CommDebugMode() as bwd:
                torch.autograd.backward([y, S, n], ups)
            out.append({
                "name": r["name"], "seen": list(seen),
                "fwd_comms": fwd.get_total_counts(),
                "bwd_comms": bwd.get_total_counts(),
                "layouts": [names(t.placements) for t in (y, S, n)],
                "outs": [t.full_tensor().detach().numpy()
                         for t in (y, S, n)],
                "grads": [ins[n].grad.full_tensor().numpy()
                          for n in ("q", "k", "v", "a")]})
    finally:
        gs.gla_scan_fwd = orig
    return out


def slstm_route(inputs, meshes) -> list:
    """The sLSTM block on DTensors (params laid out by the sharding
    rules, x batch over DP) beside its loop on the full tensors: y and
    the gradients of x and every param."""
    from torch.distributed.tensor.experimental import implicit_replication
    out = []
    for r in inputs["slstm_route"]:
        mesh = meshes[r["mesh"]]
        cfg = xlstm_mod.XLSTMConfig(n_heads=r["heads"])
        p = {k: torch.from_numpy(v) for k, v in r["params"].items()}
        pd = distribute_tree(p, mesh, param_shardings(mesh, p))
        pd = tree_map(lambda t: t.detach().requires_grad_(True), pd)
        x = torch.from_numpy(r["x"])
        xd = place(x, mesh, batch_shardings(mesh, x)).requires_grad_(True)
        with compat.set_mesh(mesh), implicit_replication():
            y = xlstm_mod.apply_slstm(pd, xd, cfg)
            y.backward(place(torch.from_numpy(r["dy"]), mesh, y.placements))
        out.append({"name": r["name"], "y": y.full_tensor().detach().numpy(),
                    "grads": {"x": xd.grad.full_tensor().numpy(), **{
                        k: t.grad.full_tensor().numpy()
                        for k, t in pd.items()}}})
    return out


def block_params(model: str, params: dict) -> dict:
    """Layer 0's params of the mLSTM or MoE block of the xlstm or moe
    smoke twin (the test's plain side takes the same)."""
    if model == "xlstm":
        return tree_map(lambda t: t[0, 0], params["mlstm"]["m"])
    return tree_map(lambda t: t[0], params["layers"]["moe"])


def apply_block(model: str, cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    if model == "xlstm":
        return xlstm_mod.apply_mlstm(p, x, cfg.xlstm, use_kernel=True)
    return moe_mod.apply_moe(p, x, cfg.moe)


def sequence_parallel_blocks(inputs, meshes) -> list:
    """The mLSTM and MoE blocks of the xlstm and moe smoke twins on an
    input laid out as ``seq_parallel`` lays the residual
    (batch over ``data``, T over ``model``), the params by the sharding
    rules: y and the gradients of x and of every param."""
    from torch.distributed.tensor.experimental import implicit_replication
    out = []
    for r in inputs["sp_blocks"]:
        mesh = meshes[r["mesh"]]
        model = r["model"]
        cfg = case_config(next(c for c in inputs["cases"]
                               if c["model"] == model))
        p = block_params(model, model_params_from_numpy(
            inputs["params"][model]))
        pd = tree_map(lambda t: t.detach().requires_grad_(True),
                      distribute_tree(p, mesh, param_shardings(mesh, p)))
        x = place(torch.from_numpy(r["x"]), mesh,
                  [Shard(0), Shard(1)]).requires_grad_(True)
        with compat.set_mesh(mesh), implicit_replication():
            y = apply_block(model, cfg, pd, x)
            y.backward(place(torch.from_numpy(r["dy"]), mesh, y.placements))
        out.append({"name": r["name"],
                    "y": y.full_tensor().detach().numpy(),
                    "grads": {"x": x.grad.full_tensor().numpy(), **{
                        k: t.grad.full_tensor().numpy()
                        for k, t in leaves_named(pd)}}})
    return out


def leaves_named(tree, prefix=""):
    """``(path, leaf)`` of a nested dict, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def moe_on_dtensors(inputs, mesh) -> dict:
    """The MoE smoke model's loss on the (2, 2) mesh, in one group of all
    128 tokens (split by ``data``: gathered) and in groups of 32 (each
    ``data`` rank holding two whole ones): the routing hook's ids and a
    planted routing (each choice moved one expert on) beside the plain
    model's; ``router_aux_loss`` of the first layer's MoE on DTensors
    beside its plain value."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    case = next(c for c in inputs["cases"] if c["model"] == "moe")
    cfg = case_config(case)
    p0 = model_params_from_numpy(inputs["params"]["moe"])
    batch = case_batches(case, inputs)[0]
    params = distribute_tree(p0, mesh, param_shardings(mesh, p0))
    dbatch = distribute_tree(batch, mesh, batch_shardings(mesh, batch))
    E = cfg.moe.n_experts
    out = {}
    for group in (cfg.moe.group_size, 32):
        model = build_model(cfg.variant(moe=dataclasses.replace(
            cfg.moe, group_size=group)))
        for label, planted in (("own", False), ("planted", True)):
            for side in ("plain", "partitioned"):
                seen = []

                def hook(idx):
                    seen.append(idx.clone())
                    return (idx + 1) % E if planted else idx
                with moe_mod.routing(hook):
                    if side == "plain":
                        loss = model.loss_fn(p0, batch)
                    else:
                        with compat.set_mesh(mesh), implicit_replication():
                            loss = model.loss_fn(params,
                                                 dbatch).full_tensor()
                out[f"{label}_{side}_g{group}"] = {
                    "loss": float(loss), "ids": [t.numpy() for t in seen]}
    x = torch.from_numpy(inputs["moe_x"])
    lp = tree_map(lambda t: t[0], p0["layers"]["moe"])
    lpd = tree_map(lambda t: t[0], params["layers"]["moe"])
    with compat.set_mesh(mesh), implicit_replication():
        aux = moe_mod.router_aux_loss(
            lpd, place(x, mesh, batch_shardings(mesh, x)), cfg.moe)
    out["aux"] = (float(moe_mod.router_aux_loss(lp, x, cfg.moe)),
                  float(aux.full_tensor()))
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


def launcher_refuses(mesh) -> dict:
    """The flash and GLA launchers given a DTensor: their errors."""
    q = place(torch.zeros(4, 8, 16), mesh, [Replicate()] * 2)
    a = place(torch.zeros(4, 8), mesh, [Replicate()] * 2)
    calls = {"flash_attention": lambda: fa.flash_attention_fwd(q, q, q, True),
             "gla_scan": lambda: gs.gla_scan_fwd(q, q, q, a)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "no error"
        except TypeError as e:
            out[name] = str(e)
    return out


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
    log.install()
    try:
        meshes = {tuple(s): init_device_mesh("cpu", tuple(s),
                                             mesh_dim_names=("data",
                                                             "model"))
                  for s in inputs["meshes"]}
        for case in inputs["cases"]:
            out["cases"][case["name"]] = run_case(
                case, inputs, meshes[tuple(case["mesh"])], log)
        log.remove()
        out["raw_step_keeps_placements"] = {
            str(s): raw_step_keeps_placements(inputs, m)
            for s, m in meshes.items()}
        out["route"] = flash_route(inputs, meshes)
        out["gla_route"] = gla_route(inputs, meshes)
        out["slstm_route"] = slstm_route(inputs, meshes)
        out["moe"] = moe_on_dtensors(inputs, meshes[(2, 2)])
        out["sp_blocks"] = sequence_parallel_blocks(inputs, meshes)
        out["launcher_refuses"] = launcher_refuses(meshes[(1, 4)])
        out["hints"] = hints(inputs, meshes)
        out["logits_hint"] = {str(s): logits_hint_in_loss(inputs, m)
                              for s, m in meshes.items()}
        dist.barrier()
    finally:
        log.remove()
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
