"""The JAX twins of tests/test_torch_partition.py's partitioned steps, on
a ``(data, model)`` mesh of 4 host CPU devices.

    python -m tests.jax_partition_twin INPUTS OUT [CASE ...]

Reads the pickled numpy INPUTS that the port's ranks read and pickles to
OUT, for each case named (all by default): the losses and final params
of ``jax.jit(make_train_step(...), in_shardings=(state, batch, key),
out_shardings=(state, None))`` over 2 steps, the reference's own
partitioned step (src/repro/launch/dryrun.py:144-147), with the
smoke configs' plain ``chunked_gla`` (``use_gla_kernel=False``: the
reference's own tests hold it to the interpret-mode Pallas kernel, which
under ``jit(in_shardings)`` would make this process the slowest part of
the test), and for the cases that ask, one device's argument bytes of
the compiled step (``memory_analysis()``); and the
spec each of the reference's hints (``_qkv_hints``,
``_resid_hint``, the logits chunk's ``shard_hint``) names on each mesh.
"""
from __future__ import annotations

import os
import pickle
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.distrib import compat  # noqa: E402
from repro.distrib import (batch_shardings, opt_state_shardings,  # noqa: E402
                           param_shardings)
from repro.models.lm import attention as attn  # noqa: E402
from repro.models.lm import common  # noqa: E402
from repro.models.lm import model as model_mod  # noqa: E402
from repro.models.lm.model import _resid_hint, build_model  # noqa: E402
from repro.optim import get_optimizer  # noqa: E402
from repro.train.step import make_train_step  # noqa: E402


def case_config(case: dict):
    return get_arch(case["arch"]).smoke.variant(
        use_flash=case["use_flash"], **case.get("variant", {}))


def make_mesh(shape) -> Mesh:
    return Mesh(np.array(jax.devices()[:4]).reshape(shape),
                ("data", "model"))


def run_case(case: dict, data: dict) -> dict:
    mesh = make_mesh(tuple(case["mesh"]))
    model = build_model(case_config(case))
    opt = get_optimizer(case["opt"], **case["opt_kw"])
    params = jax.tree.map(jnp.asarray, data["params"][case["model"]])
    state = {"params": params, "opt": opt.init(params)}
    shard = {"params": param_shardings(mesh, params, fsdp=case["fsdp"]),
             "opt": opt_state_shardings(mesh, state["opt"],
                                        fsdp=case["fsdp"])}
    batches = [{k: jnp.asarray(v[:case["batch"]]) for k, v in b.items()}
               for b in data["batches"][case["model"]]]
    bshard = batch_shardings(mesh, batches[0])
    step = jax.jit(make_train_step(model, opt, microbatches=case["mb"]),
                   in_shardings=(shard, bshard, NamedSharding(mesh, P())),
                   out_shardings=(shard, None))
    # laid out before the first call, so that the second (whose state the
    # first laid out) runs the same executable
    state = jax.device_put(state, shard)
    batches = [jax.device_put(b, bshard) for b in batches]
    out = {}
    if case.get("tally"):
        # one device's argument bytes of the compiled partitioned step
        with compat.set_mesh(mesh):
            compiled = step.lower(state, batches[0],
                                  jax.random.PRNGKey(0)).compile()
        out["argument_bytes"] = int(
            compiled.memory_analysis().argument_size_in_bytes)
    losses = []
    with compat.set_mesh(mesh):
        for i, b in enumerate(batches):
            state, met = step(state, b, jax.random.PRNGKey(i))
            losses.append(float(met["loss"]))
    return dict(out, losses=losses,
                params=jax.tree.map(np.asarray, state["params"]))


def _reduced(mesh: Mesh, shape, axes) -> tuple:
    """``axes`` as the reference's ``shard_hint`` reduces them (names absent
    from the mesh dropped, an entry whose product does not divide its dim
    dropped), every mesh axis automatic."""
    def reduce(a, dim):
        names = tuple(n for n in (a if isinstance(a, tuple) else (a,))
                      if n is not None and n in mesh.axis_names)
        prod = int(np.prod([mesh.shape[n] for n in names]))
        if not names or dim % prod != 0 or dim < prod:
            return None
        return names if len(names) > 1 else names[0]
    return tuple(reduce(a, shape[i]) for i, a in enumerate(axes))


def hint_specs(data: dict) -> list:
    """The spec each of the reference's hints names: the arguments it
    passes to ``shard_hint``, reduced by :func:`_reduced`.

    Not the constraint it lowers to: under jax 0.9 the reference's filter
    of automatic axes (``str(t) == "Auto"``) keeps none, since the axis
    types print as ``AxisType.Auto``, so each hint constrains its tensor
    replicated on every dim."""
    seen = []
    mods = (attn, common, model_mod)

    def spy(x, *axes):
        seen.append(_reduced(mesh, x.shape, axes))
        return x

    out = []
    origs = [m.shard_hint for m in mods]
    for m in mods:
        m.shard_hint = spy
    try:
        for h in data["hints"]:
            mesh = make_mesh(tuple(h["mesh"]))
            xs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in h["shapes"]]
            del seen[:]
            with compat.set_mesh(mesh):
                if h["kind"] == "qkv":
                    attn._qkv_hints(*xs)
                elif h["kind"] == "resid":
                    _resid_hint(get_arch("qwen2.5-3b").smoke.variant(
                        seq_parallel=h["seq_parallel"]), xs[0])
                else:
                    common.shard_hint(xs[0], ("pod", "data"), None, "model")
            out.append({"name": h["name"], "specs": list(seen)})
    finally:
        for m, f in zip(mods, origs):
            m.shard_hint = f
    return out


def wait_for(path: str, timeout: float = 300.0) -> None:
    """Waits for ``path``: the test starts this process before it writes
    the inputs, so that the imports overlap its own work."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.05)


def main(argv) -> int:
    inputs, path, *names = argv
    wait_for(inputs)
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    out = {"cases": {c["name"]: run_case(c, data) for c in data["cases"]
                     if not names or c["name"] in names}}
    out["hints"] = hint_specs(data)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
