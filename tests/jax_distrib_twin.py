"""The JAX twins of tests/test_torch_distrib.py's multi-process checks,
on a 2-device ``("pod",)`` mesh of host CPU devices.

    python -m tests.jax_distrib_twin INPUTS OUT

Reads the pickled numpy INPUTS that the port's ranks read, and pickles
to OUT: ``repro.distrib.tiered_sync.tiered_grad_sync(tiers=None)`` on
the pod-sharded gradients (as tests/test_distrib.py runs it), and
``repro.train.step.make_train_step(hier_sync=True, tiers=None)`` on the
qwen2.5-3b smoke config from the same params, optimizer and batches.
"""
from __future__ import annotations

import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.distrib import compat  # noqa: E402
from repro.distrib.tiered_sync import tiered_grad_sync  # noqa: E402
from repro.models.lm.model import build_model  # noqa: E402
from repro.optim import get_optimizer  # noqa: E402
from repro.train.step import make_train_step  # noqa: E402


def main(argv) -> int:
    inputs, path = argv
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    mesh = jax.make_mesh((2,), ("pod",))
    out = {}
    grads = {k: jnp.asarray(v) for k, v in data["grads"].items()}

    def per_pod(g, key):
        return tiered_grad_sync(g, None, key, axis="pod")

    sync = compat.shard_map(per_pod, in_specs=(P("pod"), P()),
                            out_specs=P(), axis_names={"pod"},
                            check_vma=False, mesh=mesh)
    with compat.set_mesh(mesh):
        got = jax.jit(sync)(grads, jax.random.PRNGKey(0))
    out["sync_none"] = {k: np.asarray(v) for k, v in got.items()}

    model = build_model(get_arch("qwen2.5-3b").smoke)
    opt = get_optimizer("sgdm", **data["opt_kw"])
    params = jax.tree.map(jnp.asarray, data["lm_params"])
    state = {"params": params, "opt": opt.init(params)}
    step = jax.jit(make_train_step(model, opt, hier_sync=True, tiers=None))
    losses = []
    with compat.set_mesh(mesh):
        for i, b in enumerate(data["batches"]):
            state, met = step(state, {k: jnp.asarray(v) for k, v in
                                      b.items()}, jax.random.PRNGKey(i))
            losses.append(float(met["loss"]))
    out["hier_none"] = {"losses": losses, "params": jax.tree.map(
        np.asarray, state["params"])}
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
