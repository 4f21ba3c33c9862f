"""The ambient mesh: which ``DeviceMesh`` the multi-process paths use.

The port of :mod:`repro.distrib.compat`'s :func:`set_mesh` /
:func:`current_mesh`: ``with set_mesh(mesh): step(...)`` puts a
``torch.distributed.device_mesh.DeviceMesh`` in scope, and the hier
train step (:func:`repro_torch.train.step.make_train_step` with
``hier_sync=True``) and :func:`repro_torch.models.lm.common.shard_hint`
read it, as the reference's read ``jax.set_mesh``'s.

The reference's other half, ``shard_map``, has no counterpart.  There a
body runs once per shard and XLA inserts the collectives it names; here
every rank is its own process, runs the body on its own shard, and the
collectives are explicit ``torch.distributed`` calls on the mesh's
process groups (``mesh.get_group(axis)``).

Nothing here creates a process group: the caller owns it (or the mesh).
"""
from __future__ import annotations

import contextlib

_MESH_STACK = []


def current_mesh():
    """The innermost mesh entered via :func:`set_mesh`, or ``None``."""
    return _MESH_STACK[-1] if _MESH_STACK else None


@contextlib.contextmanager
def set_mesh(mesh):
    """Puts ``mesh`` in scope for the block."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()
