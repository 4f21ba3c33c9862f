"""Production mesh + target-hardware constants (NVIDIA H100).

The port of :mod:`repro.launch.mesh`, with the card's figures in place
of the TPU v5e's.  ``make_production_mesh`` is a function (not a module
constant), so importing this module touches no process-group state: it
builds its ``DeviceMesh`` over PyTorch's ``fake`` backend, one process
standing as rank 0 of 256 or 512, the dry run's counterpart of the
reference's 512 placeholder host devices.  A caller that needs only the
sharding rules passes a :class:`repro_torch.distrib.MeshShape`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-card numbers of the roofline analysis: one NVIDIA H100 80GB
    HBM3 (SXM) at a 700.00 W power limit."""
    # dense bf16 on the tensor cores (H100 SXM data sheet; the figure of
    # PERF.md's kernel bounds)
    peak_flops: float = 989e12
    hbm_bw: float = 3.35e12           # HBM3 bytes/s (data sheet)
    # NVLink 4: 900 GB/s aggregate over 18 links, 450e9 each direction
    ici_bw: float = 450e9
    # one 400 Gb/s NDR InfiniBand port per GPU, as a DGX H100 wires its
    # cards: a deployment's figure, not the card's
    dcn_bw: float = 50e9
    # nvidia-smi --query-gpu=memory.total on an NVIDIA H100 80GB HBM3,
    # 700.00 W: 81,559 MiB
    hbm_bytes: float = 81_559 * 2 ** 20


H100 = Hardware()


def _fake_group(world_size: int) -> None:
    """A default group of ``world_size`` ranks over the ``fake`` backend,
    this process rank 0; a fake group of another size is replaced, a real
    one raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"make_production_mesh: a real default process group "
                f"({dist.get_backend()}) is up; the production meshes run "
                f"over the fake backend in a process of their own")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def release_production_mesh() -> None:
    """Destroys the default group if it is the fake one."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def make_fake_mesh(shape, axes):
    """A CPU ``DeviceMesh`` of ``shape`` named ``axes`` over the fake
    backend, this process rank 0 (release it with
    :func:`release_production_mesh`)."""
    from torch.distributed.device_mesh import init_device_mesh
    _fake_group(int(np.prod(shape)))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod",
    "data", "model")``, over the fake backend (:func:`make_fake_mesh`)."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def mesh_chips(mesh) -> int:
    """Devices in ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``)."""
    return int(mesh.size())
