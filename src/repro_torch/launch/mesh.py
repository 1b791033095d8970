"""Mesh construction (the port of the JAX package's ``launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device and no process group (``torch.distributed`` is imported inside
the functions that need it).

* :func:`make_production_mesh` — the reference's dry-run targets, as
  topologies without devices (:class:`~repro_torch.distributed.sharding.
  MeshShape`): the sharding plan is defined on them and held to the
  reference's spec for spec.
* :func:`make_host_mesh` — the degenerate 1 x 1 ``DeviceMesh`` with the
  same axis names that the port runs under, on the GPU (NCCL) unless the
  CPU is asked for (gloo).
* :func:`registered_host_mesh` — that mesh registered as the ambient
  mesh (``distributed.context.set_mesh``) for a ``with`` block, its
  process group destroyed after it.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.context import clear_mesh, set_mesh
from repro_torch.distributed.sharding import MeshShape
from repro_torch.tree import resolve_device

HOST_AXES = ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's (16, 16) = (data, model) pod mesh; multi-pod adds a
    leading pod axis: (2, 16, 16) = (pod, data, model).  A topology, not
    a machine: it holds no devices."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(HOST_AXES, (16, 16))


def make_host_mesh(device=None):
    """A 1 x 1 ``DeviceMesh`` ("data", "model") over a process group of
    one rank, made from an in-process store (no address, no environment):
    NCCL on the GPU, gloo when ``device`` is the CPU.  ``device=None`` is
    the GPU, and raises when there is none; NCCL failing to start raises
    too (no fall-back to gloo).  One process holds one group: it raises
    if one is already up.  The caller destroys the group
    (``torch.distributed.destroy_process_group``), or uses
    :func:`registered_host_mesh`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        dist.init_process_group(
            "nccl", store=dist.HashStore(), rank=0, world_size=1,
            device_id=torch.device("cuda", index))
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        return init_device_mesh(dev.type, (1, 1), mesh_dim_names=HOST_AXES)
    except BaseException:
        dist.destroy_process_group()
        raise


@contextlib.contextmanager
def registered_host_mesh(device=None):
    """:func:`make_host_mesh` set as the ambient mesh for the block; on
    exit the mesh is cleared and the process group destroyed."""
    import torch.distributed as dist

    mesh = make_host_mesh(device)
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        clear_mesh()
        dist.destroy_process_group()


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
