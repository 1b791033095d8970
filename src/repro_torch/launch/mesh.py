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
* :func:`make_mesh` / :func:`registered_mesh` — an R x M ("data",
  "model") mesh over a process group of R M ranks, on the backend the
  caller names: ``nccl`` where every rank owns a device, ``gloo`` on the
  CPU or where ranks share a card (gloo takes CUDA tensors for
  ``all_reduce``, the only exchange the port makes).
  No fall-back: NCCL over ranks that would share a device raises here,
  before NCCL is reached.
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


def rank_device(device=None):
    """The device a ``torchrun`` rank computes on: ``cuda:LOCAL_RANK``
    when ``device`` names the GPU (``None`` or ``"cuda"``) and this host
    has more than one card and a card for each of its
    ``LOCAL_WORLD_SIZE`` ranks, whatever the backend; else ``device`` as
    given (with fewer cards than ranks, they share the default one)."""
    import os

    if device not in (None, "cuda"):
        return device
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", 1)))
    n_dev = torch.cuda.device_count()
    if 1 < n_dev and local_world <= n_dev:
        return f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return device


def check_backend(backend: str, device, local_world: int) -> None:
    """Refuse a backend that cannot serve ``local_world`` ranks of this
    host on ``device``: ``nccl`` needs a CUDA device per rank (NCCL
    refuses two ranks on one GPU as a duplicate), ``gloo`` takes any;
    anything else raises."""
    if backend == "gloo":
        return
    if backend != "nccl":
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"nccl needs CUDA devices, got {dev}")
    n_dev = torch.cuda.device_count()
    if local_world > n_dev:
        raise ValueError(
            f"nccl with {local_world} ranks on {n_dev} CUDA device(s) of "
            "this host: ranks would share a device, which NCCL refuses "
            "(duplicate GPU); use gloo")


def make_mesh(shape, device=None, backend=None, *, rank=None,
              world_size=None, store=None):
    """An R x M ``DeviceMesh`` (``"data"``, ``"model"``) over a process
    group of ``R M`` ranks, made here: from ``store`` (a
    ``torch.distributed.Store``, e.g. a ``FileStore``) with ``rank`` and
    ``world_size``, or without one from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``).  ``device``: where this rank
    computes (``None``: the GPU, ``cuda:LOCAL_RANK`` under ``nccl``);
    ``backend``: ``"nccl"`` or ``"gloo"`` (``None``: nccl on the GPU,
    gloo on the CPU).  One process holds one group: it raises if one is
    up.  The caller destroys the group, or uses :func:`registered_mesh`.
    Row-major rank order, ``"model"`` innermost: rank ``r`` is data rank
    ``r // M``, model rank ``r % M``."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(n) for n in shape)
    if len(shape) != 2:
        raise ValueError(f"a mesh is (data, model), got {shape}")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process")
    env = store is None
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if world_size != shape[0] * shape[1]:
        raise ValueError(f"mesh {shape} needs {shape[0] * shape[1]} ranks, "
                         f"the group has {world_size}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    check_backend(backend, dev, local_world)
    kw = {"init_method": "env://"} if env else {"store": store}
    if backend == "nccl":
        index = dev.index if dev.index is not None else local_rank
        kw["device_id"] = torch.device("cuda", index)
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    try:
        return init_device_mesh("cuda" if backend == "nccl" else "cpu",
                                shape, mesh_dim_names=HOST_AXES)
    except BaseException:
        dist.destroy_process_group()
        raise


@contextlib.contextmanager
def registered_mesh(shape, device=None, backend=None, **kw):
    """:func:`make_mesh` set as the ambient mesh for the block; on exit the
    mesh is cleared and the process group destroyed."""
    import torch.distributed as dist

    mesh = make_mesh(shape, device, backend, **kw)
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        clear_mesh()
        dist.destroy_process_group()


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
