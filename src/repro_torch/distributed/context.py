"""Ambient mesh registry (the port of the JAX package's
``distributed/context.py``): launch code registers the active mesh so
that code can read it without threading a mesh through every call.  In
one program the mesh knobs (``moe_group_shard``, ``attn_seq_shards``)
change no value whatever mesh is registered; they act in a rank's step
(``ranks=``, ``distributed/tensor_parallel.py``).

The mesh is a torch ``DeviceMesh`` or a ``sharding.MeshShape``; either
names its axes in ``mesh_dim_names`` and sizes them in ``shape``.  This
module imports nothing of ``torch.distributed``.
"""
from __future__ import annotations

from typing import Any, Optional

_MESH: Optional[Any] = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def clear_mesh() -> None:
    global _MESH
    _MESH = None
