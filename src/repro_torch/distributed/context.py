"""Ambient mesh registry (the port of the JAX package's
``distributed/context.py``): launch code registers the active mesh so
that model code can read it (``moe_group_shard``) without threading a
mesh through every call.

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


def check_model_axis(knob: str) -> None:
    """The rule of a knob that places work on the ``"model"`` mesh axis
    from the ambient mesh (``moe_group_shard``; ``attn_seq_shards`` reads
    the rank's block instead, ``models/attention.py``).  Under no mesh,
    or one whose ``"model"`` axis has one device, the placement is the
    identity, as XLA's sharding constraint is on the reference's host
    mesh: return.  Over a larger axis the experts would have to be placed
    over ranks, which the port does not do yet: raise, naming 7(b) step
    3b."""
    mesh = get_mesh()
    if mesh is None:
        return
    size = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get("model", 1)
    if size > 1:
        raise NotImplementedError(
            f"{knob} over a 'model' mesh axis of {size} devices needs "
            "multi-device execution, which is not yet ported to repro_torch "
            "(ROADMAP Queue A item 7(b) step 3b)")
