"""Logical-to-physical sharding rules (the port of the JAX package's
``distributed/sharding.py``), realised as PyTorch ``DeviceMesh``/DTensor
placements.

Mesh axes: ("data", "model") single pod, ("pod", "data", "model") multi-pod.

* Federated axis: mode A -> clients sharded over ("pod","data") (or just
  "data" single-pod); mode B -> pod silos (client axis = "pod").
* Model params: name-guided greedy placement — "model" goes to the
  preferred dim if divisible (experts / d_ff / vocab / head dims), else to
  the largest divisible dim, else replicated (heads like 15 or 25 simply do
  not divide 16, and those dims stay replicated).  Mode B additionally
  places "data" on a second dim (FSDP/ZeRO-style).
* Scan-stacked block params (``unit``, ``enc_unit``) carry a leading
  layer-group dim that is never sharded; FedState leaves carry the
  leading client dim.

The plan reads only a mesh's axis names and sizes (``mesh_dim_names``,
``shape``), so it is made alike for a torch ``DeviceMesh`` and for a
:class:`MeshShape`, a mesh without devices (the production topologies,
``launch/mesh.make_production_mesh``).  Specs are this module's
:class:`PartitionSpec` (``P``), over trees in the reference's layout
(``transformer.lm_tree``; paths ``"unit/0/attn/wq"``).  :func:`named`
turns a spec into DTensor placements, :func:`place_tree` a tree into
DTensors (each rank's block a view of the leaf it holds, so a shard that
is the whole leaf is the leaf itself), :func:`local_tree` back into plain
tensors.  ``torch.distributed`` is imported only by those three.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Sequence, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.tree import tree_map, tree_map_with_path


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: one entry per
    tensor dim, ``None`` (replicated), a mesh axis name, or a tuple of
    names (sharded over their product, the first the major); compared and
    printed as the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh with no devices: its axis names and sizes, read as a
    ``DeviceMesh``'s (``mesh_dim_names``, ``shape``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.sizes


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return math.prod(_axis_size(mesh, n) for n in name)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get(name, 1)


def _place(spec: list, shape: Sequence[int], axis, size: int,
           preferred: Sequence[int]) -> None:
    """Greedy: put ``axis`` on the first preferred dim that divides."""
    for i in preferred:
        if i < len(shape) and spec[i] is None and shape[i] % size == 0 \
                and shape[i] >= size:
            spec[i] = axis
            return


def _path_str(path) -> str:
    """A key path (dict keys, tuple or list positions) as the reference
    prints it: ``"unit/0/attn/wq"``."""
    return "/".join(str(p) for p in path)


def greedy_spec(path_s: str, shape: Tuple[int, ...], mesh, *,
                skip: int, fsdp: bool) -> P:
    """Spec for one param leaf; ``skip`` leading dims stay unsharded."""
    ndim = len(shape)
    spec: list = [None] * ndim
    body = list(range(skip, ndim))
    if not body:
        return P(*spec)
    by_size = sorted(body, key=lambda i: -shape[i])
    model_size = _axis_size(mesh, "model")

    name = path_s.rsplit("/", 1)[-1]
    pref: list = []
    if name in ("w_gate", "w_up") and ndim - skip == 3:       # moe (E, d, f)
        pref = [body[0], body[2], body[1]]                    # experts, f, d
    elif name == "w_down" and ndim - skip == 3:               # moe (E, f, d)
        pref = [body[0], body[1], body[2]]
    elif name == "tok":                                       # (vocab, d)
        pref = [body[0], body[1]]
    elif name in ("head",):                                   # (d, vocab)
        pref = [body[-1]] + body[:-1]
    elif name in ("wo", "w_down", "w_out", "out_proj", "down_proj"):
        pref = [body[0]] + body[1:]                           # row-parallel
    elif name in ("wq", "wk", "wv", "w_gate", "w_up", "w_in", "up_proj",
                  "in_proj"):
        pref = [body[-1]] + body[:-1]                         # col-parallel
    pref = pref + by_size
    _place(spec, shape, "model", model_size, pref)

    if fsdp:
        data_size = _axis_size(mesh, "data")
        rest = [i for i in by_size if spec[i] is None]
        _place(spec, shape, "data", data_size, rest)
    return P(*spec)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: Any                      # a DeviceMesh or a MeshShape
    cfg: ArchConfig
    fed_axis: Any                  # "data" | ("pod","data") | "pod" | None
    n_clients: int
    fsdp: bool                     # shard params over "data" too (mode B)
    # mode A with per-client params REPLICATED over "model" and the
    # per-client batch data-parallel over "model" instead of
    # tensor-parallel (when one client's weights fit a device)
    inner_dp: bool = False

    # ------------------------------------------------------------------
    def param_spec_tree(self, params_shape: Any, client_dim: bool = False,
                        client_axis: Any = "__fed__"):
        """PartitionSpec tree for model params (or stacked client params).

        ``client_axis`` overrides the mesh axis placed on the leading
        client dim when ``client_dim``: the default sentinel resolves to
        the plan's federated axis (resident (C, ...) stacks); ``None``
        replicates the leading dim (gathered (S, ...) blocks)."""
        if client_axis == "__fed__":
            client_axis = self.fed_axis

        def leaf_spec(path, leaf):
            path_s = _path_str(path)
            head = path_s.split("/")[0]
            skip = 1 if head in ("unit", "enc_unit") else 0   # scan dim
            skip += int(client_dim)                           # client dim
            if self.inner_dp:
                spec = [None] * leaf.ndim                     # replicated
            else:
                spec = list(greedy_spec(path_s, tuple(leaf.shape),
                                        self.mesh, skip=skip,
                                        fsdp=self.fsdp))
            if client_dim:
                spec[0] = client_axis
            return P(*spec)

        return tree_map_with_path(leaf_spec, params_shape)

    def fed_state_specs(self, state_shape, *, gathered: bool = False) -> Any:
        """Spec tree matching a FedState of this arch.

        ``gathered=False`` (default): the resident state — every
        per-client leaf carries a leading (C, ...) dim sharded over the
        federated mesh axis.

        ``gathered=True``: specs for the active-subset blocks the sparse
        round (``bafdp.bafdp_round_sparse`` via
        ``fed_state.gather_clients``) extracts per round — same tree
        structure, but the leading (S_max, ...) block dim replicates
        across the federated axis (every shard needs the whole round's S
        rows for the Eq. (20) consensus fold).  Body dims keep their
        model-axis placement.  Non-per-client leaves (``z``, ``t``) keep
        their resident specs.
        """
        from repro_torch.core.fed_state import FedState

        client_axis = None if gathered else self.fed_axis
        spec = functools.partial(self.param_spec_tree, client_dim=True,
                                 client_axis=client_axis)
        W = spec(state_shape.W)
        z = self.param_spec_tree(state_shape.z, client_dim=False)
        z_local = spec(state_shape.z_local)
        phi = spec(state_shape.phi)
        vec = P(client_axis)
        opt = None
        if state_shape.opt is not None:
            opt = {"m": spec(state_shape.opt["m"]),
                   "v": spec(state_shape.opt["v"]),
                   "count": vec}
        comp = None
        if getattr(state_shape, "comp", None) is not None:
            comp = spec(state_shape.comp)
        return FedState(W=W, z=z, z_local=z_local, phi=phi, lam=vec, eps=vec,
                        t=P(), opt=opt, tau=vec, comp=comp)

    # ------------------------------------------------------------------
    def batch_spec(self, leaf_shape: Tuple[int, ...]) -> P:
        """(C, b, S, ...) batches: clients on fed axis, b over 'data' in
        mode B (fed axis 'pod'), b over 'model' in inner-DP mode A (when
        divisible — multi-pod mode A halves b below the axis size)."""
        spec: list = [None] * len(leaf_shape)
        spec[0] = self.fed_axis
        if self.fsdp and len(leaf_shape) >= 2:
            spec[1] = "data"
        elif self.inner_dp and len(leaf_shape) >= 2:
            model = _axis_size(self.mesh, "model")
            if leaf_shape[1] % model == 0 and leaf_shape[1] >= model:
                spec[1] = "model"
            elif len(leaf_shape) >= 3 and leaf_shape[2] % model == 0:
                spec[2] = "model"      # fall back to sequence sharding
        return P(*spec)

    def batch_spec_tree(self, batch_shape: Any) -> Any:
        return tree_map(lambda l: self.batch_spec(tuple(l.shape)),
                        batch_shape)

    # ------------------------------------------------------------------
    def decode_state_specs(self, state_shape: Any, batch: int) -> Any:
        """Serve-time state in the reference's stacked layout (``layers``
        a tuple of (n_groups, B, ...) trees, ``memory``): no fed axis.
        Batch dim -> 'data' (+'pod'); if batch == 1 (long_500k) the
        longest later dim takes 'data'."""
        names = tuple(self.mesh.mesh_dim_names)
        data_ax = ("pod", "data") if "pod" in names else "data"
        data_size = _axis_size(self.mesh, data_ax)
        model_size = _axis_size(self.mesh, "model")

        def leaf_spec(path, leaf):
            shape = tuple(leaf.shape)
            spec: list = [None] * leaf.ndim
            if _path_str(path).endswith("memory"):
                # (B, F, d): encoder memory
                if shape[0] % data_size == 0 and shape[0] >= data_size:
                    spec[0] = data_ax
                return P(*spec)
            # stacked (n_groups, B, ...) leaves
            if leaf.ndim >= 2 and shape[1] == batch:
                bdim = 1
            else:
                bdim = None
            if bdim is not None and shape[bdim] % data_size == 0 \
                    and shape[bdim] >= data_size:
                spec[bdim] = data_ax
            elif leaf.ndim >= 3:
                # batch too small (long_500k): shard the longest later dim
                body = sorted(range(2, leaf.ndim), key=lambda i: -shape[i])
                _place(spec, shape, data_ax, data_size, body)
            body = [i for i in range(2, leaf.ndim) if spec[i] is None]
            body = sorted(body, key=lambda i: -shape[i])
            _place(spec, shape, "model", model_size, body)
            return P(*spec)

        return tree_map_with_path(leaf_spec, state_shape)


def make_plan(cfg: ArchConfig, mesh, inner_dp: bool = False) -> ShardingPlan:
    names = tuple(mesh.mesh_dim_names)
    if cfg.fed_mode == "A":
        fed_axis: Any = ("pod", "data") if "pod" in names else "data"
        fsdp = False
    else:
        fed_axis = "pod" if "pod" in names else None
        fsdp = True
        inner_dp = False            # mode B params never fit a device
    C = _axis_size(mesh, fed_axis) if fed_axis else 1
    return ShardingPlan(mesh=mesh, cfg=cfg, fed_axis=fed_axis,
                        n_clients=max(C, 1), fsdp=fsdp, inner_dp=inner_dp)


# ---------------------------------------------------------------------------
# Realisation as DTensor placements
def named(mesh, spec: P, shape: Sequence[int] = None) -> tuple:
    """``spec`` as DTensor placements, one per mesh dim: ``Shard(d)`` on
    each mesh dim that the spec names at tensor dim ``d``, ``Replicate()``
    on the others.  A tuple entry such as ``("pod", "data")`` shards dim
    ``d`` over both mesh dims; DTensor splits them in mesh-dim order, the
    reference's major-to-minor order, so the tuple must name them in
    that order.  With ``shape``, every sharded dim must split evenly
    (DTensor would pad an uneven one; the reference's plan never asks
    for it)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    if shape is not None and len(spec) > len(shape):
        raise ValueError(f"{spec} has more entries than the {len(shape)} "
                         "dims of its tensor")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"{spec}: axes {unknown} not in the mesh's "
                             f"{names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(set(dims)):
            raise ValueError(f"{spec}: {entry} is not in the mesh's axis "
                             f"order {names}")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"{spec}: mesh axis {names[m]!r} used "
                                 "twice")
            out[m] = Shard(d)
        n = math.prod(sizes[m] for m in dims)
        if shape is not None and shape[d] % n:
            raise ValueError(f"{spec}: dim {d} of {tuple(shape)} does not "
                             f"split evenly over {entry} ({n} shards)")
    return tuple(out)


def _local_block(leaf, mesh, placements):
    """This rank's block of ``leaf`` under ``placements`` (all even): a
    view, and ``leaf`` itself where every split has one shard."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank holds no coordinate of the mesh")
    sizes = tuple(mesh.shape)
    out = leaf
    for d in range(leaf.ndim):
        mdims = [m for m, p in enumerate(placements)
                 if isinstance(p, Shard) and p.dim == d]
        n = math.prod(sizes[m] for m in mdims)
        if n == 1:
            continue
        idx = 0
        for m in mdims:                       # mesh-dim order: major first
            idx = idx * sizes[m] + coord[m]
        block = leaf.shape[d] // n
        out = out.narrow(d, idx * block, block)
    return out


def _walk(f, tree, *rest):
    """``f`` over the leaves of ``tree`` (tensors, or ``PartitionSpec``s)
    and the matching entries of ``rest``: dicts, named tuples (a
    ``FedState``), tuples and lists by structure; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(f, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(f, t, *(r[i] for r in rest))
                            for i, t in enumerate(tree)))
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_walk(f, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return f(tree, *rest)


def map_specs(f, spec_tree):
    """``f`` over the ``PartitionSpec`` leaves of a spec tree."""
    return _walk(f, spec_tree)


def place_tree(tree, spec_tree, mesh):
    """Every tensor of ``tree`` (dicts, tuples, lists, a ``FedState``) as
    a DTensor on ``mesh`` placed by its spec in ``spec_tree``: the
    global tensor is the leaf, this rank's local shard the block its
    mesh coordinate owns (:func:`named`), taken as a view.  Where every
    split has one shard (any 1 x 1 mesh) the local shard is the leaf
    itself: no copy is made."""
    from torch.distributed.tensor import DTensor

    def place(leaf, spec):
        if not isinstance(spec, P):
            raise TypeError(f"expected a PartitionSpec for a leaf of "
                            f"{tuple(leaf.shape)}, got {spec!r}")
        placements = named(mesh, spec, tuple(leaf.shape))
        return DTensor.from_local(
            _local_block(leaf, mesh, placements), mesh, placements,
            run_check=False, shape=leaf.shape, stride=leaf.stride())

    return _walk(place, tree, spec_tree)


def local_tree(tree):
    """The local shards of a tree of DTensors as plain tensors (the
    storage they hold; other leaves as they are)."""
    from torch.distributed.tensor import DTensor

    return _walk(lambda t: t.to_local() if isinstance(t, DTensor) else t,
                 tree)
