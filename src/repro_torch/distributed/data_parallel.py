"""One rank's share of a federated round on a mesh of several devices.

The reference runs a round over a (``"data"``, ``"model"``) mesh through
GSPMD: mode A puts the clients on ``"data"``, and under ``inner_dp`` a
client's weights are replicated over ``"model"`` while its batch is split
there.  The port runs the same round as one program per rank:

* each ``"data"`` rank holds the clients ``[c0, c1)`` of an even split of
  C (their rows of every per-client leaf, ``fed_state.shard_clients``),
  the consensus ``z`` and the round counter whole;
* under ``inner_dp`` each ``"model"`` rank of a data rank takes its rows
  of every client's batch (:meth:`RankBlock.batch_rows`), and the loss and
  every gradient leaf are all-reduced over ``"model"`` before the step;
* every cross-client quantity of the round is a local sum plus
  ``collectives.all_reduce_sum`` over ``"data"``: the dual mean, the
  Eq. (20) sign sums (B1-B3 split into a partial and a finish), the
  ``alie`` moments, the metrics.

:class:`RankBlock` holds what a rank needs for that: the two groups, the
client range and the batch rows.  A world of one rank is today's program:
the round functions take ``ranks=None`` (or a one-rank block) and run
their fused path.

A serving step over the mesh (``distributed/tensor_parallel.py``) takes
the same block: its rows are the batch's (``n_clients`` is the batch,
split over ``"data"``), its ``"model"`` ranks split the weights and the
decode cache as the plan places them, and ``specs`` carries the plan's
specs of the parameters it holds blocks of (:meth:`RankBlock.at` walks
them beside the parameters), ``state_specs`` those of the decode state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its process group (None for
    one rank, or where nothing is sent: a dry-run on ``meta``), its size,
    this rank's index on it, and the distance between neighbours of the
    group in the mesh's row-major rank order (the link model's span,
    ``roofline.kernel_cost.span_nodes``)."""
    name: str
    group: Any
    size: int
    rank: int
    stride: int


@dataclasses.dataclass(frozen=True)
class RankBlock:
    """This rank's clients and batch rows.  ``data``: the clients' axis
    (C split evenly over it); ``model``: the axis a client's batch is
    split over (``inner_dp``; size 1 without it); ``batch``: ``(b, start,
    rows, weight)`` of a split batch (:meth:`with_batch`), None
    otherwise.  For a serving step, ``n_clients`` is the batch's rows,
    ``model`` the axis the tensor-parallel layers split, ``specs`` the
    ``PartitionSpec`` subtree of the parameters at hand (:meth:`at`) and
    ``state_specs`` that of the decode state (or of one layer's)."""
    data: Axis
    model: Axis
    n_clients: int
    batch: Optional[Tuple[int, int, int, float]] = None
    specs: Any = None
    state_specs: Any = None

    def __post_init__(self):
        if self.n_clients % self.data.size:
            raise ValueError(f"{self.n_clients} clients (or rows) do not "
                             f"split evenly over {self.data.size} data "
                             "ranks")

    def at(self, *keys) -> "RankBlock":
        """This block with ``specs`` narrowed to ``specs[k0][k1]...``: the
        specs of a sub-tree of the parameters (``at("layers", 3,
        "attn")``)."""
        specs = self.specs
        for k in keys:
            specs = specs[k]
        return dataclasses.replace(self, specs=specs)

    @property
    def world(self) -> int:
        return self.data.size * self.model.size

    @property
    def rows(self) -> int:
        """This rank's clients: ``C / data ranks``."""
        return self.n_clients // self.data.size

    @property
    def c0(self) -> int:
        return self.data.rank * self.rows

    @property
    def c1(self) -> int:
        return self.c0 + self.rows

    def clients(self) -> slice:
        return slice(self.c0, self.c1)

    def batch_rows(self, b: int) -> Tuple[int, int, float]:
        """``(start, rows, weight)`` of this ``"model"`` rank's part of a
        client's batch of ``b`` rows: an even split (``b / M`` rows,
        weight ``1 / M``); where ``b < M`` and ``M % b == 0``, one row
        each for the first ``b`` ranks (weight ``1 / b``) and, for the
        others, row 0 at weight 0 (they run it so that every rank joins
        the all-reduce and draws alike).  Any other split raises."""
        M, m = self.model.size, self.model.rank
        if M == 1:
            return 0, b, 1.0
        if b % M == 0:
            q = b // M
            return m * q, q, 1.0 / M
        if M % b == 0:
            return (m, 1, 1.0 / b) if m < b else (0, 1, 0.0)
        raise ValueError(f"a batch of {b} rows does not split over "
                         f"{M} 'model' ranks")

    def with_batch(self, b: int) -> "RankBlock":
        """This block with a client's batch of ``b`` rows split over
        ``"model"``."""
        start, rows, weight = self.batch_rows(b)
        return dataclasses.replace(self, batch=(b, start, rows, weight))

    @property
    def batch_weight(self) -> float:
        return 1.0 if self.batch is None else self.batch[3]


def is_split(ranks: Optional[RankBlock]) -> bool:
    """Whether a round runs the split path: a group of more than one
    rank.  ``None`` and a one-rank block run today's fused path."""
    return ranks is not None and ranks.world > 1


def rank_block(mesh, n_clients: int) -> RankBlock:
    """This rank's :class:`RankBlock` on ``mesh`` (a ``DeviceMesh`` with
    the axes ``("data", "model")`` or ``("pod", "data", "model")``): the
    clients on ``"data"`` (with ``"pod"``, on the two together, pod
    major), the batch on ``"model"``.  A pod axis gets no group of its
    own: such a mesh runs only on ``meta`` (the dry-run), where nothing is
    sent."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    if "data" not in sizes:
        raise ValueError(f"mesh axes {names} have no 'data' axis")
    M = sizes.get("model", 1)
    coord = dict(zip(names, mesh.get_coordinate()))
    data_names = [n for n in ("pod", "data") if n in sizes]
    R = math.prod(sizes[n] for n in data_names)
    data_rank = 0
    for n in data_names:
        data_rank = data_rank * sizes[n] + coord[n]
    data_group = None
    if R > 1 and data_names == ["data"]:
        data_group = mesh.get_group("data")
    model_group = mesh.get_group("model") if M > 1 else None
    return RankBlock(
        data=Axis("data", data_group, R, data_rank, M),
        model=Axis("model", model_group, M, coord.get("model", 0), 1),
        n_clients=n_clients)
