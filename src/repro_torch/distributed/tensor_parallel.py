"""Tensor-parallel serving over a mesh's ``"model"`` axis: one program per
rank, standing in for what GSPMD derives from the reference's plan.

The reference places every parameter leaf by ``make_plan(cfg, mesh)``
(``distributed/sharding.greedy_spec``) and the decode cache by
``decode_state_specs``, and lets XLA insert the exchanges.  The port runs
the same placements as one program per rank: a rank holds its block of
every leaf (``sharding.local_tree(sharding.place_tree(...))``'s values;
``transformer.init_lm`` with :func:`keep_blocks` draws them) and every
product reads its weight's
``PartitionSpec`` (never the family's name) to decide what it exchanges:

* **column-parallel**, a weight split on its output (last) dim: the local
  product is the output's column block;
* **row-parallel**, a weight split on its input dim: the input's matching
  column block times the local rows, summed over ``"model"``
  (:func:`reduce_sum`);
* **replicated**: the product as at world 1;
* **gather at use**, a leaf whose placement fits neither (an RMSNorm
  scale the plan splits on d, LLaVA's ``frontend_proj``): the leaf
  all-gathered where it is used (:func:`gather_leaf`);
* **vocab-parallel embedding** (``embed["tok"]`` split on the
  vocabulary): each rank looks up the tokens of its block, zeros
  elsewhere, then the sum over ``"model"``: one non-zero term a row, so
  world 1's bits (:func:`embed_rows`);
* **vocab-parallel logits**: the tied ``tok.t()`` or an untied ``head``
  gives the rank its vocabulary block of the logits, the reference's out
  spec ``P(row, None, "model")``.

The attention layers (``models/attention.py``) build on these: B4 on a
rank's heads where its blocks of ``wq``/``wk``/``wv`` are whole heads and
its query heads use only its KV heads, else on every head after a gather;
B4 on a rank's block of queries under ``attn_seq_shards``; at decode B5's
partial over the rank's block of cache positions, the ranks' (out, lse)
gathered and merged in rank order; cross-attention on a rank's heads (B4
without the mask over the encoder's memory, or B5 whole over it).  The
Mamba mixer (``models/ssm.py``) runs on a rank's block of its ``d_in``
channels (:func:`channels`, :func:`leaf_block`): B6 on them, ``x_proj``
and ``out_proj`` row-parallel sums, its decode state the rank's channels.
The mLSTM runs on the rank's block of each head's v rows (where the plan
puts its state ``C``), the sLSTM on the rank's channels of each of its
four gates (:func:`chunk_channels`), the MoE FFN on the rank's experts
(:func:`experts`) or on its block of ``d_ff`` (``models/moe.py``).

The rank's place travels as ``ranks=`` (a ``data_parallel.RankBlock``
whose ``specs`` are the plan's specs of the parameters at hand).  A
row-parallel product of a half type forms each rank's term in f32, sums
the terms in f32 and rounds once after the sum, as world 1's product
rounds once; a gather travels in the tensor's own dtype (exact).  Every
exchange is a ``distributed.collectives`` call, counted per axis.  World
1 (no ``ranks``, or a ``"model"`` axis of one device) runs the same
layer functions: :func:`at` gives them None, and with None every helper
here is world 1's op (the product ``x @ w``, the leaf as it is, no
exchange).

Every family serves this way.  What still raises ``NotImplementedError``
names its ROADMAP item: training under the plan's ``"model"`` placements
(:data:`STEP3C`), a dim split over ``"model"`` together with another
axis or a decode state split off the dims a layer computes on
(:data:`STEP3D`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.distributed import collectives
from repro_torch.distributed.data_parallel import RankBlock, rank_block
from repro_torch.distributed.sharding import map_leaves

STEP3C = ("ROADMAP Queue A 7(b) step 3c (training under the default plan's "
          "'model' placements)")
STEP3D = ("ROADMAP Queue A 7(b) step 3d (mode B's FSDP over a real 'data' "
          "axis, long_500k's head_dim split)")
Q_CHUNK = 256          # the reference's query chunk (models/attention.py)
_HALF = (torch.bfloat16, torch.float16)


def split(ranks: Optional[RankBlock]) -> bool:
    """Whether a serving step runs over several ranks at all: its rows
    over ``"data"``, its layers over ``"model"``, or both."""
    return ranks is not None and ranks.specs is not None and ranks.world > 1


def active(ranks: Optional[RankBlock]) -> bool:
    """Whether a serving step runs tensor-parallel: a block with specs over
    a ``"model"`` axis of more than one rank."""
    return (ranks is not None and ranks.specs is not None
            and ranks.model.size > 1)


def at(ranks: Optional[RankBlock], *keys) -> Optional[RankBlock]:
    """``ranks`` narrowed to the specs of a sub-tree of the params
    (``at(ranks, "layers", 3, "attn")``), or None where the step does not
    run tensor-parallel: every function below then runs world 1's ops."""
    return ranks.at(*keys) if active(ranks) else None


def split_at(ranks: Optional[RankBlock], *keys) -> Optional[RankBlock]:
    """:func:`at` for a layer that couples the batch's rows (the MoE's
    capacity): the block wherever the step is :func:`split`, a ``"data"``
    axis of several ranks alone included; None at world 1."""
    return ranks.at(*keys) if split(ranks) else None


def layer(ranks: Optional[RankBlock], i: int) -> Optional[RankBlock]:
    """Layer ``i``'s block: its parameter specs and, where the block
    carries the decode state's, the layer's state specs (None at world
    1; over ``"data"`` alone, a block whose sub-layers :func:`at` gives
    None but :func:`split_at` does not)."""
    r = split_at(ranks, "layers", i)
    if r is None or ranks.state_specs is None:
        return r
    return dataclasses.replace(r, state_specs=ranks.state_specs["layers"][i])


def at_state(ranks: Optional[RankBlock], key: str) -> Optional[RankBlock]:
    """:func:`at` of ``key`` with the layer's state specs narrowed to the
    state's ``key`` too (a Mamba mixer's ``h`` and ``conv``)."""
    r = at(ranks, key)
    if r is None or r.state_specs is None:
        return r
    return dataclasses.replace(r, state_specs=r.state_specs[key])


def spec(ranks: Optional[RankBlock], name: str):
    """The ``PartitionSpec`` of the leaf ``name`` of the sub-tree at hand,
    or None (world 1)."""
    return ranks.specs[name] if active(ranks) else None


def state_spec(ranks: Optional[RankBlock], name: str):
    """The spec of the decode-state leaf ``name`` of the layer at hand, or
    None."""
    return ranks.state_specs[name] if active(ranks) else None


def _axes(entry) -> tuple:
    return entry if isinstance(entry, tuple) else (entry,)


def model_dim(spec, ranks: Optional[RankBlock]) -> Optional[int]:
    """The dim of a leaf that ``spec`` splits over a ``"model"`` axis of
    more than one rank, or None (always at world 1)."""
    if spec is None or ranks is None or ranks.model.size == 1:
        return None
    for d, entry in enumerate(spec):
        if entry is not None and "model" in _axes(entry):
            return d
    return None


def _axis_of(entry, ranks: RankBlock):
    axes = _axes(entry)
    if axes == ("model",):
        return ranks.model
    if "model" in axes:
        raise NotImplementedError(f"a dim split over {entry}: {STEP3D}")
    return ranks.data                   # "data", or ("pod", "data")


def block(t: torch.Tensor, spec, ranks: RankBlock) -> torch.Tensor:
    """This rank's block of a whole leaf ``t`` under ``spec``: each split
    dim narrowed to the rank's index on its axis (``"model"``, or the
    data axis, pod-major with a ``"pod"`` axis), as
    ``sharding.place_tree`` takes it: a view."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axis = _axis_of(entry, ranks)
        if axis.size > 1:
            n = t.shape[d] // axis.size
            t = t.narrow(d, axis.rank * n, n)
    return t


def block_shape(shape, spec, ranks: RankBlock) -> tuple:
    """The shape of this rank's block of a leaf of ``shape``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            axis = _axis_of(entry, ranks)
            if out[d] % axis.size:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"over {axis.size} {axis.name} ranks")
            out[d] //= axis.size
    return tuple(out)


def local_zeros(tree, specs, ranks: RankBlock, device) -> Any:
    """Zeros of this rank's block shape for every leaf of ``tree`` (meta
    tensors: shapes and dtypes), on ``device``: a decode state made at
    the rank's size, never whole."""
    return map_leaves(lambda t, s: torch.zeros(
        block_shape(t.shape, s, ranks), dtype=t.dtype, device=device),
        tree, specs)


def keep_blocks(ranks: RankBlock, device):
    """The ``keep`` hook of ``transformer.init_lm`` for this rank: each
    sub-tree, drawn whole, gives up its leaves' blocks (``ranks.specs``
    at its path), copied out to ``device``, and the whole leaves go, so
    the rank's peak is its blocks plus one sub-tree's leaves."""
    def keep(tree, *path):
        def one(t, s):
            b = block(t, s, ranks)
            return torch.empty(b.shape, dtype=b.dtype,
                               device=device).copy_(b)
        return map_leaves(one, tree, ranks.at(*path).specs)
    return keep


def serve_block(mesh, batch: int, specs, state_specs=None) -> RankBlock:
    """This rank's :class:`RankBlock` for serving ``batch`` rows on
    ``mesh``: the rows split over ``"data"``, ``specs`` the per-layer
    parameter specs (``launch.steps.serving_specs``)."""
    return dataclasses.replace(rank_block(mesh, batch), specs=specs,
                               state_specs=state_specs)


# ---------------------------------------------------------------------------
# exchanges (the identity at world 1)
def reduce_sum(t: torch.Tensor, ranks: Optional[RankBlock]) -> torch.Tensor:
    """``t`` summed over ``"model"`` (every rank the same bits).  A half
    type travels in f32 and is rounded once after the sum."""
    if ranks is None:
        return t
    if t.dtype in _HALF:
        wide = t.float()
        collectives.all_reduce_sum(wide, ranks.model)
        return wide.to(t.dtype)
    return collectives.all_reduce_sum(t.contiguous(), ranks.model)


def gather(t: torch.Tensor, ranks: Optional[RankBlock], dim: int
           ) -> torch.Tensor:
    """The ranks' blocks of ``t`` concatenated along ``dim`` in rank
    order."""
    if ranks is None:
        return t
    return collectives.all_gather(t, ranks.model, dim)


def gather_rows(t: torch.Tensor, ranks: Optional[RankBlock]) -> torch.Tensor:
    """The ``"data"`` ranks' rows of ``t`` (dim 0) concatenated in rank
    order: the whole batch's, on every rank."""
    if ranks is None:
        return t
    return collectives.all_gather(t, ranks.data, 0)


def gather_leaf(w: torch.Tensor, spec, ranks: Optional[RankBlock]
                ) -> torch.Tensor:
    """A leaf whole where it is used: all-gathered along its split dim,
    or as it is."""
    d = model_dim(spec, ranks)
    return w if d is None else gather(w, ranks, d)


def channels(t: torch.Tensor, ranks: Optional[RankBlock], dim: int = -1
             ) -> torch.Tensor:
    """This rank's contiguous block of dim ``dim`` of a whole ``t`` (a
    view), or ``t`` at world 1.  The dim must split evenly over
    ``"model"``."""
    if ranks is None:
        return t
    n = t.shape[dim]
    if n % ranks.model.size:
        raise ValueError(f"{n} channels do not split over "
                         f"{ranks.model.size} 'model' ranks")
    m = n // ranks.model.size
    return t.narrow(dim, ranks.model.rank * m, m)


def chunk_channels(t: torch.Tensor, k: int, ranks: Optional[RankBlock],
                   dim: int = -1) -> torch.Tensor:
    """This rank's channels of each of the ``k`` equal chunks of dim
    ``dim`` of a whole ``t``, concatenated in chunk order (the sLSTM's
    z|i|f|o gates: a rank's d-channels of each), or ``t`` at world 1."""
    if ranks is None:
        return t
    return torch.cat([channels(c, ranks, dim) for c in t.chunk(k, dim)],
                     dim=dim)


def model_block(t: torch.Tensor, spec, ranks: Optional[RankBlock]
                ) -> torch.Tensor:
    """The inverse of :func:`gather_leaf`: a whole ``t`` narrowed to this
    rank's block along the dim ``spec`` splits over ``"model"`` (``t``
    where it splits none)."""
    d = model_dim(spec, ranks)
    return t if d is None else channels(t, ranks, d)


def experts(spec, ranks: Optional[RankBlock], n: int) -> tuple:
    """``(e0, e1)``: the experts ``[e0, e1)`` this rank holds of an expert
    leaf (its experts on dim 0) that ``spec`` places, all ``n`` where it
    is not split on them."""
    if model_dim(spec, ranks) != 0:
        return 0, n
    per = n // ranks.model.size
    return ranks.model.rank * per, (ranks.model.rank + 1) * per


def leaf_block(w: torch.Tensor, spec, ranks: Optional[RankBlock],
               dim: int = -1) -> torch.Tensor:
    """This rank's block of a leaf along ``dim``: the leaf as the rank
    holds it where the plan splits it there, else its block of the leaf
    gathered whole at use (``w`` at world 1)."""
    if ranks is None or model_dim(spec, ranks) == dim % w.ndim:
        return w
    return channels(gather_leaf(w, spec, ranks), ranks, dim)


# ---------------------------------------------------------------------------
# products
def _partial(xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A rank's term of a row-parallel product, ``xb @ w`` with ``w`` in
    ``xb``'s dtype (as world 1's product casts it): in f32 for a half
    type, so that the sum over ranks rounds to it once, as world 1's
    product does (a half-precision term would round before the sum too);
    in ``xb``'s dtype otherwise.  The weight is rounded to the half type
    before it widens: an f32 leaf used as it is would move ~40 % of a
    bf16 output off world 1's bits (and flip an MoE's routing at gaps
    far from a tie)."""
    w = w.to(xb.dtype)
    if xb.dtype in _HALF:
        return xb.float() @ w.float()
    return xb @ w


def _row_sum(xb: torch.Tensor, w: torch.Tensor, ranks: RankBlock
             ) -> torch.Tensor:
    return reduce_sum(_partial(xb, w), ranks).to(xb.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, spec,
           ranks: Optional[RankBlock]) -> torch.Tensor:
    """``x @ w`` (w in x's dtype), whole on every rank: column-parallel
    (the local product's columns gathered), row-parallel (x's matching
    columns times the local rows, summed) or replicated (world 1's
    product)."""
    d = model_dim(spec, ranks)
    if d is None:
        return x @ w.to(x.dtype)
    if d == w.ndim - 1:
        return gather(x @ w.to(x.dtype), ranks, -1)
    return _row_sum(channels(x, ranks), w, ranks)


def linear_cols(x: torch.Tensor, w: torch.Tensor, spec,
                ranks: Optional[RankBlock]) -> torch.Tensor:
    """This rank's column block of ``x @ w``: the local product where
    ``w`` is split on its output dim (no exchange), else the block of
    :func:`linear`'s whole product (all of it at world 1)."""
    if model_dim(spec, ranks) == w.ndim - 1:
        return x @ w.to(x.dtype)
    return channels(linear(x, w, spec, ranks), ranks)


def linear_from_block(xb: torch.Tensor, w: torch.Tensor, spec,
                      ranks: Optional[RankBlock]) -> torch.Tensor:
    """``x @ w`` whole on every rank from ``xb``, this rank's column block
    of ``x``: row-parallel where ``w`` is split on its input dim (the
    local product, summed), else ``x`` gathered first (at world 1, ``xb``
    is ``x``: world 1's product)."""
    if model_dim(spec, ranks) == 0:
        return _row_sum(xb, w, ranks)
    return linear(gather(xb, ranks, -1), w, spec, ranks)


def embed_rows(tok: torch.Tensor, spec, tokens: torch.Tensor,
               ranks: Optional[RankBlock]) -> torch.Tensor:
    """``tok[tokens]`` whole on every rank from this rank's block of the
    table.  Split on the vocabulary: the rank's tokens looked up, zeros
    for the others, summed over ``"model"`` (one non-zero term a row:
    world 1's bits).  Split otherwise: gathered at use."""
    d = model_dim(spec, ranks)
    if d != 0:
        return gather_leaf(tok, spec, ranks)[tokens]
    n = tok.shape[0]
    local = tokens - ranks.model.rank * n
    mine = (local >= 0) & (local < n)
    rows = tok[local.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return reduce_sum(rows, ranks)


# ---------------------------------------------------------------------------
# sequence-parallel prefill attention (``attn_seq_shards``)
def seq_blocks(cfg, S: int, ranks: Optional[RankBlock]) -> int:
    """The blocks of queries a prefill of ``S`` positions splits into over
    ``"model"`` under ``cfg.attn_seq_shards``, or 0.  The reference's
    trigger (``models/attention.py``): ``S > Q_CHUNK`` and ``seq_shards >
    1`` with the query chunks (``bq`` = ``min(Q_CHUNK, S)``, else the
    largest divisor of S below it) a multiple of ``seq_shards``; its
    split: over the mesh's ``"model"`` size, in contiguous blocks, which
    must divide the chunks (``ValueError`` otherwise, where the
    reference's ``shard_map`` fails)."""
    if not active(ranks) or cfg.attn_seq_shards <= 1 or S <= Q_CHUNK:
        return 0
    bq = min(Q_CHUNK, S)
    if S % bq:
        bq = max(d for d in range(1, bq + 1) if S % d == 0)
    n_chunks = S // bq
    if n_chunks % cfg.attn_seq_shards:
        return 0
    M = ranks.model.size
    if n_chunks % M:
        raise ValueError(f"attn_seq_shards: {n_chunks} query chunks of {bq} "
                         f"do not split over {M} 'model' ranks")
    return M


