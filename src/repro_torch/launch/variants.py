"""Named hillclimb / beyond-paper variants: a copy of the JAX package's
``launch/variants.py`` (the hypotheses' numbers are the reference's TPU
dry-run predictions, kept as its text).

Each variant maps (cfg, fed, setup kwargs) -> modified versions.
``launch.train --variant <name>`` applies only the ``cfg_patch``, as the
reference's launcher does: ``fed_patch`` and ``inner_dp`` are read by the
dry-run alone (``launch.dryrun``, as the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig, FedConfig


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    hypothesis: str
    cfg_patch: dict = dataclasses.field(default_factory=dict)
    fed_patch: dict = dataclasses.field(default_factory=dict)
    inner_dp: bool = False

    def apply(self, cfg: ArchConfig,
              fed: Optional[FedConfig] = None
              ) -> Tuple[ArchConfig, Optional[FedConfig], dict]:
        cfg2 = dataclasses.replace(cfg, **self.cfg_patch) if self.cfg_patch \
            else cfg
        fed2 = fed
        if self.fed_patch:
            fed2 = dataclasses.replace(fed or FedConfig(), **self.fed_patch)
        return cfg2, fed2, {"inner_dp": self.inner_dp}


VARIANTS: Dict[str, Variant] = {v.name: v for v in [
    # --- pair A: smollm-360m x train_4k (paper-representative mode A) ---
    Variant(
        name="inner_dp",
        hypothesis="per-client TP all-reduces (65 GB/dev/step) vanish if "
                   "each client's 1.45 GB weights are replicated over the "
                   "model axis and its batch is data-parallel there; "
                   "predict collective 1410ms -> <100ms and compute "
                   "859ms -> ~100ms (attention no longer replicated).",
        inner_dp=True),
    Variant(
        name="inner_dp+signs8",
        hypothesis="on top of inner_dp, the BAFDP consensus all-reduce "
                   "carries int8 signs (4x fewer bytes on the z-sized "
                   "tensor); predict a further ~20ms collective cut.",
        inner_dp=True,
        fed_patch={"sign_message": "int8"}),
    Variant(
        name="inner_dp+signs8+k4",
        hypothesis="consensus every K=4 rounds (DiLoCo-style local steps) "
                   "amortizes the sign collective 4x at the cost of "
                   "staler consensus; collective term drops by ~the sign "
                   "share.  REFUTED as a jnp.where mask (collective still "
                   "emitted); superseded by the structural off-round "
                   "program below.",
        inner_dp=True,
        fed_patch={"sign_message": "int8", "local_steps": 4}),
    Variant(
        name="inner_dp+offround",
        hypothesis="the structurally consensus-free off-round program: no "
                   "sign all-reduce at all; with K=4 the amortized "
                   "collective is (1*consensus + 3*offround)/4.",
        inner_dp=True,
        fed_patch={"sign_message": "int8", "local_steps": 0}),
    Variant(
        name="inner_dp+signs8+noremat",
        hypothesis="with inner-DP the temp footprint fell to 1.4 GB, so "
                   "activation checkpointing (1.33x recompute) is no "
                   "longer needed; predict compute 105.7 -> ~75ms at "
                   "~+7 GB temp.",
        inner_dp=True,
        cfg_patch={"remat": False},
        fed_patch={"sign_message": "int8"}),
    # --- pair B: granite-moe x train_4k (most collective-bound) ---
    Variant(
        name="einsum_moe",
        hypothesis="the scatter-dispatch forces ~1 TB/dev of all-reduce "
                   "over the (E*C,d) capacity buffer; grouped one-hot "
                   "einsum dispatch partitions on the group axis with no "
                   "cross-device traffic; predict collective 20.8s -> "
                   "<1.5s at +~0.1s dispatch-matmul compute.",
        cfg_patch={"moe_impl": "einsum"}),
    Variant(
        name="einsum_moe_gshard",
        hypothesis="REVISED after einsum_moe was refuted (collective "
                   "20.8->21.6s): the TB of all-reduce is the row-parallel "
                   "expert FFN psum over the k*cf=10x-inflated capacity "
                   "buffer, not the dispatch.  Pinning the group axis to "
                   "'model' keeps expert compute local; XLA gathers the "
                   "377 MB/layer expert weights + ~0.4 GB/layer activation "
                   "regathers instead; predict collective -> ~2-6s.",
        cfg_patch={"moe_impl": "einsum", "moe_group_shard": True}),
    Variant(
        name="einsum_moe+signs8",
        hypothesis="einsum MoE + int8 sign consensus.",
        cfg_patch={"moe_impl": "einsum"},
        fed_patch={"sign_message": "int8"}),
    # --- pair C: phi3-medium x prefill_32k (worst useful ratio) ---
    Variant(
        name="seqpar16",
        hypothesis="40 heads don't divide the 16-way model axis, so "
                   "attention compute is replicated 16x (useful 0.008); "
                   "sequence-parallel query sharding partitions the S^2 "
                   "work spatially; predict compute 75.5s -> ~8s with "
                   "+~0.3s of k/v gathers.",
        cfg_patch={"attn_seq_shards": 16}),
]}
# note: sequence-parallel attention is restricted to prefill/forward paths;
# mode-A training vmaps over clients and shard_map-under-vmap is not a
# supported composition — the train-shape variant was removed.


def get_variant(name: str) -> Variant:
    return VARIANTS[name]
