"""Config dataclasses, copied from the JAX package's ``configs/base.py``
so the port imports nothing of the reference.

* :class:`ArchConfig` — a transformer-family architecture (dense / moe /
  ssm / hybrid / vlm / audio), with the block-kind and FFN constants,
  :class:`MoEConfig` and ``round_up``.  The port serves the ATTN/SWA
  blocks with a dense FFN; the model rejects the other kinds by name.
* :class:`InputShape` and the four workload shapes ``INPUT_SHAPES``.
* :class:`FedConfig` — the BAFDP federated-training hyper-parameters.

Field names, defaults and validation are the reference's; the knobs whose
code this package does not carry yet are rejected where they are read
(``core/bafdp.py``, ``models/transformer.py``), never silently ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds that can appear in a stack.
ATTN = "attn"            # GQA full attention
SWA = "swa"              # sliding-window attention
MAMBA = "mamba"          # selective-scan SSM block
MLSTM = "mlstm"          # xLSTM matrix-LSTM block
SLSTM = "slstm"          # xLSTM scalar-LSTM block
HYMBA = "hymba"          # parallel attention + mamba heads (fused block)

FFN_DENSE = "dense"      # SwiGLU / GeGLU / vanilla
FFN_MOE = "moe"
FFN_NONE = "none"


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    block_kind: str = ATTN         # primary mixer kind
    block_pattern: Tuple[str, ...] = ()   # overrides block_kind per layer if set
    ffn_kind: str = FFN_DENSE
    ffn_act: str = "swiglu"        # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    moe_impl: str = "scatter"      # scatter | einsum
    moe_group_shard: bool = False  # pin MoE token groups to the model axis
    attn_seq_shards: int = 0       # >0: sequence-parallel attention shards
    ssm_state: int = 0             # SSM state size (mamba / hymba)
    mlstm_heads: int = 0           # heads for mLSTM blocks
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # encoder-decoder (seamless): n_enc_layers>0 enables the encoder stack
    n_enc_layers: int = 0
    # multimodal stub frontend: number of prefix embedding positions
    frontend: str = "none"         # none | vision | audio
    frontend_tokens: int = 0       # patch / frame positions provided by the stub
    sliding_window: int = 0        # 0 = full attention; >0 = window size option
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # distribution
    fed_mode: str = "A"            # A = clients on "data" axis, B = pod silos
    remat: bool = True             # activation checkpointing per block
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so the embedding/LM-head shards cleanly 16-ways."""
        return round_up(self.vocab_size, 256)

    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.n_layers
            return self.block_pattern
        return tuple([self.block_kind] * self.n_layers)

    def n_params(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.resolved_head_dim
        per_layer = 0
        counts = {}
        for kind in self.pattern():
            counts[kind] = counts.get(kind, 0) + 1
        for kind, n in counts.items():
            if kind in (ATTN, SWA):
                qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                per_layer += n * (qkv + o + d)
            elif kind == MAMBA:
                d_in = 2 * d
                per_layer += n * (d * 2 * d_in + d_in * 2 * self.ssm_state
                                  + d_in * 2 + d_in * d + d)
            elif kind == MLSTM:
                heads = self.mlstm_heads or self.n_heads
                d_in = 2 * d
                per_layer += n * (3 * d * d_in + 2 * d * heads + d_in * d + d)
            elif kind == SLSTM:
                per_layer += n * (4 * d * d + 4 * d + d * d + d)
            elif kind == HYMBA:
                qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                d_in = d
                mamba = d * 2 * d_in + d_in * 2 * self.ssm_state + d_in * 2
                per_layer += n * (qkv + mamba + (self.n_heads * hd + d_in) * d + d)
        n_ffn_layers = self.n_layers if self.ffn_kind != FFN_NONE else 0
        if self.ffn_kind == FFN_DENSE and self.d_ff:
            mult = 3 if self.ffn_act in ("swiglu", "geglu") else 2
            per_layer += n_ffn_layers * (mult * d * self.d_ff + d)
        elif self.ffn_kind == FFN_MOE:
            assert self.moe is not None
            e = self.moe.n_experts
            per_layer += n_ffn_layers * (d * e + e * 3 * d * self.d_ff + d)
        emb = self.padded_vocab * d
        head = 0 if self.tie_embeddings else self.padded_vocab * d
        enc = 0
        if self.n_enc_layers:
            qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            mult = 3 if self.ffn_act in ("swiglu", "geglu") else 2
            enc = self.n_enc_layers * (qkv + o + mult * d * self.d_ff + 2 * d)
            per_layer += self.n_layers * (qkv + o + d)  # decoder cross-attn
        return per_layer + emb + head + enc + d

    def n_active_params(self) -> int:
        """Active parameters per token (MoE uses top_k of n_experts)."""
        if self.ffn_kind != FFN_MOE:
            return self.n_params()
        assert self.moe is not None
        total = self.n_params()
        e, k = self.moe.n_experts, self.moe.top_k
        expert_p = self.n_layers * e * 3 * self.d_model * self.d_ff
        active_p = self.n_layers * k * 3 * self.d_model * self.d_ff
        return total - expert_p + active_p


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """BAFDP hyper-parameters (paper Eq. 15-22 and Section V)."""
    n_clients: int = 10            # M + B
    byzantine_frac: float = 0.0    # B / (M + B)
    attack: str = "gaussian"       # byzantine attack kind
    attack_scale: float = 10.0     # magnitude of the message-level attacks
    traffic_shift_steps: int = 6   # window roll of the traffic_shift attack
    active_frac: float = 0.6       # S / M per round (asynchrony)
    # internal sampler policy when no external schedule supplies the
    # active set: "uniform" draws S-of-M uniformly; "age_aware" admits
    # clients whose age reached internal_age_threshold first.
    internal_select: str = "uniform"       # uniform | age_aware
    internal_age_threshold: float = 0.0    # 0 -> 2 * ceil(C / S)
    # privacy
    privacy_budget_a: float = 30.0     # per-round upper bound on eps (Eq. 3)
    dp_delta: float = 1e-5
    dp_sensitivity: float = 1.0        # Delta in c3
    confidence_gamma: float = 0.05     # uncertainty-set confidence 1-gamma
    wasserstein_beta: float = 2.0      # light-tail exponent (Assumption 1)
    eps_min: float = 1e-2
    eps_init_frac: float = 0.5         # eps_i^0 = frac * a
    # DRO regularizer scale: rho_eff = dro_weight * (eta + c3/eps)
    dro_weight: float = 1.0
    # robustness / consensus
    psi: float = 5e-3                  # L1 consensus penalty weight
    lipschitz_surrogate: str = "spectral"  # spectral | frobenius
    # step sizes (Theorem 1 names)
    alpha_w: float = 1e-2
    alpha_eps: float = 1e-3
    alpha_z: float = 1e-2
    alpha_lambda: float = 1e-3
    alpha_phi: float = 1e-3
    reg_decay_pow: float = 0.25        # a^t = 1/(alpha (t+1)^pow)
    grad_clip: float = 0.0             # per-client global-norm clip (0 = off)
    omega_optimizer: str = "sgd"       # sgd (Eq. 18) | adam (Sec. V-D)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    # staleness decay s(d) of the Eq. (20) sign sum and Eq. (22) dual step:
    #   constant: 1;  hinge: 1 if d <= b else 1/(a (d - b) + 1);
    #   poly: (d + 1)^-a
    staleness_decay: str = "constant"   # constant | hinge | poly
    staleness_hinge_a: float = 10.0
    staleness_hinge_b: float = 4.0
    staleness_poly_a: float = 0.5
    # DC-ASGD-style Taylor compensation of stale messages:
    #   w~_i = w_i - alpha_w * compensation_scale * min(d, clip) * comp_i
    staleness_compensation: str = "none"   # none | taylor
    compensation_beta: float = 0.9         # EWMA rate of the momentum proxy
    compensation_scale: float = 1.0        # scale on the Taylor term
    compensation_clip: float = 10.0        # max extrapolated rounds
    compensation_scale_mode: str = "global"    # global | per_client
    compensation_ref: float = 1.0              # rms damping reference
    consensus_scope: str = "all"   # all | active
    robust_consensus: str = "none"   # none|trimmed_mean|median|krum|centered_clip
    robust_trim_frac: float = 0.2
    robust_clip_tau: float = 10.0
    robust_clip_iters: int = 3
    # FedBuff server-side LR normalization: scale the z step by K/C
    fedbuff_lr_norm: bool = False
    local_steps: int = 1           # K local steps between consensus rounds
    # wire format of the Eq. (20) sign message: f32, or an int8 payload
    # (the sign) plus one f32 scale per client — lossless
    sign_message: str = "f32"      # f32 | int8
    compress_signs: bool = False   # deprecated alias for sign_message="int8"
    # wire format of the Eq. (22) dual message: f32, or absmax int8
    # (lossy, error <= absmax * 0.5/127 per coordinate)
    dual_message: str = "f32"      # f32 | int8
    consensus_streaming: bool = False
    consensus_chunk: int = 8       # rows per streamed chunk (>= 1)

    @property
    def resolved_dual_message(self) -> str:
        """Validated Eq. (22) dual wire format (no deprecated alias)."""
        if self.dual_message not in ("f32", "int8"):
            raise ValueError(
                f"unknown dual_message: {self.dual_message!r} "
                "(expected 'f32' or 'int8')")
        return self.dual_message

    @property
    def resolved_sign_message(self) -> str:
        """The effective wire format after the deprecated ``compress_signs``
        alias is folded in (the alias takes precedence)."""
        if self.sign_message not in ("f32", "int8"):
            raise ValueError(
                f"unknown sign_message: {self.sign_message!r} "
                "(expected 'f32' or 'int8')")
        if self.compress_signs:
            return "int8"
        return self.sign_message

    @property
    def n_byzantine(self) -> int:
        return int(round(self.n_clients * self.byzantine_frac))

    @property
    def n_normal(self) -> int:
        return self.n_clients - self.n_byzantine
