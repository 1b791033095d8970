"""BAFDP federated-training hyper-parameters (paper Eq. 15-22, Section V).

A copy of ``FedConfig`` from the JAX package's ``configs/base.py``, kept
here so the port imports nothing of the reference.  Field names, defaults
and validation are the reference's; the knobs whose code this package
does not carry yet are rejected by the round (``core/bafdp.py``), never
silently ignored.
"""
from __future__ import annotations

import dataclasses


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
