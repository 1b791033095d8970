"""Recurrent mixers: the Mamba selective scan and xLSTM's mLSTM and
sLSTM (the port of the JAX package's ``models/ssm.py``).

Mamba.  Prefill (``mamba_scan``) keeps the reference's loop over chunks of
``MAMBA_CHUNK`` steps with the state ``h`` carried from one chunk to the
next; inside a chunk the recurrence ``h_t = a_t * h_{t-1} + b_t`` goes
through ``ops.ssm_scan`` (B6: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors), with the carried ``h`` as its initial state, so
no (B, S, d_in, N) array of the whole prompt is ever made.  In training
the same loop runs under autograd: each chunk's call is
``ssm_scan.SsmScanFn``, whose backward is B6's reverse recurrence, and the
carried ``h`` passes the next chunk's gradient back into this chunk's
last state.  Decode
(``mamba_decode``) is the reference's one-step update of ``h`` and the
convolution window, written into the state in place.  The reference's
dtype rules hold: projections and the convolution run in the compute
dtype; ``delta``, ``a``, ``b`` and the state ``h`` are f32; each chunk's
output is cast back to the compute dtype.  Under ``ranks=``
(tensor-parallel serving) both forms run on the rank's block of the
``d_in`` channels (:func:`mamba_scan`).

xLSTM.  The reference computes the mLSTM and sLSTM in XLA, with no Pallas
kernel, so the port keeps them in PyTorch and launches no kernel of its
own.  ``mlstm_scan`` is the stabilized chunkwise-parallel prefill
(chunks of ``MLSTM_CHUNK``, the carry starting at m = 0);
``mlstm_scan_sequential`` (its oracle) and ``mlstm_decode`` run the
stabilized recurrence one step at a time from m = -1e9, as in the
reference.  The stabilizer scales C, n and the floor ``exp(-m)`` of the
denominator alike, so the two starts give one function and prefill and
token-by-token decode differ by rounding only (held at the reference's
5e-4).  The matrix memory ``C`` is indexed [v, k].  ``slstm_scan`` is
inherently sequential; its recurrent product runs in f32 whatever the
compute dtype, as the reference's ``pre`` is f32.  Both sequential forms
go through :func:`scan_chunked`, which keeps the reference's shape
contract.  ``jax.nn.log_sigmoid`` is ``-softplus(-x)``
(:func:`log_sigmoid`), not ``F.logsigmoid``.  When ``torch.profiler`` is
on, each mLSTM and sLSTM call is labelled ``ssm.mlstm`` / ``ssm.slstm``
(``XLSTM_SPANS``).

Under ``ranks`` the mLSTM runs on the rank's block of each head's **v
rows**, where the plan puts its state ``C`` ([v, k]): ``up_proj``'s and
the q/k/v products gathered whole (u and g are its halves, a rank's
column block is not its channels of either), v narrowed to the rank's
rows of each head; the gates from the row-parallel ``w_igate``/
``w_fgate`` sums; in a decode step ``n`` on the rank's block of its k
index with the denominator's ``n . q`` a partial dot summed over
``"model"``, ``m`` whole (gathered where the plan splits it on the
heads, its block kept); h gathered back to whole heads before
``down_proj``'s row-parallel sum.  The prefill's chunkwise form needs no
sum: with k whole on every rank ``n_t`` is whole.  The sLSTM runs on the
rank's d-channels of each of its four gates
(``tensor_parallel.chunk_channels`` of ``w_in``'s and, each step, of
``w_rec``'s gathered product: h all-gathered for it, two exchanges a
step), its state the rank's channels, ``out_proj`` a
row-parallel sum over them.  A state the plan splits over ``"model"``
elsewhere raises, naming 7(b) step 3d.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, dtype_of, span

CONV_WIDTH = 4
MAMBA_CHUNK = 128
RECURRENT_CHUNK = 256
MLSTM_CHUNK = 512
XLSTM_SPANS = ("ssm.mlstm", "ssm.slstm")


def scan_chunked(step, carry, xs, chunk: int):
    """The reference's ``scan_chunked``: ``step(carry, x_t) -> (carry,
    y_t)`` over dim 0 of every tensor in ``xs`` (each (S, ...)), returning
    (carry, ys stacked on dim 0).  The reference checkpoints the scan in
    chunks of ``chunk`` steps for its backward; a plain time loop is the
    same function, and autograd differentiates it as it is (keeping every
    step's activations).  Its shape contract stays:
    S must be a multiple of ``min(chunk, S)`` (a ``ValueError`` where the
    reference's assert fails)."""
    S = xs[0].shape[0]
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"scan chunk {c}")
    ys = []
    for t in range(S):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def init_mamba(gen: torch.Generator, cfg: ArchConfig,
               d_in: int) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    d, ds = cfg.d_model, cfg.ssm_state
    dt_rank = max(1, math.ceil(d / 16))
    dev = gen.device
    A = torch.arange(1, ds + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(d_in, 1)
    return {
        "in_proj": dense_init(gen, (d, 2 * d_in), dtype=dt),
        "conv_w": dense_init(gen, (CONV_WIDTH, d_in), dtype=dt),
        "conv_b": torch.zeros((d_in,), dtype=dt, device=dev),
        "x_proj": dense_init(gen, (d_in, dt_rank + 2 * ds), dtype=dt),
        "dt_proj": dense_init(gen, (dt_rank, d_in), dtype=dt),
        "dt_bias": torch.full((d_in,), -4.6, dtype=dt,
                              device=dev),      # softplus^-1(0.01)
        "A_log": torch.log(A).to(dt),
        "D": torch.ones((d_in,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (d_in, d), dtype=dt),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``.  ``F.softplus``
    returns x itself above its threshold of 20, where log(1 + e^-x) is
    still up to 2e-9 relative."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``, i.e. ``-softplus(-x)``."""
    return -softplus(-x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifts, in the reference's order.
    x: (B, S, d_in); w: (W, d_in).  Not ``F.conv1d``: on the card that
    goes to cuDNN, which runs f32 in TF32 unless told otherwise, and sums
    in its own order."""
    S = x.shape[1]
    out = x * w[-1]
    for i in range(1, CONV_WIDTH):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return F.silu(out + b)


def _mamba_coeffs(params, u: torch.Tensor, cfg: ArchConfig, ranks=None):
    """u: (B, S, d_in) post-conv (under ``ranks``, the rank's channels).
    Returns a, b (B, S, d_in, N) and C (B, S, N), f32, for ``h_t = a_t
    h_{t-1} + b_t`` and ``y_t = h_t C_t``."""
    ds = cfg.ssm_state
    proj = tp.linear_from_block(u, params["x_proj"],
                                tp.spec(ranks, "x_proj"), ranks)
    dt_rank = proj.shape[-1] - 2 * ds     # dt_proj's rows may be a block
    dt_lowrank, Bc, Cc = torch.split(proj, [dt_rank, ds, ds], dim=-1)
    delta = softplus(tp.linear_cols(dt_lowrank, params["dt_proj"],
                                    tp.spec(ranks, "dt_proj"), ranks)
                     + _block(params, "dt_bias", ranks).to(u.dtype)).float()
    A = -torch.exp(_block(params, "A_log", ranks, 0).float())  # (d_in, N)
    a = torch.exp(delta[..., None] * A)
    b = (delta * u.float())[..., None] * Bc.float()[:, :, None, :]
    return a, b, Cc.float()


def _block(params, name: str, ranks, dim: int = -1) -> torch.Tensor:
    """A channel-indexed leaf of the mixer (its channels on ``dim``): this
    rank's block of it, or the leaf at world 1."""
    return tp.leaf_block(params[name], tp.spec(ranks, name), ranks, dim)


def _in_proj(params, x: torch.Tensor, ranks):
    """u and z, the two halves of ``x @ in_proj``, at the rank's channels.
    The plan splits ``in_proj`` (d, 2 d_in) on its output, but a rank's
    column block is not its channels of u and then of z (over 2 ranks one
    holds all of u, the other all of z): the product is gathered whole
    (exact) and each half narrowed to the rank's channels."""
    xz = tp.linear(x, params["in_proj"], tp.spec(ranks, "in_proj"), ranks)
    u, z = xz.chunk(2, dim=-1)
    return tp.channels(u, ranks), tp.channels(z, ranks)


def mamba_scan(params, x: torch.Tensor, cfg: ArchConfig,
               ranks=None) -> torch.Tensor:
    """Prefill form.  x: (B, S, d_model) -> (B, S, d_model).

    The sequence is padded with zeros to whole chunks of ``MAMBA_CHUNK``
    and the padding's outputs dropped, as in the reference.  The
    reference combines inside a chunk with ``associative_scan`` (a tree
    order); B6 and its plain version fold in time order, so the port
    agrees with it to f32 rounding (1e-5), not bit for bit.

    ``ranks`` (tensor-parallel serving, ``distributed/tensor_parallel.py``)
    runs the mixer on the rank's block of its ``d_in`` channels: the
    convolution, B6 (every (row, channel, state) chain is independent)
    and the gating on them; ``x_proj``'s and ``out_proj``'s products
    row-parallel sums (or as their specs say), the output whole."""
    B, S, _ = x.shape
    u, z = _in_proj(params, x, ranks)
    u = _causal_conv(u, _block(params, "conv_w", ranks).to(u.dtype),
                     _block(params, "conv_b", ranks).to(u.dtype))

    chunk = min(MAMBA_CHUNK, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    u_p = F.pad(u, (0, 0, 0, pad)) if pad else u

    h = None                                     # zeros: B6's own start
    ys = []
    for c in range(n_chunks):
        a, b, Cc = _mamba_coeffs(params, u_p[:, c * chunk:(c + 1) * chunk],
                                 cfg, ranks)
        hs = ops.ssm_scan(a, b, h)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cc).to(x.dtype))
        h = hs[:, -1].contiguous()
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + u * _block(params, "D", ranks).to(u.dtype)
    out = y * F.silu(z)
    return tp.linear_from_block(out, params["out_proj"],
                                tp.spec(ranks, "out_proj"), ranks)


def mamba_state_init(cfg: ArchConfig, batch: int, d_in: int,
                     dtype: torch.dtype, device=None):
    return {
        "h": torch.zeros((batch, d_in, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, d_in), dtype=dtype,
                            device=device),
    }


def mamba_decode(params, x: torch.Tensor, state, cfg: ArchConfig,
                 ranks=None):
    """One-token decode.  x: (B, 1, d_model); state: {'h', 'conv'}, both
    overwritten in place with the new state.  Returns (out, state).
    ``ranks``: as :func:`mamba_scan`, with ``ranks.state_specs`` the
    state's; ``h`` (B, d_in, N) and ``conv`` (B, CONV_WIDTH - 1, d_in)
    hold the rank's channels (a state the plan splits over ``"model"`` on
    another dim raises, naming 7(b) step 3d)."""
    for name, dim in (("h", 1), ("conv", 2)):
        got = tp.model_dim(tp.state_spec(ranks, name), ranks)
        if ranks is not None and got != dim:
            raise NotImplementedError(
                f"a Mamba state {name} {tuple(state[name].shape)} split "
                f"over 'model' on dim {got}, not its channels: {tp.STEP3D}")
    u, z = _in_proj(params, x, ranks)
    hist = torch.cat([state["conv"], u], dim=1)              # (B, W, d_in)
    w = _block(params, "conv_w", ranks).to(u.dtype)
    conv_out = torch.einsum("bwd,wd->bd", hist, w) \
        + _block(params, "conv_b", ranks).to(u.dtype)
    u1 = F.silu(conv_out)[:, None, :]
    a, b, Cc = _mamba_coeffs(params, u1, cfg, ranks)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None, :].to(x.dtype)
    y = y + u1 * _block(params, "D", ranks).to(u1.dtype)
    out = y * F.silu(z)
    out = tp.linear_from_block(out, params["out_proj"],
                               tp.spec(ranks, "out_proj"), ranks)
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return out, state


# ===========================================================================
# mLSTM (xLSTM matrix memory)
# ===========================================================================
def _mlstm_heads(cfg: ArchConfig) -> int:
    return cfg.mlstm_heads or cfg.n_heads


def init_mlstm(gen: torch.Generator, cfg: ArchConfig
               ) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    d_in = 2 * d
    heads = _mlstm_heads(cfg)
    dev = gen.device
    return {
        "up_proj": dense_init(gen, (d, 2 * d_in), dtype=dt),
        "wq": dense_init(gen, (d_in, d_in), dtype=dt),
        "wk": dense_init(gen, (d_in, d_in), dtype=dt),
        "wv": dense_init(gen, (d_in, d_in), dtype=dt),
        "w_igate": dense_init(gen, (d_in, heads), scale=0.1, dtype=dt),
        "w_fgate": dense_init(gen, (d_in, heads), scale=0.1, dtype=dt),
        "fgate_bias": torch.full((heads,), 3.0, dtype=dt,
                                 device=dev),    # start mostly-remember
        "igate_bias": torch.zeros((heads,), dtype=dt, device=dev),
        "down_proj": dense_init(gen, (d_in, d), dtype=dt),
    }


def _mlstm_qkvif(params, x: torch.Tensor, heads: int, ranks=None):
    """q, k, v (B, S, heads, hd) in x's dtype (k scaled by 1 / sqrt(hd)
    in that dtype), the gate pre-activations i_pre, f_pre (B, S, heads)
    summed in x's dtype then cast to f32, and the output gate's input g.
    ``ranks``: everything whole but v, the rank's block of each head's
    rows (B, S, heads, hd / M)."""
    sp = lambda n: tp.spec(ranks, n)
    u, g = tp.linear(x, params["up_proj"], sp("up_proj"), ranks).chunk(
        2, dim=-1)
    B, S, d_in = u.shape
    hd = d_in // heads

    def proj(name):
        return tp.linear(u, params[name], sp(name), ranks).reshape(
            B, S, heads, hd)

    q, k, v = proj("wq"), proj("wk"), tp.channels(proj("wv"), ranks)
    k = k / torch.sqrt(torch.tensor(hd, dtype=k.dtype, device=k.device))

    def gate(w, b):
        bias = tp.gather_leaf(params[b], sp(b), ranks)
        return (tp.linear(u, params[w], sp(w), ranks)
                + bias.to(u.dtype)).float()

    return q, k, v, gate("w_igate", "igate_bias"), \
        gate("w_fgate", "fgate_bias"), g


def _mlstm_out(params, h: torch.Tensor, g: torch.Tensor,
               dtype: torch.dtype, ranks=None) -> torch.Tensor:
    """h (B, S, heads * hd) f32 -> the block's output (B, S, d)."""
    out = h.to(dtype) * F.silu(g)
    return tp.linear(out, params["down_proj"], tp.spec(ranks, "down_proj"),
                     ranks)


def mlstm_scan(params, x: torch.Tensor, cfg: ArchConfig,
               ranks=None) -> torch.Tensor:
    """Prefill mLSTM, the stabilized chunkwise-parallel form.
    x: (B, S, d) -> (B, S, d).

    Per chunk of length L (log-domain gates, running stabilizer m):
        b_t   = cumsum(log f)            (within chunk)
        inter = exp(b_t + m_prev - m_t) * C_prev q_t
        intra = [(q k^T) * D] v,  D_tj = exp(b_t - b_j + i_j - m_t) (j<=t)
        C_new = exp(B_L + m_prev - m_new) C_prev
                + sum_j exp(B_L - b_j + i_j - m_new) v_j k_j^T
        out_t = (inter + intra) / max(|q_t . n_t|, exp(-m_t))
    L is ``MLSTM_CHUNK``, or gcd(S, MLSTM_CHUNK) where S is not a
    multiple of it; the carry starts at C = 0, n = 0, m = 0.  ``ranks``:
    on the rank's v rows of each head (the module's docstring)."""
    with span("ssm.mlstm"):
        B, S, _ = x.shape
        heads = _mlstm_heads(cfg)
        q, k, v, i_pre, f_pre, g = _mlstm_qkvif(params, x, heads, ranks)
        hd, hv = q.shape[-1], v.shape[-1]
        L = min(MLSTM_CHUNK, S)
        if S % L:
            L = math.gcd(S, L) or 1
        dev = x.device
        C = torch.zeros((B, heads, hv, hd), dtype=torch.float32, device=dev)
        n = torch.zeros((B, heads, hd), dtype=torch.float32, device=dev)
        m = torch.zeros((B, heads), dtype=torch.float32, device=dev)
        tri = torch.ones((L, L), dtype=torch.bool, device=dev).tril()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        hs = []
        for c0 in range(0, S, L):
            qt, kt, vt = (t[:, c0:c0 + L].float() for t in (q, k, v))
            it, ft = i_pre[:, c0:c0 + L], f_pre[:, c0:c0 + L]   # (B, L, H)
            b = torch.cumsum(log_sigmoid(ft), dim=1)
            B_L = b[:, -1]                                     # (B, H)
            # m_t = max(m_prev + b_t, max_{j<=t}(b_t - b_j + i_j))
            s_j = it - b
            run_max = torch.cummax(s_j, dim=1).values
            m_t = torch.maximum(m[:, None] + b, b + run_max)   # (B, L, H)
            bT, sT, mT = (t.transpose(1, 2) for t in (b, s_j, m_t))
            D = bT[:, :, :, None] + sT[:, :, None, :] - mT[:, :, :, None]
            D = torch.where(tri, torch.exp(D), zero)           # (B, H, L, L)
            scores = torch.einsum("blhd,bshd->bhls", qt, kt)
            intra = torch.einsum("bhls,bshd->blhd", scores * D, vt)
            decay_t = torch.exp(m[:, None] + b - m_t)          # (B, L, H)
            inter = torch.einsum("blhd,bhed->blhe", qt, C) * decay_t[..., None]
            n_t = torch.einsum("bhls,bshd->blhd", D, kt) \
                + n[:, None] * decay_t[..., None]
            den = torch.maximum(
                torch.einsum("blhd,blhd->blh", qt, n_t).abs(), torch.exp(-m_t))
            hs.append((intra + inter) / den[..., None])        # (B, L, H, hd)
            # chunk-boundary state update
            m_new = torch.maximum(m + B_L, B_L + s_j.amax(dim=1))
            w_j = torch.exp(B_L[:, None] + s_j - m_new[:, None])
            carry = torch.exp(m + B_L - m_new)
            C = C * carry[..., None, None] + torch.einsum(
                "blhd,blhe->bhde", vt * w_j[..., None], kt)
            n = n * carry[..., None] + torch.einsum("blhd,blh->bhd", kt, w_j)
            m = m_new
        h = tp.gather(torch.cat(hs, dim=1), ranks, -1).reshape(B, S, -1)
        return _mlstm_out(params, h, g, x.dtype, ranks)


def _mlstm_step(carry, inp, ranks=None):
    """One step of the stabilized recurrence: carry (C (B, H, hd, hd),
    n (B, H, hd), m (B, H)), inp (q, k, v (B, H, hd), i, f (B, H) f32).
    Returns (carry, h (B, H, hd) f32).  ``ranks``: v, C's rows and h the
    rank's block of each head's v rows, n its block of the k index (the
    denominator's dot summed over ``"model"``), m whole."""
    C, n, m = carry
    qt, kt, vt, it, ft = inp
    log_f = log_sigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_s = torch.exp(it - m_new)[..., None]
    f_s = torch.exp(log_f + m - m_new)[..., None]
    kf, vf = kt.float(), vt.float()
    C = f_s[..., None] * C \
        + i_s[..., None] * (vf[..., :, None] * kf[..., None, :])
    n = f_s * n + i_s * tp.channels(kf, ranks)
    qf = qt.float()
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    dot = tp.reduce_sum(torch.einsum("bhk,bhk->bh", n,
                                     tp.channels(qf, ranks)), ranks)
    den = torch.maximum(dot.abs(), torch.exp(-m_new))
    return (C, n, m_new), num / den[..., None]


def mlstm_scan_sequential(params, x: torch.Tensor, cfg: ArchConfig
                          ) -> torch.Tensor:
    """The stabilized sequential form from m = -1e9 (the oracle of
    :func:`mlstm_scan`).  x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    heads = _mlstm_heads(cfg)
    q, k, v, i_pre, f_pre, g = _mlstm_qkvif(params, x, heads)
    st = mlstm_state_init(cfg, B, x.dtype, device=x.device)
    xs = tuple(t.transpose(0, 1) for t in (q, k, v, i_pre, f_pre))
    _, hs = scan_chunked(_mlstm_step, (st["C"], st["n"], st["m"]), xs,
                         RECURRENT_CHUNK)
    h = hs.transpose(0, 1).reshape(B, S, -1)
    return _mlstm_out(params, h, g, x.dtype)


def mlstm_state_init(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """C (B, H, hd, hd), n (B, H, hd) zeros and m (B, H) at -1e9, all
    f32 whatever ``dtype``."""
    heads = _mlstm_heads(cfg)
    hd = 2 * cfg.d_model // heads
    f32 = torch.float32
    return {"C": torch.zeros((batch, heads, hd, hd), dtype=f32,
                             device=device),
            "n": torch.zeros((batch, heads, hd), dtype=f32, device=device),
            "m": torch.full((batch, heads), -1e9, dtype=f32, device=device)}


def _check_state(state, ranks, dims) -> None:
    """Raise, naming 7(b) step 3d, where the plan splits a state leaf over
    ``"model"`` on another dim than ``dims[name]`` (None: not at all, or
    on ``dims`` entry's alternatives)."""
    if ranks is None:
        return
    for name, want in dims.items():
        got = tp.model_dim(tp.state_spec(ranks, name), ranks)
        if got not in want:
            raise NotImplementedError(
                f"a recurrent state {name} {tuple(state[name].shape)} split "
                f"over 'model' on dim {got}, not {want}: {tp.STEP3D}")


def mlstm_decode(params, x: torch.Tensor, state, cfg: ArchConfig,
                 ranks=None):
    """One-token decode.  x: (B, 1, d); state {'C', 'n', 'm'}, overwritten
    in place with the new state.  Returns (out (B, 1, d), state).
    ``ranks`` (its ``state_specs`` the state's): C holds the rank's block
    of the v index, n of the k index, m the rank's heads or all of them
    (the module's docstring)."""
    _check_state(state, ranks, {"C": (2,), "n": (2,), "m": (1, None)})
    with span("ssm.mlstm"):
        B = x.shape[0]
        q, k, v, i_pre, f_pre, g = _mlstm_qkvif(params, x, _mlstm_heads(cfg),
                                                ranks)
        m_spec = tp.state_spec(ranks, "m")
        (C, n, m), h = _mlstm_step(
            (state["C"], state["n"], tp.gather_leaf(state["m"], m_spec,
                                                    ranks)),
            (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0]), ranks)
        out = _mlstm_out(params, tp.gather(h, ranks, -1).reshape(B, 1, -1),
                         g, x.dtype, ranks)
        state["C"].copy_(C)
        state["n"].copy_(n)
        state["m"].copy_(tp.model_block(m, m_spec, ranks))
        return out, state


# ===========================================================================
# sLSTM (xLSTM scalar memory; inherently sequential)
# ===========================================================================
def init_slstm(gen: torch.Generator, cfg: ArchConfig
               ) -> Dict[str, torch.Tensor]:
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    bias = torch.zeros((4 * d,), dtype=torch.float32, device=gen.device)
    bias[2 * d:3 * d] = 3.0                                # z, i, f, o
    return {
        "w_in": dense_init(gen, (d, 4 * d), dtype=dt),
        "w_rec": dense_init(gen, (d, 4 * d), scale=0.5, dtype=dt),
        "bias": bias.to(dt),
        "out_proj": dense_init(gen, (d, d), dtype=dt),
    }


def _slstm_step(w_rec: torch.Tensor, carry, pre: torch.Tensor, ranks=None):
    """One step: carry (h, c, n, m) (B, d) f32, pre (B, 4d) f32, w_rec
    (the rank's block) already in pre's dtype.  Returns (carry, h).
    ``ranks``: the carry and h the rank's channels (B, d / M), pre its
    channels of each gate; h gathered whole, and the recurrent product
    gathered and narrowed to the rank's channels as ``w_in``'s is."""
    h, c, n, m = carry
    rec = tp.linear(tp.gather(h, ranks, -1).to(pre.dtype), w_rec,
                    tp.spec(ranks, "w_rec"), ranks)
    gates = pre + tp.chunk_channels(rec, 4, ranks).float()
    z_pre, i_pre, f_pre, o_pre = gates.chunk(4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c = f_s * c + i_s * z
    n = f_s * n + i_s
    h_new = o * c / torch.maximum(n, torch.exp(-m_new))
    return (h_new, c, n, m_new), h_new


def _slstm_pre(params, x: torch.Tensor, ranks=None) -> torch.Tensor:
    """``x @ w_in + bias`` in f32; under ``ranks`` the product gathered
    and narrowed to the rank's channels of each gate (B, S, 4d / M)."""
    pre = tp.linear(x, params["w_in"], tp.spec(ranks, "w_in"), ranks) \
        + tp.gather_leaf(params["bias"], tp.spec(ranks, "bias"),
                         ranks).to(x.dtype)
    return tp.chunk_channels(pre, 4, ranks).float()


def _slstm_out(params, h: torch.Tensor, ranks=None) -> torch.Tensor:
    """h (the rank's channels under ``ranks``) in its dtype -> (.., d)."""
    return tp.linear_from_block(h, params["out_proj"],
                                tp.spec(ranks, "out_proj"), ranks)


def slstm_scan(params, x: torch.Tensor, cfg: ArchConfig,
               ranks=None) -> torch.Tensor:
    """Prefill sLSTM, one step at a time from h = c = n = 0, m = -1e9.
    x: (B, S, d) -> (B, S, d).  ``ranks``: on the rank's channels (the
    module's docstring), two all-gathers a step."""
    with span("ssm.slstm"):
        B = x.shape[0]
        pre = _slstm_pre(params, x, ranks)
        w_rec = params["w_rec"].to(pre.dtype)       # cast once, not per step
        st = slstm_state_init(cfg, B, x.dtype, device=x.device,
                              width=pre.shape[-1] // 4)
        _, hs = scan_chunked(
            lambda carry, inp: _slstm_step(w_rec, carry, inp[0], ranks),
            (st["h"], st["c"], st["n"], st["m"]), (pre.transpose(0, 1),),
            RECURRENT_CHUNK)
        h = hs.transpose(0, 1).to(x.dtype)
        return _slstm_out(params, h, ranks)


def slstm_state_init(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device=None, width: int = 0) -> Dict[str, torch.Tensor]:
    """h, c, n zeros and m at -1e9, (B, d) f32 each (``width`` channels
    where given), whatever ``dtype``."""
    shape, f32 = (batch, width or cfg.d_model), torch.float32
    return {"h": torch.zeros(shape, dtype=f32, device=device),
            "c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, -1e9, dtype=f32, device=device)}


def slstm_decode(params, x: torch.Tensor, state, cfg: ArchConfig,
                 ranks=None):
    """One-token decode.  x: (B, 1, d); state {'h', 'c', 'n', 'm'},
    overwritten in place.  Returns (out (B, 1, d), state).  ``ranks``
    (its ``state_specs`` the state's): the state holds the rank's
    channels."""
    _check_state(state, ranks, dict.fromkeys("hcnm", (1,)))
    with span("ssm.slstm"):
        pre = _slstm_pre(params, x, ranks)[:, 0]
        carry, h_out = _slstm_step(params["w_rec"].to(pre.dtype),
                                   tuple(state[n] for n in "hcnm"), pre,
                                   ranks)
        out = _slstm_out(params, h_out.to(x.dtype), ranks)[:, None, :]
        for name, t in zip("hcnm", carry):
            state[name].copy_(t)
        return out, state
