"""Recurrent mixers: the Mamba selective scan and xLSTM's mLSTM and
sLSTM (the port of the JAX package's ``models/ssm.py``).

Mamba.  Prefill (``mamba_scan``) keeps the reference's loop over chunks of
``MAMBA_CHUNK`` steps with the state ``h`` carried from one chunk to the
next; inside a chunk the recurrence ``h_t = a_t * h_{t-1} + b_t`` goes
through ``ops.ssm_scan`` (B6: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors), with the carried ``h`` as its initial state, so
no (B, S, d_in, N) array of the whole prompt is ever made.  Decode
(``mamba_decode``) is the reference's one-step update of ``h`` and the
convolution window, written into the state in place.  The reference's
dtype rules hold: projections and the convolution run in the compute
dtype; ``delta``, ``a``, ``b`` and the state ``h`` are f32; each chunk's
output is cast back to the compute dtype.

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
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, dtype_of, span

CONV_WIDTH = 4
MAMBA_CHUNK = 128
RECURRENT_CHUNK = 256
MLSTM_CHUNK = 512
XLSTM_SPANS = ("ssm.mlstm", "ssm.slstm")


def scan_chunked(step, carry, xs, chunk: int):
    """The reference's ``scan_chunked`` for serving: ``step(carry, x_t) ->
    (carry, y_t)`` over dim 0 of every tensor in ``xs`` (each (S, ...)),
    returning (carry, ys stacked on dim 0).  The reference checkpoints the
    scan in chunks of ``chunk`` steps for its backward; serving has none,
    so a plain time loop is the same function.  Its shape contract stays:
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


def _mamba_coeffs(params, u: torch.Tensor, cfg: ArchConfig):
    """u: (B, S, d_in) post-conv.  Returns a, b (B, S, d_in, N) and C
    (B, S, N), f32, for ``h_t = a_t h_{t-1} + b_t`` and ``y_t = h_t C_t``."""
    ds = cfg.ssm_state
    dt_rank = params["dt_proj"].shape[0]
    proj = u @ params["x_proj"].to(u.dtype)
    dt_lowrank, Bc, Cc = torch.split(proj, [dt_rank, ds, ds], dim=-1)
    delta = softplus(dt_lowrank @ params["dt_proj"].to(u.dtype)
                     + params["dt_bias"].to(u.dtype)).float()
    A = -torch.exp(params["A_log"].float())                    # (d_in, N)
    a = torch.exp(delta[..., None] * A)
    b = (delta * u.float())[..., None] * Bc.float()[:, :, None, :]
    return a, b, Cc.float()


def mamba_scan(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Prefill form.  x: (B, S, d_model) -> (B, S, d_model).

    The sequence is padded with zeros to whole chunks of ``MAMBA_CHUNK``
    and the padding's outputs dropped, as in the reference.  The
    reference combines inside a chunk with ``associative_scan`` (a tree
    order); B6 and its plain version fold in time order, so the port
    agrees with it to f32 rounding (1e-5), not bit for bit."""
    B, S, _ = x.shape
    xz = x @ params["in_proj"].to(x.dtype)
    u, z = xz.chunk(2, dim=-1)
    u = _causal_conv(u, params["conv_w"].to(u.dtype),
                     params["conv_b"].to(u.dtype))

    chunk = min(MAMBA_CHUNK, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    u_p = F.pad(u, (0, 0, 0, pad)) if pad else u

    h = None                                     # zeros: B6's own start
    ys = []
    for c in range(n_chunks):
        a, b, Cc = _mamba_coeffs(params, u_p[:, c * chunk:(c + 1) * chunk],
                                 cfg)
        hs = ops.ssm_scan(a, b, h)
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, Cc).to(x.dtype))
        h = hs[:, -1].contiguous()
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + u * params["D"].to(u.dtype)
    out = y * F.silu(z)
    return out @ params["out_proj"].to(out.dtype)


def mamba_state_init(cfg: ArchConfig, batch: int, d_in: int,
                     dtype: torch.dtype, device=None):
    return {
        "h": torch.zeros((batch, d_in, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, d_in), dtype=dtype,
                            device=device),
    }


def mamba_decode(params, x: torch.Tensor, state, cfg: ArchConfig):
    """One-token decode.  x: (B, 1, d_model); state: {'h', 'conv'}, both
    overwritten in place with the new state.  Returns (out, state)."""
    xz = x @ params["in_proj"].to(x.dtype)
    u, z = xz.chunk(2, dim=-1)
    hist = torch.cat([state["conv"], u], dim=1)              # (B, W, d_in)
    w = params["conv_w"].to(u.dtype)
    conv_out = torch.einsum("bwd,wd->bd", hist, w) \
        + params["conv_b"].to(u.dtype)
    u1 = F.silu(conv_out)[:, None, :]
    a, b, Cc = _mamba_coeffs(params, u1, cfg)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])[:, None, :].to(x.dtype)
    y = y + u1 * params["D"].to(u1.dtype)
    out = y * F.silu(z)
    out = out @ params["out_proj"].to(out.dtype)
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


def _mlstm_qkvif(params, x: torch.Tensor, heads: int):
    """q, k, v (B, S, heads, hd) in x's dtype (k scaled by 1 / sqrt(hd)
    in that dtype), the gate pre-activations i_pre, f_pre (B, S, heads)
    summed in x's dtype then cast to f32, and the output gate's input g."""
    u, g = (x @ params["up_proj"].to(x.dtype)).chunk(2, dim=-1)
    B, S, d_in = u.shape
    hd = d_in // heads

    def proj(w):
        return (u @ w.to(u.dtype)).reshape(B, S, heads, hd)

    q, k, v = proj(params["wq"]), proj(params["wk"]), proj(params["wv"])
    k = k / torch.sqrt(torch.tensor(hd, dtype=k.dtype, device=k.device))
    i_pre = (u @ params["w_igate"].to(u.dtype)
             + params["igate_bias"].to(u.dtype)).float()
    f_pre = (u @ params["w_fgate"].to(u.dtype)
             + params["fgate_bias"].to(u.dtype)).float()
    return q, k, v, i_pre, f_pre, g


def _mlstm_out(params, h: torch.Tensor, g: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """h (B, S, heads * hd) f32 -> the block's output (B, S, d)."""
    out = h.to(dtype) * F.silu(g)
    return out @ params["down_proj"].to(out.dtype)


def mlstm_scan(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
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
    multiple of it; the carry starts at C = 0, n = 0, m = 0."""
    with span("ssm.mlstm"):
        B, S, _ = x.shape
        heads = _mlstm_heads(cfg)
        q, k, v, i_pre, f_pre, g = _mlstm_qkvif(params, x, heads)
        hd = q.shape[-1]
        L = min(MLSTM_CHUNK, S)
        if S % L:
            L = math.gcd(S, L) or 1
        dev = x.device
        C = torch.zeros((B, heads, hd, hd), dtype=torch.float32, device=dev)
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
        h = torch.cat(hs, dim=1).reshape(B, S, heads * hd)
        return _mlstm_out(params, h, g, x.dtype)


def _mlstm_step(carry, inp):
    """One step of the stabilized recurrence: carry (C (B, H, hd, hd),
    n (B, H, hd), m (B, H)), inp (q, k, v (B, H, hd), i, f (B, H) f32).
    Returns (carry, h (B, H, hd) f32)."""
    C, n, m = carry
    qt, kt, vt, it, ft = inp
    log_f = log_sigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_s = torch.exp(it - m_new)[..., None]
    f_s = torch.exp(log_f + m - m_new)[..., None]
    kf, vf = kt.float(), vt.float()
    C = f_s[..., None] * C \
        + i_s[..., None] * (vf[..., :, None] * kf[..., None, :])
    n = f_s * n + i_s * kf
    qf = qt.float()
    num = torch.einsum("bhvk,bhk->bhv", C, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(),
                        torch.exp(-m_new))
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


def mlstm_decode(params, x: torch.Tensor, state, cfg: ArchConfig):
    """One-token decode.  x: (B, 1, d); state {'C', 'n', 'm'}, overwritten
    in place with the new state.  Returns (out (B, 1, d), state)."""
    with span("ssm.mlstm"):
        B = x.shape[0]
        q, k, v, i_pre, f_pre, g = _mlstm_qkvif(params, x, _mlstm_heads(cfg))
        (C, n, m), h = _mlstm_step(
            (state["C"], state["n"], state["m"]),
            (q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0]))
        out = _mlstm_out(params, h.reshape(B, 1, -1), g, x.dtype)
        state["C"].copy_(C)
        state["n"].copy_(n)
        state["m"].copy_(m)
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


def _slstm_step(w_rec: torch.Tensor, carry, pre: torch.Tensor):
    """One step: carry (h, c, n, m) (B, d) f32, pre (B, 4d) f32, w_rec
    already in pre's dtype.  Returns (carry, h)."""
    h, c, n, m = carry
    gates = pre + (h.to(pre.dtype) @ w_rec).float()
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


def _slstm_pre(params, x: torch.Tensor) -> torch.Tensor:
    return (x @ params["w_in"].to(x.dtype)
            + params["bias"].to(x.dtype)).float()


def slstm_scan(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Prefill sLSTM, one step at a time from h = c = n = 0, m = -1e9.
    x: (B, S, d) -> (B, S, d)."""
    with span("ssm.slstm"):
        B = x.shape[0]
        pre = _slstm_pre(params, x)
        w_rec = params["w_rec"].to(pre.dtype)       # cast once, not per step
        st = slstm_state_init(cfg, B, x.dtype, device=x.device)
        _, hs = scan_chunked(
            lambda carry, inp: _slstm_step(w_rec, carry, inp[0]),
            (st["h"], st["c"], st["n"], st["m"]), (pre.transpose(0, 1),),
            RECURRENT_CHUNK)
        h = hs.transpose(0, 1).to(x.dtype)
        return h @ params["out_proj"].to(h.dtype)


def slstm_state_init(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    """h, c, n zeros and m at -1e9, (B, d) f32 each, whatever ``dtype``."""
    shape, f32 = (batch, cfg.d_model), torch.float32
    return {"h": torch.zeros(shape, dtype=f32, device=device),
            "c": torch.zeros(shape, dtype=f32, device=device),
            "n": torch.zeros(shape, dtype=f32, device=device),
            "m": torch.full(shape, -1e9, dtype=f32, device=device)}


def slstm_decode(params, x: torch.Tensor, state, cfg: ArchConfig):
    """One-token decode.  x: (B, 1, d); state {'h', 'c', 'n', 'm'},
    overwritten in place.  Returns (out (B, 1, d), state)."""
    with span("ssm.slstm"):
        pre = _slstm_pre(params, x)[:, 0]
        carry, h_out = _slstm_step(params["w_rec"].to(pre.dtype),
                                   tuple(state[n] for n in "hcnm"), pre)
        out = (h_out.to(x.dtype) @ params["out_proj"].to(x.dtype))[:, None, :]
        for name, t in zip("hcnm", carry):
            state[name].copy_(t)
        return out, state
