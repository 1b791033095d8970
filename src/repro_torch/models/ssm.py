"""The Mamba selective-scan mixer: the port of the Mamba part of the JAX
package's ``models/ssm.py`` (xLSTM's mLSTM and sLSTM come with their
slice; ``models/transformer`` raises "not yet ported" for them).

Prefill (``mamba_scan``) keeps the reference's loop over chunks of
``MAMBA_CHUNK`` steps with the state ``h`` carried from one chunk to the
next; inside a chunk the recurrence ``h_t = a_t * h_{t-1} + b_t`` goes
through ``ops.ssm_scan`` (B6: the CUDA kernel for CUDA tensors, the plain
version for CPU tensors), with the carried ``h`` as its initial state, so
no (B, S, d_in, N) array of the whole prompt is ever made.  Decode
(``mamba_decode``) is the reference's one-step update of ``h`` and the
convolution window, written into the state in place.

The reference's dtype rules hold: projections and the convolution run in
the compute dtype; ``delta``, ``a``, ``b`` and the state ``h`` are f32;
each chunk's output is cast back to the compute dtype.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, dtype_of

CONV_WIDTH = 4
MAMBA_CHUNK = 128


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
