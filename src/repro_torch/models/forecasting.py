"""The paper's traffic-prediction models (Section V; the port of the JAX
package's ``models/forecasting.py``): BAFDP's MLP over closeness + period
+ metadata + text features, the GRU / LSTM backbones of the FedGRU /
Fed-NTP baselines and a small attention predictor (the FedAtt / FedDA
backbone).

Parameters are the reference's nested dicts (MLP ``{"l<i>": {"w", "b"}}``;
GRU/LSTM ``w_x``, ``w_h``, ``b``, ``w_meta``, ``w_out.{w,b}``; attention
``w_emb``, ``w_q``, ``w_k``, ``w_v``, ``w_out.{w,b}``).
:func:`apply_forecaster` and :func:`mse_loss` take one client's params,
``x: (B, d_x)``, or a stack with a leading client axis, ``x: (C, B,
d_x)`` — the round's per-client math.  :class:`Forecaster` is one
client's model as an ``nn.Module``.

The recurrent cells are the reference's own math, not ``nn.GRU`` /
``nn.LSTM``: its GRU adds ``h @ w_h[:, 2h:]`` to the candidate twice
(inside the gates and again scaled by r), its LSTM adds 1 to the forget
gate, and the state starts at ``tanh(meta @ w_meta)``.  (cuDNN would also
run f32 as TF32 on the card.)
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.forecast import ForecastConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, Any]
MODELS = ("mlp", "gru", "lstm", "attn")


def _check_model(cfg: ForecastConfig) -> None:
    if cfg.model not in MODELS:
        raise ValueError(f"unknown forecaster model {cfg.model!r} "
                         f"(expected one of {MODELS})")


def init_forecaster(gen: torch.Generator, cfg: ForecastConfig,
                    device=None) -> Params:
    """One client's model of ``cfg.model``, weights drawn from ``gen``."""
    _check_model(cfg)
    if cfg.model == "mlp":
        return _init_mlp(gen, cfg, device)
    if cfg.model in ("gru", "lstm"):
        return _init_rnn(gen, cfg, device)
    return _init_attn(gen, cfg, device)


def apply_forecaster(params: Params, x: torch.Tensor,
                     cfg: ForecastConfig) -> torch.Tensor:
    """(.., B, d_x) -> (.., B, d_y)."""
    _check_model(cfg)
    if cfg.model == "mlp":
        return _apply_mlp(params, x)
    if cfg.model == "gru":
        return _apply_gru(params, x, cfg)
    if cfg.model == "lstm":
        return _apply_lstm(params, x, cfg)
    return _apply_attn(params, x, cfg)


def mse_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
             cfg: ForecastConfig) -> torch.Tensor:
    """Mean squared error over each client's (B, d_y) block: a scalar for
    one client, (C,) for a stack."""
    pred = apply_forecaster(params, x, cfg)
    return torch.mean(torch.square(pred - y), dim=(-2, -1))


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with a stacked ``w`` (C, a, b) lined up with the leading
    client axis of ``x`` (C, ..., a)."""
    if w.ndim > 2:
        w = w.reshape(w.shape[:1] + (1,) * (x.ndim - w.ndim) + w.shape[1:])
    return x @ w


def _bias(b: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (n,) or stacked (C, n) bias shaped to add to an ``ndim``-axis
    activation (C, ..., n)."""
    if b.ndim > 1:
        return b.reshape(b.shape[:1] + (1,) * (ndim - 2) + b.shape[1:])
    return b


def _dense_out(p: Params, h: torch.Tensor) -> torch.Tensor:
    return _mm(h, p["w"]) + _bias(p["b"], h.ndim)


# ---------------------------------------------------------------------------
def _init_mlp(gen, cfg: ForecastConfig, device) -> Params:
    dims = (cfg.d_x,) + tuple(cfg.hidden) + (cfg.d_y,)
    return {f"l{i}": {"w": dense_init(gen, (dims[i], dims[i + 1]),
                                      device=device),
                      "b": torch.zeros((dims[i + 1],), device=device)}
            for i in range(len(dims) - 1)}


def _apply_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = _dense_out(params[f"l{i}"], x)
        if i < n - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
def _init_rnn(gen, cfg: ForecastConfig, device) -> Params:
    h = cfg.rnn_hidden
    g = (3 if cfg.model == "gru" else 4) * h
    return {"w_x": dense_init(gen, (1, g), device=device),
            "w_h": dense_init(gen, (h, g), device=device),
            "b": torch.zeros((g,), device=device),
            "w_meta": dense_init(gen, (cfg.n_meta + cfg.n_text, h),
                                 device=device),
            "w_out": {"w": dense_init(gen, (h, cfg.d_y), device=device),
                      "b": torch.zeros((cfg.d_y,), device=device)}}


def _series_and_meta(x: torch.Tensor, cfg: ForecastConfig):
    s = cfg.closeness_len + cfg.period_len
    return x[..., :s, None], x[..., s:]        # (.., B, S, 1), (.., B, meta)


def _apply_gru(params: Params, x: torch.Tensor,
               cfg: ForecastConfig) -> torch.Tensor:
    series, meta = _series_and_meta(x, cfg)
    h = torch.tanh(_mm(meta, params["w_meta"]))
    hdim = h.shape[-1]
    b = _bias(params["b"], h.ndim)
    w_hn = params["w_h"][..., 2 * hdim:]
    for t in range(series.shape[-2]):
        gates = _mm(series[..., t, :], params["w_x"]) \
            + _mm(h, params["w_h"]) + b
        r, z, n = torch.split(gates, hdim, dim=-1)
        r, z = torch.sigmoid(r), torch.sigmoid(z)
        n = torch.tanh(n + r * _mm(h, w_hn))
        h = (1 - z) * n + z * h
    return _dense_out(params["w_out"], h)


def _apply_lstm(params: Params, x: torch.Tensor,
                cfg: ForecastConfig) -> torch.Tensor:
    series, meta = _series_and_meta(x, cfg)
    h = torch.tanh(_mm(meta, params["w_meta"]))
    c = torch.zeros_like(h)
    hdim = h.shape[-1]
    b = _bias(params["b"], h.ndim)
    for t in range(series.shape[-2]):
        gates = _mm(series[..., t, :], params["w_x"]) \
            + _mm(h, params["w_h"]) + b
        i, f, g, o = torch.split(gates, hdim, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
    return _dense_out(params["w_out"], h)


# ---------------------------------------------------------------------------
def _init_attn(gen, cfg: ForecastConfig, device) -> Params:
    h = cfg.rnn_hidden
    return {"w_emb": dense_init(gen, (1, h), device=device),
            "w_q": dense_init(gen, (cfg.n_meta + cfg.n_text, h),
                              device=device),
            "w_k": dense_init(gen, (h, h), device=device),
            "w_v": dense_init(gen, (h, h), device=device),
            "w_out": {"w": dense_init(gen, (h, cfg.d_y), device=device),
                      "b": torch.zeros((cfg.d_y,), device=device)}}


def _apply_attn(params: Params, x: torch.Tensor,
                cfg: ForecastConfig) -> torch.Tensor:
    series, meta = _series_and_meta(x, cfg)
    e = torch.tanh(_mm(series, params["w_emb"]))              # (.., B, S, h)
    q = _mm(meta, params["w_q"])[..., None, :]                # (.., B, 1, h)
    k = _mm(e, params["w_k"])
    v = _mm(e, params["w_v"])
    scores = torch.softmax(q @ k.transpose(-1, -2)
                           / math.sqrt(k.shape[-1]), dim=-1)
    ctx = (scores @ v)[..., 0, :]
    return _dense_out(params["w_out"], ctx)


# ---------------------------------------------------------------------------
class _Tree(nn.Module):
    """A nested dict of tensors as frozen parameters and submodules."""

    def __init__(self, tree: Params):
        super().__init__()
        self.keys = sorted(tree)
        for k in self.keys:
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v.detach().clone(), requires_grad=False))

    def tree(self) -> Params:
        return {k: (getattr(self, k).tree()
                    if isinstance(getattr(self, k), _Tree)
                    else getattr(self, k)) for k in self.keys}


class Forecaster(nn.Module):
    """One client's forecaster as a module, e.g. for serving the model a
    client trained.  Holds a copy of ``params`` (no gradients)."""

    def __init__(self, params: Params, cfg: ForecastConfig):
        super().__init__()
        _check_model(cfg)
        self.cfg = cfg
        self.params = _Tree(params)

    def param_tree(self) -> Params:
        return self.params.tree()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_forecaster(self.param_tree(), x, self.cfg)
