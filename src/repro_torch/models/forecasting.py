"""The paper's traffic-prediction MLP (Section V; the port of the JAX
package's ``models/forecasting.py`` for ``model="mlp"``).

Parameters are the reference's nested dict ``{"l<i>": {"w", "b"}}``.
:func:`apply_forecaster` and :func:`mse_loss` take one client's params,
``x: (B, d_x)``, or a stack with a leading client axis, ``x: (C, B, d_x)``
— the round's per-client math.  :class:`Forecaster` is one client's model
as an ``nn.Module``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.configs.forecast import ForecastConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, Dict[str, torch.Tensor]]


def _check_model(cfg: ForecastConfig) -> None:
    if cfg.model != "mlp":
        raise ValueError(f"forecaster model {cfg.model!r} is not yet ported "
                         "(only 'mlp')")


def init_forecaster(gen: torch.Generator, cfg: ForecastConfig,
                    device=None) -> Params:
    """One client's MLP: d_x -> hidden... -> d_y, weights from ``gen``."""
    _check_model(cfg)
    dims = (cfg.d_x,) + tuple(cfg.hidden) + (cfg.d_y,)
    return {f"l{i}": {"w": dense_init(gen, (dims[i], dims[i + 1]),
                                      device=device),
                      "b": torch.zeros((dims[i + 1],), device=device)}
            for i in range(len(dims) - 1)}


def apply_forecaster(params: Params, x: torch.Tensor,
                     cfg: ForecastConfig) -> torch.Tensor:
    """``x @ w + b`` per layer, ReLU between layers; (.., B, d_y)."""
    _check_model(cfg)
    n = len(params)
    for i in range(n):
        p = params[f"l{i}"]
        x = x @ p["w"] + p["b"].unsqueeze(-2)
        if i < n - 1:
            x = torch.relu(x)
    return x


def mse_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
             cfg: ForecastConfig) -> torch.Tensor:
    """Mean squared error over each client's (B, d_y) block: a scalar for
    one client, (C,) for a stack."""
    pred = apply_forecaster(params, x, cfg)
    return torch.mean(torch.square(pred - y), dim=(-2, -1))


class Forecaster(nn.Module):
    """One client's forecaster as a module, e.g. for serving the model a
    client trained.  Holds a copy of ``params`` (no gradients)."""

    def __init__(self, params: Params, cfg: ForecastConfig):
        super().__init__()
        _check_model(cfg)
        self.cfg = cfg
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({
                k: nn.Parameter(t.detach().clone(), requires_grad=False)
                for k, t in layer.items()})
            for name, layer in params.items()})

    def param_tree(self) -> Dict[str, Any]:
        return {name: dict(layer.items())
                for name, layer in self.layers.items()}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_forecaster(self.param_tree(), x, self.cfg)
