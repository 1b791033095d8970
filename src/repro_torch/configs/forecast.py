"""The paper's prediction model configs (Section V-D): the MLP predictor
trained with BAFDP on cellular traffic.  A copy of the JAX package's
``configs/forecast.py``; only ``model="mlp"`` is ported so far."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    name: str = "bafdp-mlp"
    model: str = "mlp"             # mlp | gru | lstm | attn
    closeness_len: int = 6         # short-term (hourly) window  x^c
    period_len: int = 3            # periodic (daily) window     x^p
    n_meta: int = 9                # one-hot metadata (day-of-week + holiday + text)
    n_text: int = 4                # social-pulse / news covariates
    horizon: int = 1               # H in {1, 24}
    hidden: Tuple[int, ...] = (128, 128, 64)
    rnn_hidden: int = 64
    dropout: float = 0.0

    @property
    def d_x(self) -> int:
        return self.closeness_len + self.period_len + self.n_meta + self.n_text

    @property
    def d_y(self) -> int:
        return self.horizon


MLP_H1 = ForecastConfig(name="bafdp-mlp-h1", horizon=1)
MLP_H24 = ForecastConfig(name="bafdp-mlp-h24", horizon=24)
