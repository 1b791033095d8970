"""A copy of the JAX package's ``data/windowing.py`` (numpy only).

Feature windowing (Section III-B): short-term "closeness" window x^c
(previous hours), periodic window x^p (same hour on previous days),
metadata one-hots, text covariates; Min-Max scaling to [0, 1]
(Section V-D preprocessing); last-7-days test split (Section V-D).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.forecast import ForecastConfig


@dataclasses.dataclass
class FeatureScaler:
    lo: np.ndarray
    hi: np.ndarray

    @classmethod
    def fit(cls, x: np.ndarray) -> "FeatureScaler":
        return cls(lo=x.min(axis=0), hi=x.max(axis=0))

    def transform(self, x: np.ndarray) -> np.ndarray:
        # constant-in-train features (e.g. a day-of-week one-hot absent
        # from a short train span) must map to 0, not blow up by 1/1e-9
        # when the value finally appears in test
        rng = self.hi - self.lo
        denom = np.where(rng < 1e-6, 1.0, rng)
        return (x - self.lo) / denom

    def inverse_y(self, y: np.ndarray, col: int = 0) -> np.ndarray:
        return y * max(self.hi[col] - self.lo[col], 1e-9) + self.lo[col]


def build_windows(data: Dict[str, np.ndarray], cfg: ForecastConfig,
                  test_days: int = 7
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray],
                             list]:
    """Returns (train, test, scalers).

    train/test: {"x": (C, N, d_x), "y": (C, N, H)}; scalers: per-client
    FeatureScaler fit on the train span of the raw traffic (so RMSE/MAE can
    be reported in raw units like Table I)."""
    traffic, text, meta = data["traffic"], data["text"], data["meta"]
    C, T = traffic.shape
    cl, pl_, H = cfg.closeness_len, cfg.period_len, cfg.horizon
    start = max(cl, pl_ * 24)
    test_start = T - test_days * 24

    xs, ys = [], []
    for c in range(C):
        rows_x, rows_y = [], []
        for t in range(start, T - H + 1):
            closeness = traffic[c, t - cl:t]
            period = traffic[c, [t - k * 24 for k in range(pl_, 0, -1)]]
            row = np.concatenate([
                closeness, period, meta[t], text[c, t - 1, :cfg.n_text]])
            rows_x.append(row)
            rows_y.append(traffic[c, t:t + H])
        xs.append(np.stack(rows_x))
        ys.append(np.stack(rows_y))
    X = np.stack(xs)            # (C, N, d_x)
    Y = np.stack(ys)            # (C, N, H)
    n_test = (T - test_start) - H + 1 if H > 1 else (T - test_start)
    n_test = min(n_test, X.shape[1] - 1)
    split = X.shape[1] - n_test

    scalers = []
    Xtr = np.empty_like(X)
    Ytr = np.empty_like(Y)
    for c in range(C):
        sc = FeatureScaler.fit(X[c, :split])
        Xtr[c] = sc.transform(X[c])
        ysc = FeatureScaler(lo=np.full(H, sc.lo[0]), hi=np.full(H, sc.hi[0]))
        Ytr[c] = ysc.transform(Y[c])
        scalers.append(sc)

    train = {"x": Xtr[:, :split].astype(np.float32),
             "y": Ytr[:, :split].astype(np.float32),
             "y_raw": Y[:, :split].astype(np.float32)}
    test = {"x": Xtr[:, split:].astype(np.float32),
            "y": Ytr[:, split:].astype(np.float32),
            "y_raw": Y[:, split:].astype(np.float32)}
    return train, test, scalers


def client_batches(rng: np.random.RandomState, train: Dict[str, np.ndarray],
                   batch: int) -> Tuple[np.ndarray, np.ndarray]:
    """One round's per-client minibatch: returns x (C, b, d_x), y (C, b, H)."""
    C, N = train["x"].shape[:2]
    idx = rng.randint(0, N, size=(C, batch))
    x = np.take_along_axis(train["x"], idx[:, :, None], axis=1)
    y = np.take_along_axis(train["y"], idx[:, :, None], axis=1)
    return x, y


def rmse_mae(pred_raw: np.ndarray, y_raw: np.ndarray) -> Tuple[float, float]:
    err = pred_raw - y_raw
    return (float(np.sqrt(np.mean(err ** 2))),
            float(np.mean(np.abs(err))))
