"""Train the paper's MLP traffic forecaster with BAFDP, end to end, and
the baselines it is compared with (the port of ``benchmarks/common.py``
and ``examples/quickstart.py``).

    python -m repro_torch.train [--rounds 200] [--device cuda|cpu]
        [--server quorum|fedbuff|sync] [--round-impl dense|sparse]

runs on the GPU unless ``--device cpu`` is given, and fails when there is
no GPU.  As the quickstart, an event-driven fleet (``DelayModel``, hetero
1.0) builds a ``Schedule`` under the ``--server`` trigger, and the rounds
train on it: the dense round fed its ``act``/``stale`` rows, or with
``--round-impl sparse`` the O(S) round fed its padded rows.

:func:`run_method` trains and evaluates any method of :data:`METHODS`:
BAFDP through :func:`train_bafdp`, every baseline through
:func:`train_baseline` (``core/trainers.BaselineTrainer``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import MLP_H1, MLP_H24, FedConfig, ForecastConfig
from repro_torch.core import bafdp
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.byzantine import byz_mask
from repro_torch.core.fed_state import FedState, init_fed_state
from repro_torch.core.privacy import (gaussian_c3, perturb_inputs,
                                      privacy_accountant)
from repro_torch.core.schedule import (AdaptiveQuorum, AgeAwareSelection,
                                       FedBuffTrigger, FederatedRun,
                                       QuorumTrigger, Schedule, SyncTrigger,
                                       build_schedule)
from repro_torch.core.trainers import BaselineTrainer
from repro_torch.data import build_windows, client_batches, make_dataset
from repro_torch.data.windowing import rmse_mae
from repro_torch.models.forecasting import (Forecaster, apply_forecaster,
                                            init_forecaster, mse_loss)
from repro_torch.tree import resolve_device, tree_leaves, tree_map

ROUNDS = 150
N_CLIENTS = 8
BATCH = 32

# paper method -> (trainer method, forecaster backbone, dp sigma)
METHODS = {
    "FedGRU": ("fedavg", "gru", 0.0),
    "Fed-NTP": ("fedavg", "lstm", 0.0),
    "FedAtt": ("fedatt", "attn", 0.0),
    "FedDA": ("fedda", "attn", 0.0),
    "AFL": ("afl", "mlp", 0.0),
    "ASPIRE-EASE": ("aspire", "mlp", 0.0),
    "UDP": ("udp", "mlp", 0.01),
    "NbAFL": ("nbafl", "mlp", 0.01),
    "RSA": ("rsa", "mlp", 0.0),
    "DP-RSA": ("dp_rsa", "mlp", 0.01),
    "FedAsync": ("fedasync", "mlp", 0.0),
    "BAFDP": ("bafdp", "mlp", 0.0),
}


def forecast_cfg(model: str, horizon: int) -> ForecastConfig:
    base = MLP_H1 if horizon == 1 else MLP_H24
    return dataclasses.replace(base, model=model, name=f"{model}-h{horizon}")


@functools.lru_cache(maxsize=16)
def problem(dataset: str, horizon: int, n_clients: int = N_CLIENTS,
            seed: int = 0):
    """(train, test, scalers) of the synthetic dataset, numpy."""
    data = make_dataset(dataset, n_clients, seed=seed)
    return build_windows(data, forecast_cfg("mlp", horizon))


def _rmse_mae(predict, test, scalers, device) -> Tuple[float, float]:
    """RMSE/MAE in raw traffic units of ``predict(c, x)`` over every
    client's test windows."""
    preds, ys = [], []
    with torch.no_grad():
        for c in range(test["x"].shape[0]):
            x = torch.from_numpy(test["x"][c]).to(device, torch.float32)
            preds.append(scalers[c].inverse_y(predict(c, x).cpu().numpy()))
            ys.append(test["y_raw"][c])
    return rmse_mae(np.concatenate(preds), np.concatenate(ys))


def eval_fed_state(state: FedState, cfg: ForecastConfig, test,
                   scalers) -> Tuple[float, float]:
    """RMSE/MAE in raw traffic units, each client serving its own cell
    with its own omega_i (Algorithm 1's output)."""
    return _rmse_mae(
        lambda c, x: Forecaster(tree_map(lambda l: l[c], state.W), cfg)(x),
        test, scalers, state.eps.device)


def eval_rmse_mae(params, cfg: ForecastConfig, test,
                  scalers) -> Tuple[float, float]:
    """RMSE/MAE in raw traffic units of one model (a baseline's server
    params, BAFDP's consensus z) serving every client's cell."""
    return _rmse_mae(lambda c, x: apply_forecaster(params, x, cfg), test,
                     scalers, tree_leaves(params)[0].device)


def _rows(arr, rounds: int, n_clients: int, name: str, dtype, device):
    """A dense (rounds, C) schedule array that covers every round."""
    if arr is None:
        return None
    out = torch.as_tensor(np.asarray(arr), device=device).to(dtype)
    if out.ndim != 2 or out.shape[1] != n_clients:
        raise ValueError(
            f"{name} must be (rounds, {n_clients}), got {tuple(out.shape)}")
    if out.shape[0] < rounds:
        raise ValueError(f"{name} covers {out.shape[0]} rounds < {rounds} "
                         "trained")
    return out


def _legacy_round_kwargs(schedule, active_masks, staleness, rounds: int,
                         n_clients: int, device):
    """The dense ``active_masks=``/``staleness=`` arrays -> a per-round
    kwargs hook for :class:`FederatedRun`; ``None`` without them."""
    if active_masks is None and staleness is None:
        return None
    if schedule is not None:
        raise ValueError(
            "pass either schedule= or the deprecated active_masks=/"
            "staleness= arrays, not both")
    masks = _rows(active_masks, rounds, n_clients, "active_masks",
                  torch.bool, device)
    stale_v = _rows(staleness, rounds, n_clients, "staleness",
                    torch.float32, device)

    def round_kwargs(t):
        kw = {} if masks is None else {"act": masks[t]}
        if stale_v is not None:
            kw["stale"] = stale_v[t]
        return kw

    return round_kwargs


def train_bafdp(dataset: str, horizon: int, fed: FedConfig,
                rounds: int = ROUNDS, seed: int = 0,
                input_sigma: float = 0.02,
                schedule: Optional[Schedule] = None,
                active_masks: Optional[np.ndarray] = None,
                staleness: Optional[np.ndarray] = None,
                collect: Tuple[str, ...] = (), optimizer: str = "adam",
                feed_arrivals: Optional[bool] = None,
                round_impl: str = "dense", ledger: Optional[Any] = None,
                state: Optional[FedState] = None, device=None):
    """Returns ``(state, cfg, history)``.

    As the reference: Adam on the data/DRO gradient, ``dro_weight=0.01``,
    LDP noise ``input_sigma`` on the inputs, batches of 32 per client.

    * ``schedule``: a :class:`repro_torch.core.schedule.Schedule` (e.g.
      from ``build_schedule``) fed into every round; ``None`` uses the
      internal sampler.  ``active_masks``/``staleness``: explicit ``(rounds,
      C)`` rows fed as ``act=``/``stale=`` instead.
    * ``feed_arrivals``: feed each round's admitted-update count as
      ``arrivals=``; default on exactly when ``fed.fedbuff_lr_norm`` needs
      it and a schedule is given.
    * ``round_impl="sparse"`` trains through
      ``bafdp.bafdp_round_sparse`` fed ``Schedule.padded_rows()`` (needs a
      ``schedule=``; ``fed.consensus_scope`` is promoted to ``"active"``).
    * ``ledger``: a ``privacy.EpsLedger`` charged once per delivery; the
      history gains ``dp_eps_basic``/``dp_eps_adv`` (at ``fed.dp_delta``).
    * ``state``: a starting state (default: a fresh one from ``seed``).
      The sparse round writes into it.  ``device``: ``None`` = the GPU.
    """
    if round_impl not in ("dense", "sparse"):
        raise ValueError(f"unknown round_impl: {round_impl!r}")
    dev = resolve_device(device)
    fed = dataclasses.replace(fed, omega_optimizer=optimizer,
                              dro_weight=0.01)
    if round_impl == "sparse":
        if schedule is None:
            raise ValueError("round_impl='sparse' needs a schedule=")
        if fed.consensus_scope != "active":
            fed = dataclasses.replace(fed, consensus_scope="active")
    bafdp.check_ported(fed)
    cfg = forecast_cfg("mlp", horizon)
    train, test, scalers = problem(dataset, horizon, fed.n_clients, seed)
    c3 = gaussian_c3(cfg.d_x + cfg.d_y, fed.dp_delta, 0.05)

    def local_loss(W, batch, gen, eps):
        x, y = batch
        return mse_loss(W, perturb_inputs(gen, x, eps, input_sigma,
                                          fed.eps_min), y, cfg)

    if state is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        state = init_fed_state(gen, lambda g: init_forecaster(g, cfg, dev),
                               fed, device=dev)
    round_fn = bafdp.bafdp_round_sparse if round_impl == "sparse" \
        else bafdp.bafdp_round
    step = functools.partial(
        round_fn, local_loss=local_loss, fed=fed, c3=c3,
        n_samples=train["x"].shape[1], d_dim=cfg.d_x + cfg.d_y,
        byz_mask=byz_mask(fed.n_clients, fed.n_byzantine, device=dev))
    rng = np.random.RandomState(seed)

    def batch_fn(t):
        x, y = client_batches(rng, train, BATCH)
        return (torch.from_numpy(x).to(dev, torch.float32),
                torch.from_numpy(y).to(dev, torch.float32))

    if feed_arrivals is None:
        feed_arrivals = fed.fedbuff_lr_norm and schedule is not None
    run = FederatedRun(
        step=step, rounds=rounds, schedule=schedule,
        n_clients=fed.n_clients, feed_arrivals=feed_arrivals,
        round_impl=round_impl, ledger=ledger, ledger_delta=fed.dp_delta,
        round_kwargs=_legacy_round_kwargs(schedule, active_masks, staleness,
                                          rounds, fed.n_clients, dev),
        device=dev)
    state, hist = run.run(
        state, batch_fn, seed, collect=collect,
        derive={
            "eps_all": lambda s, m: s.eps.cpu().numpy().copy(),
            "rmse": lambda s, m: eval_fed_state(s, cfg, test, scalers)[0],
            "mae": lambda s, m: eval_fed_state(s, cfg, test, scalers)[1],
        })
    return state, cfg, hist


def train_baseline(method: str, dataset: str, horizon: int, fed: FedConfig,
                   rounds: int = ROUNDS, seed: int = 0,
                   collect: Tuple[str, ...] = (),
                   active_masks: Optional[np.ndarray] = None, device=None):
    """Train the baseline ``method`` (a :data:`METHODS` key other than
    BAFDP) on its backbone.  Returns ``(server params, cfg, (test,
    scalers), history)``.  ``active_masks`` feeds ``act=`` rows (baseline
    rounds take no ``stale=``); ``device``: ``None`` = the GPU."""
    trainer_kind, backbone, dp_sigma = METHODS[method]
    if trainer_kind == "bafdp":
        raise ValueError("train_baseline trains the baselines; use "
                         "train_bafdp for BAFDP")
    dev = resolve_device(device)
    cfg = forecast_cfg(backbone, horizon)
    data = make_dataset(dataset, fed.n_clients, seed=seed)
    train, test, scalers = build_windows(data, cfg)

    def loss(W, batch, gen):
        x, y = batch
        return mse_loss(W, x, y, cfg)

    tr = BaselineTrainer(method=trainer_kind, loss=loss, fed=fed,
                         dp_sigma=dp_sigma)
    st = tr.init(init_forecaster(torch.Generator(device=dev).manual_seed(
        seed), cfg, dev))
    rng = np.random.RandomState(seed)

    def batch_fn(t):
        x, y = client_batches(rng, train, BATCH)
        return (torch.from_numpy(x).to(dev, torch.float32),
                torch.from_numpy(y).to(dev, torch.float32))

    run = FederatedRun(
        step=tr.round, rounds=rounds, feed_staleness=False,
        n_clients=fed.n_clients,
        round_kwargs=_legacy_round_kwargs(None, active_masks, None, rounds,
                                          fed.n_clients, dev),
        device=dev)
    st, hist = run.run(st, batch_fn, seed, collect=collect,
                       skip_missing=True)
    return st["server"], cfg, (test, scalers), hist


def run_method(method: str, dataset: str, horizon: int,
               fed: Optional[FedConfig] = None, rounds: int = ROUNDS,
               seed: int = 0, device=None) -> Tuple[float, float]:
    """Train and evaluate ``method``; returns (RMSE, MAE) in raw traffic
    units: BAFDP's per-client models, a baseline's server model."""
    fed = fed or FedConfig(n_clients=N_CLIENTS)
    if METHODS[method][0] == "bafdp":
        state, cfg, _ = train_bafdp(dataset, horizon, fed, rounds, seed,
                                    device=device)
        _, test, scalers = problem(dataset, horizon, fed.n_clients, seed)
        return eval_fed_state(state, cfg, test, scalers)
    params, cfg, (test, scalers), _ = train_baseline(
        method, dataset, horizon, fed, rounds, seed, device=device)
    return eval_rmse_mae(params, cfg, test, scalers)


def make_trigger(server: str, active_frac: float):
    """The quickstart's server modes: ``quorum`` (adaptive quorum with
    age-aware selection), ``fedbuff`` (buffers of 4) or ``sync``."""
    if server == "quorum":
        return QuorumTrigger(active_frac=active_frac,
                             quorum=AdaptiveQuorum(s_min=2),
                             selection=AgeAwareSelection())
    if server == "fedbuff":
        return FedBuffTrigger(buffer_k=4)
    if server == "sync":
        return SyncTrigger()
    raise ValueError(f"unknown server {server!r}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--byzantine", type=float, default=0.2)
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--horizon", type=int, default=1, choices=[1, 24])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--server", default="quorum",
                    choices=["quorum", "fedbuff", "sync"])
    ap.add_argument("--round-impl", default="dense",
                    choices=["dense", "sparse"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    fed = FedConfig(n_clients=args.clients, byzantine_frac=args.byzantine,
                    attack=args.attack, active_frac=0.6,
                    privacy_budget_a=30.0, alpha_eps=5e-2,
                    eps_init_frac=0.05, staleness_decay="poly")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"BAFDP on {name}: {fed.n_normal} honest + {fed.n_byzantine} "
          f"byzantine ({args.attack}), S/M={fed.active_frac}, "
          f"server={args.server}, round={args.round_impl}")
    # event-driven fleet: heterogeneous latencies -> sparse schedule
    sched = build_schedule(args.rounds,
                           DelayModel(n_clients=fed.n_clients, hetero=1.0,
                                      seed=0),
                           make_trigger(args.server, fed.active_frac))
    if sched.n_rounds:
        print(f"schedule: {sched.n_rounds} rounds, mean quorum "
              f"{sched.quorum.mean():.1f}, "
              f"est. wall-clock {sched.times[-1]:.0f}s")
    gap = "consensus_gap_block" if args.round_impl == "sparse" \
        else "consensus_gap"
    t0 = time.perf_counter()
    state, cfg, hist = train_bafdp(
        "milano", args.horizon, fed, rounds=args.rounds, seed=args.seed,
        schedule=sched, round_impl=args.round_impl,
        collect=("data_loss", gap, "eps_mean"), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    every = max(args.rounds // 10, 1)
    for t in range(0, args.rounds, every):
        print(f"  round {t:4d}  loss={hist['data_loss'][t]:.4f} "
              f"eps={hist['eps_mean'][t]:.3f}  "
              f"gap={hist[gap][t]:.2e}")
    print(f"{args.rounds} rounds in {secs:.2f} s (set-up included)")

    _, test, scalers = problem("milano", args.horizon, fed.n_clients,
                               args.seed)
    rmse, mae = eval_rmse_mae(state.z, cfg, test, scalers)
    print(f"\nconsensus-model test RMSE={rmse:.3f}  MAE={mae:.3f} "
          "(raw traffic units)")
    rmse_c, mae_c = eval_fed_state(state, cfg, test, scalers)
    print(f"per-client models    RMSE={rmse_c:.3f}  MAE={mae_c:.3f}")
    basic, adv = privacy_accountant(hist["eps_mean"], fed.dp_delta)
    print(f"privacy over {args.rounds} rounds: basic eps={basic:.1f}, "
          f"advanced-composition eps={adv:.1f} at delta'={fed.dp_delta:.0e}")


if __name__ == "__main__":
    main()
