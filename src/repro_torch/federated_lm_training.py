"""Federated BAFDP training of a ~100M-class LM on synthetic token data,
with checkpoints, resume and Byzantine clients (the port of
``examples/federated_lm_training.py``).

Client participation comes from an event-driven schedule
(``core/schedule.build_schedule``: quorum-of-S by default, ``--server
fedbuff`` for the K-arrivals buffered server) driven through
``FederatedRun`` with integer round seeds.  The state is saved after
round ``t`` under the label ``t + 1`` every 100 rounds (``t > 0``) and
under ``--steps`` at the end, the newest two kept; a run resumes from
the newest checkpoint in ``--ckpt`` and trains only the rounds after its
label (``FederatedRun`` replays the schedule before it).

    python -m repro_torch.federated_lm_training [--arch smollm-360m] \
        [--steps 300] [--scale smoke|100m] [--server quorum|fedbuff] \
        [--ckpt DIR] [--device cpu]

runs on the GPU unless ``--device cpu`` is given.  ``--ckpt`` defaults
to ``bafdp_lm_ckpt`` in the temporary directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHS, scale_cfg
from repro_torch.core.async_engine import DelayModel
from repro_torch.core.fed_state import init_fed_state, init_lm_tree
from repro_torch.core.schedule import (FedBuffTrigger, FederatedRun,
                                       QuorumTrigger, build_schedule)
from repro_torch.data.tokens import lm_batch
from repro_torch.launch import steps as steps_lib
from repro_torch.tree import resolve_device, tree_leaves

def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--scale", default="smoke", choices=["smoke", "100m"])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--byzantine", type=float, default=0.25)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "bafdp_lm_ckpt"))
    ap.add_argument("--server", default="quorum",
                    choices=["quorum", "fedbuff"])
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the GPU, or an error)")
    return ap.parse_args(argv)


def train(args: argparse.Namespace) -> Dict[str, Any]:
    """Run the example for ``args``; returns the final ``state`` and the
    ``rounds`` it trained."""
    dev = resolve_device(args.device)
    cfg = scale_cfg(args.arch, args.scale)
    fed = steps_lib.fed_config_for(cfg, args.clients)
    fed = dataclasses.replace(fed, byzantine_frac=args.byzantine,
                              attack="sign_flip", alpha_w=2e-2,
                              active_frac=0.75)
    step_fn = steps_lib.make_train_step(cfg, fed)
    state = init_fed_state(torch.Generator(device=dev).manual_seed(0),
                           lambda g: init_lm_tree(g, cfg, dev), fed,
                           device=dev)
    n_params = sum(l.numel() for l in tree_leaves(state.z))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"clients={args.clients} byz={args.byzantine}")

    ck = Checkpointer(args.ckpt, keep=2)
    start = 0
    restored, s0 = ck.restore_latest(state)
    if restored is not None:
        state, start = restored, s0
        print(f"resumed from step {start}")

    # the replay past `start` keeps the staleness bookkeeping of a resume
    dm = DelayModel(n_clients=args.clients, hetero=1.0, seed=0)
    trigger = QuorumTrigger(active_frac=fed.active_frac) \
        if args.server == "quorum" else FedBuffTrigger(buffer_k=args.clients)
    sched = build_schedule(args.steps, dm, trigger)

    rng = np.random.RandomState(1)
    t0 = time.time()
    rounds, last = [], {"m": None}

    def batch_fn(t):
        b = lm_batch(rng, cfg, args.clients * args.batch, args.seq)
        return {k: torch.from_numpy(v).to(dev).reshape(
                    (args.clients, args.batch) + v.shape[1:])
                for k, v in b.items()}

    def on_round(t, st, m):
        rounds.append(t)
        last["m"] = m
        if t % max(args.steps // 10, 1) == 0:
            print(f"  step {t:4d} loss={float(m['data_loss']):.4f} "
                  f"eps={float(m['eps_mean']):.2f} "
                  f"({(time.time() - t0) / (t - start + 1):.2f}s/step)")
        if t and t % 100 == 0:
            # label = completed-step count (st already holds step t), so a
            # resume starts at t + 1 instead of running step t again
            ck.save(st, t + 1)

    run = FederatedRun(step=step_fn, rounds=args.steps, schedule=sched,
                       start=start, key_fn=lambda t: t,
                       n_clients=args.clients)
    state, _ = run.run(state, batch_fn, on_round=on_round)
    if last["m"] is None:
        print(f"nothing to do: checkpoint already at step {start} "
              f">= --steps {args.steps}")
        return {"state": state, "rounds": rounds}
    ck.save(state, args.steps)
    print(f"done: final loss {float(last['m']['data_loss']):.4f}; "
          f"checkpoint at {args.ckpt}")
    return {"state": state, "rounds": rounds}


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
