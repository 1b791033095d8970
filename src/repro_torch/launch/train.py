"""Federated BAFDP training over a model-zoo LM (the port of the JAX
package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 3 --device cpu        # smoke-size model on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 3                              # full width, on the GPU

Without ``--device`` it runs on the GPU and raises when there is none.
``--smoke`` trains ``reduce_for_smoke(arch)`` on sequences of 64 tokens,
a global batch of 4 over 2 clients; otherwise 4 clients share the
shape's global batch.  ``--ckpt DIR`` resumes from the newest checkpoint
in ``DIR`` and saves the state after round ``t`` under the label ``t``
every 50 rounds (``t > 0``) and under ``--steps`` at the end, as the
reference does: a resume from label ``t`` runs round ``t`` again
(``examples/federated_lm_training.py`` labels ``t + 1`` instead).
``--dry`` (lowering) and ``--variant`` are not ported and raise.  On the
GPU the caching allocator maps expandable segments
(:func:`use_expandable_segments`).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def use_expandable_segments() -> None:
    """Let the CUDA caching allocator map the segments it makes from now on
    as expandable ones, after releasing what it holds cached.  A full-width
    LM round ends holding the old and the new federated state (Hymba-1.5B
    at C=2: 78.7 GB of an H100's 85.0), where a cache cut into fixed
    segments refused a 2 GiB block with 1.46 GiB cached but split."""
    torch.cuda.empty_cache()
    setter = getattr(torch._C, "_accelerator_setAllocatorSettings", None)
    (setter or torch.cuda.memory._set_allocator_settings)(
        "expandable_segments:True")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, 64-token sequences, 2 clients")
    ap.add_argument("--dry", action="store_true",
                    help="(not ported) lower + compile only")
    ap.add_argument("--variant", default="", help="(not ported)")
    ap.add_argument("--byzantine", type=float, default=0.0)
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory: resume from it, save to it")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the GPU, or an error)")
    args = ap.parse_args(argv)

    if args.dry or args.variant:
        raise ValueError("--dry / --variant are not yet ported "
                         "(ROADMAP Queue A item 8)")

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import INPUT_SHAPES, get_arch, reduce_for_smoke
    from repro_torch.core.fed_state import init_fed_state, init_lm_tree
    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.tree import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        use_expandable_segments()
    cfg = get_arch(args.arch)
    shape = INPUT_SHAPES[args.shape]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
        shape = dataclasses.replace(shape, seq_len=64, global_batch=4)

    n_clients = 2 if args.smoke else 4
    fed = steps_lib.fed_config_for(cfg, n_clients)
    fed = dataclasses.replace(fed, byzantine_frac=args.byzantine,
                              attack=args.attack, alpha_w=1e-2)
    step_fn = steps_lib.make_train_step(cfg, fed)
    state = init_fed_state(torch.Generator(device=dev).manual_seed(0),
                           lambda g: init_lm_tree(g, cfg, dev), fed,
                           device=dev)
    ck = Checkpointer(args.ckpt) if args.ckpt else None
    start = 0
    if ck:
        restored, s0 = ck.restore_latest(state)
        if restored is not None:
            state, start = restored, s0
            print(f"resumed at step {start}")

    rng = np.random.RandomState(0)
    b = shape.global_batch // n_clients
    t0 = time.time()
    m = {}
    for t in range(start, args.steps):
        raw = lm_batch(rng, cfg, n_clients * b, shape.seq_len)
        batch = {k: torch.from_numpy(v).to(dev).reshape(
                     (n_clients, b) + v.shape[1:]) for k, v in raw.items()}
        state, m = step_fn(state, batch, t)
        if t % args.log_every == 0:
            print(f"step {t:5d}  loss={float(m['data_loss']):.4f}  "
                  f"eps={float(m['eps_mean']):.2f}  "
                  f"gap={float(m['consensus_gap']):.2e}  "
                  f"{(time.time() - t0) / (t - start + 1):.2f}s/step",
                  flush=True)
        if ck and t and t % 50 == 0:
            ck.save(state, t)
    if ck:
        ck.save(state, args.steps)
    if not m:
        print(f"done. nothing to run: resumed at step {start} >= --steps "
              f"{args.steps}")
        return 0
    print(f"done. final loss {float(m['data_loss']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
