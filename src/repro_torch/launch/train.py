"""Federated BAFDP training over a model-zoo LM (the port of the JAX
package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --smoke --steps 3 --device cpu        # smoke-size model on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
        --steps 3 --global-batch 4             # full width, on the GPU

Without ``--device`` it runs on the GPU and raises when there is none.
``--smoke`` trains ``reduce_for_smoke(arch)`` on sequences of 64 tokens,
a global batch of 4 over 2 clients; otherwise 4 clients share the
shape's global batch, or ``--global-batch`` sequences (an addition of
the port: train_4k's 256 do not fit one card at full width).  As the
reference does, it builds the host mesh (``launch/mesh.make_host_mesh``:
1 x 1, NCCL on the GPU, gloo on the CPU) and registers it
(``distributed.context.set_mesh``); the state's placements come from
``launch/steps.train_setup``, the initial state is placed by
``distributed.sharding.place_tree`` and the rounds run on its local
shards, which on the host mesh are the state itself.  The process group
is destroyed on exit.  ``--variant NAME`` (``launch/variants.py``)
applies the variant's ``cfg_patch`` only, as the reference's launcher
does: its ``fed_patch`` and ``inner_dp`` are read only by the
reference's dry-run (``--variant inner_dp+signs8+noremat`` trains
without remat on the f32 sign wire).  ``--ckpt DIR`` resumes from the
newest checkpoint in ``DIR`` and saves the state after round ``t`` under
the label ``t`` every 50 rounds (``t > 0``) and under ``--steps`` at the
end, as the reference does: a resume from label ``t`` runs round ``t``
again (``examples/federated_lm_training.py`` labels ``t + 1`` instead).
``--dry`` (lowering) is not ported and raises.  On the GPU the caching
allocator maps expandable segments (:func:`use_expandable_segments`).
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


def launcher_fed(cfg, n_clients: int, byzantine: float = 0.0,
                 attack: str = "sign_flip"):
    """The launcher's ``FedConfig``, as the reference's:
    ``launch.steps.fed_config_for(cfg, n_clients)`` with the Byzantine
    fraction, the attack and ``alpha_w`` = 1e-2."""
    from repro_torch.configs import FedConfig
    from repro_torch.launch.steps import fed_config_for

    return fed_config_for(cfg, n_clients, FedConfig(
        byzantine_frac=byzantine, attack=attack, alpha_w=1e-2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, 64-token sequences, 2 clients")
    ap.add_argument("--dry", action="store_true",
                    help="(not ported) lower + compile only")
    ap.add_argument("--variant", default="",
                    help="a launch/variants.py name: its cfg_patch only")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="sequences a round over all clients (default: "
                         "the shape's)")
    ap.add_argument("--byzantine", type=float, default=0.0)
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory: resume from it, save to it")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: the GPU, or an error)")
    args = ap.parse_args(argv)

    if args.dry:
        raise ValueError("--dry is not yet ported (ROADMAP Queue A item 8)")

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import INPUT_SHAPES, get_arch, reduce_for_smoke
    from repro_torch.core.fed_state import init_fed_state, init_lm_tree
    from repro_torch.data.tokens import lm_batch
    from repro_torch.distributed.sharding import local_tree, place_tree
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import registered_host_mesh
    from repro_torch.tree import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        use_expandable_segments()
    cfg = get_arch(args.arch)
    shape = INPUT_SHAPES[args.shape]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
        shape = dataclasses.replace(shape, seq_len=64, global_batch=4)
    if args.global_batch:
        shape = dataclasses.replace(shape, global_batch=args.global_batch)
    if args.variant:
        from repro_torch.launch.variants import get_variant
        cfg, _, _ = get_variant(args.variant).apply(cfg)

    n_clients = 2 if args.smoke else 4
    fed = launcher_fed(cfg, n_clients, args.byzantine, args.attack)
    with registered_host_mesh(dev) as mesh:
        step_fn, _, in_specs, _ = steps_lib.train_setup(
            cfg, shape, mesh, base_fed=fed, n_clients=n_clients)
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
        state = local_tree(place_tree(state, in_specs[0], mesh))

        rng = np.random.RandomState(0)
        b = shape.global_batch // n_clients
        t0 = time.time()
        m = {}
        for t in range(start, args.steps):
            raw = lm_batch(rng, cfg, n_clients * b, shape.seq_len)
            batch = {k: torch.from_numpy(v).to(dev).reshape(
                         (n_clients, b) + v.shape[1:])
                     for k, v in raw.items()}
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
