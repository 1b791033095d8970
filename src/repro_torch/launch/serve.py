"""Serving launcher: batched generation with the decode engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        [--smoke] [--requests 4] [--max-new 16] [--window 0] \
        [--cache-len 256] [--device cpu]

``--arch``: a config of ``repro_torch.configs`` (``smollm-360m``,
``hymba-1.5b``, ``granite-moe-3b-a800m``, ``olmoe-1b-7b``,
``xlstm-1.3b``, ``seamless-m4t-medium``, ``llava-next-mistral-7b``,
...).  Full width unless ``--smoke``; on the GPU unless ``--device cpu``
(raises when there is no GPU).  The weights are random, drawn from seed
0.  An encoder-decoder decodes against the zero memory the engine starts
with, as the reference's engine does; a VLM serves its text.

Started by ``torchrun`` with ``--mesh RxM`` it serves as one rank of an R
x M ("data", "model") mesh (``launch/mesh.registered_mesh``; one process
group a process), tensor-parallel over ``"model"`` under the default
plan (``distributed/tensor_parallel.py``: every family; Hymba's Mamba
heads on a rank's channels, SeamlessM4T's encoder and cross-attention
on its heads, the MoE FFN on a rank's experts or its block of d_ff,
xLSTM's mLSTM on its v rows of each head and sLSTM on its channels of
each gate), the requests'
rows split over ``"data"``; each rank draws its blocks of the seed-0
weights (``transformer.init_lm`` with ``tensor_parallel.keep_blocks``)
and rank 0 prints::

    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --arch smollm-360m --mesh 1x2 \
        --backend gloo

(also ``--arch hymba-1.5b``, ``seamless-m4t-medium``,
``granite-moe-3b-a800m``, ``olmoe-1b-7b`` or ``xlstm-1.3b``; add
``--smoke --device cpu`` on the CPU).

``--backend``: ``gloo`` where the ranks share one card (NCCL refuses
that) or on the CPU, ``nccl`` where each rank has a card of its own
(default: nccl on the GPU, gloo on the CPU).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    ap.add_argument("--mesh", default="",
                    help="RxM: under torchrun, the ('data', 'model') mesh "
                         "of the WORLD_SIZE ranks")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="under torchrun: the process group's backend")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.launch.mesh import rank_device, registered_mesh
    from repro_torch.launch.steps import serving_specs
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import resolve_device

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    world = int(os.environ.get("WORLD_SIZE", 1))
    shape = tuple(int(n) for n in args.mesh.split("x")) if args.mesh \
        else (world, 1)
    dev = resolve_device(rank_device(args.device) if world > 1
                         else args.device)
    lead = int(os.environ.get("RANK", 0)) == 0
    with (registered_mesh(shape, dev, args.backend) if world > 1
          else contextlib.nullcontext()) as mesh:
        gen = torch.Generator(device=dev).manual_seed(0)
        ranks = None
        if mesh is not None:
            ranks = tp.serve_block(mesh, args.requests,
                                   serving_specs(cfg, mesh))
            params = tr.init_lm(gen, cfg, keep=tp.keep_blocks(ranks, dev))
        else:
            params = tr.init_lm(gen, cfg, device=dev)
        eng = ServeEngine(params, cfg, batch=args.requests,
                          cache_len=args.cache_len, window=args.window,
                          device=dev, ranks=ranks)
        outs, reqs, dt = _serve(eng, cfg, args.requests, args.max_new, dev)
    if not lead:
        return 0
    total = sum(len(o) for o in outs)
    for r, o in zip(reqs, outs):
        print(f"req {r.rid}: {len(r.prompt)} prompt -> {len(o)} new "
              f"(T={r.temperature}): {o.tolist()}")
    where = f"{dev}" + (f", mesh {shape[0]}x{shape[1]}" if world > 1 else "")
    print(f"{cfg.name} on {where}: {total} tokens / {dt:.3f} s = "
          f"{total / dt:.1f} tok/s")
    return 0


def _serve(eng, cfg, n: int, max_new: int, dev):
    """The launcher's ``n`` requests (seed 0: prompts of 3-15 tokens,
    every other one sampled at T = 0.7) through ``eng.generate``; returns
    (outputs, requests, seconds)."""
    from repro_torch.serving import ServeRequest

    rng = np.random.RandomState(0)
    reqs = [ServeRequest(
        prompt=rng.randint(0, cfg.vocab_size,
                           rng.randint(3, 16)).astype(np.int32),
        max_new=max_new, temperature=0.0 if i % 2 == 0 else 0.7,
        rid=i) for i in range(n)]
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return outs, reqs, time.perf_counter() - t0


if __name__ == "__main__":
    raise SystemExit(main())
