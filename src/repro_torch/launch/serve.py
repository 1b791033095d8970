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
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the GPU)")
    args = ap.parse_args()

    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest
    from repro_torch.tree import resolve_device

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    dev = resolve_device(args.device)
    params = tr.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                        device=dev)
    eng = ServeEngine(params, cfg, batch=args.requests,
                      cache_len=args.cache_len, window=args.window,
                      device=dev)
    rng = np.random.RandomState(0)
    reqs = [ServeRequest(
        prompt=rng.randint(0, cfg.vocab_size,
                           rng.randint(3, 16)).astype(np.int32),
        max_new=args.max_new, temperature=0.0 if i % 2 == 0 else 0.7,
        rid=i) for i in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    for r, o in zip(reqs, outs):
        print(f"req {r.rid}: {len(r.prompt)} prompt -> {len(o)} new "
              f"(T={r.temperature}): {o.tolist()}")
    print(f"{cfg.name} on {dev}: {total} tokens / {dt:.3f} s = "
          f"{total / dt:.1f} tok/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
